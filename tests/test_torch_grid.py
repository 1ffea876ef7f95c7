"""The port reproduces ``examples/quickstart.py`` at reduced size.

4 synthetic ABP records x 20,000 beats (the JAX ``abp.synth_dataset_beats``
makes the beats in this process), AHE-51-5c windows, the quickstart's
family/budget configs on ``grid(nu=2, p=8)``, and the JAX family from
``PRNGKey(1)`` carried across. Per-cell comparisons, the per-processor
maximum and the overflow counters must be equal; neighbour distances
within rtol = atol = 1e-5 and indices tie-aware (``core.topk.topk_mismatch``);
predictions, DSLSH MCC and PKNN MCC equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dslsh as jdslsh
from repro.core import pipeline as jp
from repro.core import predict as jpred
from repro.data import abp
from repro.data import windows as jwin
from repro_torch import api
from repro_torch.core import predict as tpred
from repro_torch.core import topk as ttopk
from repro_torch.data import windows as twin

RTOL = ATOL = 1e-5
FAMILY = dict(m_out=24, L_out=16, m_in=12, L_in=4, alpha=0.01, val_lo=20.0, val_hi=180.0)
BUDGET = dict(k=10, c_max=128, c_in=32, h_max=8, p_max=256)


def _np(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _assert_topk(jd, ji, td, ti, pts, qx):
    jd, ji, td, ti, pts, qx = (torch.tensor(_np(a)) for a in (jd, ji, td, ti, pts, qx))
    why = ttopk.topk_mismatch(
        td, ti, jd, ji, lambda rows, idx: (pts[idx.long()] - qx[rows]).abs().sum(-1),
        rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


@pytest.fixture(scope="module")
def quickstart():
    cfg_abp = abp.ABPConfig(n_beats=20_000, episode_rate=1.0 / 2500.0)
    mapv, valid = abp.synth_dataset_beats(jax.random.PRNGKey(0), 4, cfg_abp)
    mapv, valid = np.asarray(mapv), np.asarray(valid)
    ds = jwin.build_dataset(mapv, valid, jwin.AHE_51_5C)
    train, qx, qy = jwin.train_test_split(ds, n_test=200)
    deploy = jdslsh.grid(nu=2, p=8)
    cfg = jdslsh.make_config(jdslsh.FamilyConfig(**FAMILY), jdslsh.BudgetConfig(**BUDGET))
    pts, labs, _ = jdslsh.pad_to_multiple(train["points"], train["labels"], deploy.cells)
    index = jdslsh.build(jax.random.PRNGKey(1), jnp.asarray(pts), cfg, deploy)
    res = index.query(jnp.asarray(qx))
    pred = jpred.predict_batch(jnp.asarray(labs), res.knn_idx, res.knn_dist)
    pkd, pki, pcomps = jdslsh.pknn_query(jnp.asarray(pts), jnp.asarray(qx), 10, deploy.grid)
    pred_p = jpred.predict_batch(jnp.asarray(labs), pki, pkd)
    return dict(
        mapv=mapv, valid=valid, pts=pts, labs=labs, qx=qx, qy=qy,
        family=jp.make_family(jax.random.PRNGKey(1), pts.shape[1], cfg),
        res=res, pred=pred, mcc=float(jpred.mcc(pred, jnp.asarray(qy))),
        pknn=(pkd, pki, pcomps), mcc_p=float(jpred.mcc(pred_p, jnp.asarray(qy))),
    )


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_grid_matches_jax_quickstart(quickstart, backend):
    qs = quickstart
    cfg = api.make_config(api.FamilyConfig(**FAMILY), api.BudgetConfig(**BUDGET), backend=backend)
    index = api.build(0, qs["pts"], cfg, api.grid(nu=2, p=8), device="cpu", params=qs["family"])
    res = index.query(qs["qx"])
    jres = qs["res"]
    assert res.comparisons.shape == (2, 8, 200)
    np.testing.assert_array_equal(_np(res.comparisons), _np(jres.comparisons))
    np.testing.assert_array_equal(_np(res.max_comparisons_per_cell), _np(jres.max_comparisons_per_cell))
    np.testing.assert_array_equal(_np(res.compaction_overflow), _np(jres.compaction_overflow))
    assert res.overflow_cells == jres.overflow_cells
    assert res.routed_frac == 1.0
    _assert_topk(jres.knn_dist, jres.knn_idx, res.knn_dist, res.knn_idx, qs["pts"], qs["qx"])
    labs = torch.as_tensor(qs["labs"])
    pred = tpred.predict_batch(labs, res.knn_idx, res.knn_dist)
    np.testing.assert_array_equal(_np(pred), _np(qs["pred"]))
    mcc = float(tpred.mcc(pred, torch.as_tensor(qs["qy"])))
    assert mcc == pytest.approx(qs["mcc"], abs=1e-6)
    # the Reducer honours dropped nodes and cells as the JAX grid does
    dropped = index.query(qs["qx"][:5], drop_cells=np.eye(2, 8, dtype=bool))
    assert not bool(dropped.routed[0, 0].any()) and int(dropped.comparisons[1, 1].sum()) == 0


def test_pknn_matches_jax(quickstart):
    qs = quickstart
    grid = api.Grid(nu=2, p=8)
    pkd, pki, pcomps = api.pknn_query(torch.as_tensor(qs["pts"]), torch.as_tensor(qs["qx"]), 10, grid)
    jkd, jki, jcomps = qs["pknn"]
    np.testing.assert_array_equal(_np(pcomps), _np(jcomps))
    _assert_topk(jkd, jki, pkd, pki, qs["pts"], qs["qx"])
    pred = tpred.predict_batch(torch.as_tensor(qs["labs"]), pki, pkd)
    assert float(tpred.mcc(pred, torch.as_tensor(qs["qy"]))) == pytest.approx(qs["mcc_p"], abs=1e-6)


def test_predict_layer_matches_jax():
    rng = np.random.default_rng(2)
    labels = (rng.random(50) < 0.3).astype(np.int8)
    idx = rng.integers(-1, 50, (40, 10)).astype(np.int32)
    dist = rng.random((40, 10)).astype(np.float32) * 5
    jp_ = jpred.predict_batch(jnp.asarray(labels), jnp.asarray(idx), jnp.asarray(dist))
    tp_ = tpred.predict_batch(torch.as_tensor(labels), torch.as_tensor(idx), torch.as_tensor(dist))
    np.testing.assert_array_equal(_np(tp_), _np(jp_))
    truth = (rng.random(40) < 0.5).astype(np.int32)
    assert [int(v) for v in tpred.confusion(tp_, torch.as_tensor(truth))] == [
        int(v) for v in jpred.confusion(jp_, jnp.asarray(truth))
    ]
    assert float(tpred.mcc(tp_, torch.as_tensor(truth))) == pytest.approx(
        float(jpred.mcc(jp_, jnp.asarray(truth))), abs=1e-6
    )


def test_windows_copy_matches_jax_package(quickstart):
    mapv, valid = quickstart["mapv"][0], quickstart["valid"][0]
    for a, b in zip(
        jwin.windows_from_record(mapv, valid, jwin.AHE_51_5C),
        twin.windows_from_record(mapv, valid, twin.AHE_51_5C),
    ):
        np.testing.assert_array_equal(a, b)
    spec_j, spec_t = jwin.SyntheticWindowSpec(n=10_000, seed=3), twin.SyntheticWindowSpec(n=10_000, seed=3)
    for a, b in zip(jwin.synth_window_slice(spec_j, 4000, 9000), twin.synth_window_slice(spec_t, 4000, 9000)):
        np.testing.assert_array_equal(a, b)
