"""The port's single-shard build and query path equals the JAX package's.

One shard of n=2048 points, d=30, under four variants (inner layer on/off,
multiprobe 0/2), both port backends (``"torch"`` and ``"cuda"``, whose
wrappers run their plain versions on the CPU) against both JAX backends
(``"reference"`` and ``"pallas"`` in interpret mode), with the JAX family
carried across as numpy arrays. Every ``SLSHIndex`` leaf must be equal;
``comparisons``, ``bucket_total`` and ``compaction_overflow`` exact,
``knn_dist`` within rtol = atol = 1e-5 and ``knn_idx`` tie-aware
(``core.topk.topk_mismatch``: an index differs only at a real distance tie,
and is then a point at that distance).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro_torch import params as tparams
from repro_torch.core import pipeline as tp
from repro_torch.core import topk as ttopk
from repro_torch.kernels import _build
from repro_torch.kernels.query_fused import ops as tqf

RTOL = ATOL = 1e-5
N, D, NQ = 2048, 30, 40
BASE = dict(
    m_out=12, L_out=8, m_in=8, L_in=4, alpha=0.02, k=10, val_lo=0.0,
    val_hi=1.0, c_max=64, c_in=16, h_max=4, p_max=128, build_chunk=4096,
    query_chunk=16,
)
VARIANTS = {
    "inner": {},
    "inner+multiprobe": {"multiprobe": 2},
    "no_inner": {"use_inner": False},
    "no_inner+multiprobe": {"use_inner": False, "multiprobe": 2},
}


def _np(a) -> np.ndarray:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _leaves(prefix: str, obj, out: dict) -> dict:
    if hasattr(obj, "_fields"):
        for name in obj._fields:
            _leaves(f"{prefix}.{name}" if prefix else name, getattr(obj, name), out)
    else:
        out[prefix] = _np(obj)
    return out


def _inputs():
    rng = np.random.default_rng(0)
    data = rng.random((N, D), dtype=np.float32)
    queries = (data[:NQ] + 0.01 * rng.standard_normal((NQ, D))).astype(np.float32)
    return data, queries


@pytest.fixture(scope="module")
def jax_runs():
    data, queries = _inputs()
    runs = {}
    for name, kw in VARIANTS.items():
        for backend in ("reference", "pallas"):
            cfg = jp.SLSHConfig.compose(**BASE, **kw, backend=backend)
            family = jp.make_family(jax.random.PRNGKey(1), D, cfg)
            index = jp.build_from_params(jnp.asarray(data), *family, cfg)
            res = jp.query_batch(index, jnp.asarray(data), jnp.asarray(queries), cfg)
            runs[name, backend] = (family, index, res)
    # exact sign-projection equality needs projections away from zero
    s = np.einsum("nd,ldm->nlm", np.concatenate([data, queries]).astype(np.float64),
                  np.asarray(family[1].proj, np.float64))
    assert np.abs(s).min() > 1e-5
    return runs


def _port(family, kw, backend, **extra):
    data, queries = _inputs()
    cfg = tp.SLSHConfig.compose(**{**BASE, **kw, **extra}, backend=backend)
    outer, inner = tparams.from_jax_params(*family, "cpu")
    index = tp.build_from_params(torch.as_tensor(data), outer, inner, cfg)
    return cfg, index, tp.query_batch(index, torch.as_tensor(data), torch.as_tensor(queries), cfg)


def _assert_results(jres, tres):
    for name in ("comparisons", "bucket_total", "compaction_overflow"):
        np.testing.assert_array_equal(_np(getattr(tres, name)), _np(getattr(jres, name)), err_msg=name)
    data, queries = map(torch.as_tensor, _inputs())
    why = ttopk.topk_mismatch(
        tres.knn_dist, tres.knn_idx,
        torch.as_tensor(_np(jres.knn_dist)), torch.as_tensor(_np(jres.knn_idx)),
        lambda rows, idx: (data[idx.long()] - queries[rows]).abs().sum(-1),
        rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_and_query_match_jax(jax_runs, variant, backend, jax_backend):
    family, jindex, jres = jax_runs[variant, jax_backend]
    _build.reset_launches()
    _, tindex, tres = _port(family, VARIANTS[variant], backend)
    assert _build.LAUNCHES == {}  # CPU tensors: plain versions only
    jl, tl = _leaves("", jindex, {}), _leaves("", tindex, {})
    assert sorted(jl) == sorted(tl)
    for key in jl:
        np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
    _assert_results(jres, tres)
    if VARIANTS[variant].get("use_inner", True):
        assert bool(tindex.heavy.valid.any())  # the inner layer is exercised


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_chunked_build_equals_monolithic(jax_runs, backend):
    family, jindex, _ = jax_runs["inner", "reference"]
    _, mono, mres = _port(family, {}, backend, build_mode="monolithic")
    _, chunked, cres = _port(family, {}, backend, build_mode="chunked", build_chunk=512)
    jl, ml, cl = _leaves("", jindex, {}), _leaves("", mono, {}), _leaves("", chunked, {})
    for key in jl:
        np.testing.assert_array_equal(cl[key], ml[key], err_msg=key)
        np.testing.assert_array_equal(cl[key], jl[key], err_msg=key)
    for a, b in zip(mres, cres):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_query_on_a_jax_built_index(jax_runs):
    data, queries = _inputs()
    _, jindex, jres = jax_runs["inner+multiprobe", "reference"]
    cfg = tp.SLSHConfig.compose(**BASE, **VARIANTS["inner+multiprobe"], backend="cuda")
    tindex = tparams.index_from_numpy(jindex, "cpu")
    _assert_results(jres, tp.query_batch(tindex, torch.as_tensor(data), torch.as_tensor(queries), cfg))


# Shapes where the "cuda" backend once refused what the reference answers:
# k past the warp top-k's 32 (kernel D sorts the block's keys), a merge
# width past 16,384 and kernel D's shared memory over its budget (both take
# D's hash form). On CPU tensors the kernels run their plain versions; the
# route is chosen from the shape alike.
ROUTE_CASES = {
    "k40": (dict(k=40), N, "fused"),
    "merge_width_32768": (dict(L_out=8, c_max=1024, multiprobe=2), N, "hash"),  # 24,576 columns
    "c_comp0_16384_columns": (dict(L_out=8, c_max=1024, multiprobe=1, c_comp=0), 16_384, "hash"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_cuda_backend_answers_what_the_reference_answers(case):
    kw, n, route = ROUTE_CASES[case]
    rng = np.random.default_rng(3)
    data = rng.random((n, D), dtype=np.float32)
    queries = (data[:NQ] + 0.01 * rng.standard_normal((NQ, D))).astype(np.float32)
    jcfg = jp.SLSHConfig.compose(**{**BASE, **kw}, backend="reference")
    family = jp.make_family(jax.random.PRNGKey(1), D, jcfg)
    jres = jp.query_batch(jp.build_from_params(jnp.asarray(data), *family, jcfg), jnp.asarray(data),
                          jnp.asarray(queries), jcfg)
    cfg = tp.SLSHConfig.compose(**{**BASE, **kw}, backend="cuda")
    cc = tp._compact_width(cfg, cfg.L_out * cfg.slot, n)
    shape = tqf.launch_shape(NQ, cfg.L_out * cfg.slot, D, tp._fused_run(cfg), cc, k=cfg.k, aligned16=True, sms=132)
    assert shape["route"] == route
    _build.reset_launches()
    index = tp.build_from_params(torch.as_tensor(data), *tparams.from_jax_params(*family, "cpu"), cfg)
    tres = tp.query_batch(index, torch.as_tensor(data), torch.as_tensor(queries), cfg)
    assert _build.LAUNCHES == {}  # CPU tensors: plain versions only
    assert tres.knn_idx.shape == (NQ, cfg.k)
    assert int((tres.comparisons >= cfg.k).sum()) >= NQ // 2  # most queries fill all k slots
    for name in ("comparisons", "bucket_total", "compaction_overflow"):
        np.testing.assert_array_equal(_np(getattr(tres, name)), _np(getattr(jres, name)), err_msg=name)
    dt, qt = torch.as_tensor(data), torch.as_tensor(queries)
    why = ttopk.topk_mismatch(
        tres.knn_dist, tres.knn_idx, torch.as_tensor(_np(jres.knn_dist)), torch.as_tensor(_np(jres.knn_idx)),
        lambda rows, idx: (dt[idx.long()] - qt[rows]).abs().sum(-1), rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


def test_build_keeps_the_reference_preconditions():
    cfg = tp.SLSHConfig.compose(**BASE, backend="torch")
    family = tparams.from_jax_params(*jp.make_family(jax.random.PRNGKey(1), D, jp.SLSHConfig.compose(**BASE)), "cpu")
    with pytest.raises(ValueError, match="h_max"):
        tp.build_from_params(torch.zeros((3, D)), *family, cfg)
