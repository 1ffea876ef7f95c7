"""The port's persistence against the JAX package's.

``checkpoint/store.py`` writes the JAX package's format: the same leaf
names (JAX tree paths), manifest dtypes and atomic ``step_<k>`` rename, so
each package's store reads what the other's wrote, bf16 leaves included.
``dslsh.load`` / ``Index.save`` cross over in both directions: an index
saved by ``repro.api.Index.save`` (single, routed replicated grid,
streaming before and after ``compact``) loads into the port and answers as
the JAX index does (counters exactly, top-k tie-aware), and an index the
port saves loads through ``repro.api.load`` and answers as the port's
does. The two packages' manifests list the same leaves with the same
dtypes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.checkpoint import store as jstore
from repro.core import pipeline as jp
from repro_torch import api, params
from repro_torch.checkpoint import store
from repro_torch.core import pipeline as tp
from repro_torch.core import topk as ttopk

CPU = torch.device("cpu")
RTOL = ATOL = 1e-5


class _Pair(NamedTuple):
    keys: object
    mask: object


def _tree():
    """int64-held uint32 keys, bool, int32, float and bf16 leaves."""
    rng = np.random.default_rng(0)
    keys = torch.as_tensor(rng.integers(0, 2**32, (3, 5), dtype=np.int64))
    keys[0, 0] = 0xFFFFFFFF  # PAD_KEY survives the round trip
    return {
        "b": _Pair(params.u32(keys), torch.as_tensor(rng.random(7) < 0.5)),
        "a": {"n": np.int32(7), "w": torch.linspace(-3, 3, 11).to(torch.bfloat16),
              "x": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
        "list": [torch.ones(2), np.float32(0.5)],
    }, keys


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "step_00000000", "manifest.json")) as f:
        return json.load(f)


def test_store_round_trips_and_names_as_jax(tmp_path):
    tree, keys = _tree()
    path = store.save(tree, 3, str(tmp_path))
    assert path.endswith("step_00000003") and store.latest_step(str(tmp_path)) == 3
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["leaves"] == store.leaf_names(tree) == [
        "a_n", "a_w", "a_x", "b_.keys", "b_.mask", "list_0", "list_1"]
    assert man["dtypes"] == {"a_n": "int32", "a_w": "bfloat16", "a_x": "int32", "b_.keys": "uint32",
                             "b_.mask": "bool", "list_0": "float32", "list_1": "float32"}
    # the JAX package names the same structure's leaves the same way
    jtree = jax.tree.map(lambda a: a if isinstance(a, np.generic) else np.zeros(1), tree,
                         is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert [n for n, _ in jstore._leaf_paths(jtree)] == man["leaves"]

    host = store.restore(tree, 3, str(tmp_path))  # numpy leaves, bf16 as a CPU tensor
    assert host["b"].keys.dtype == np.uint32 and torch.equal(torch.as_tensor(host["b"].keys.astype(np.int64)), keys)
    assert isinstance(host["a"]["w"], torch.Tensor) and torch.equal(host["a"]["w"], tree["a"]["w"])
    on = store.restore(tree, 3, str(tmp_path), device="cpu")  # tensors, uint32 widened to int64
    assert on["b"].keys.dtype == torch.int64 and torch.equal(on["b"].keys, keys)
    assert torch.equal(on["b"].mask, tree["b"].mask) and on["a"]["x"].dtype == torch.int32
    assert torch.equal(on["a"]["x"], tree["a"]["x"]) and int(on["a"]["n"]) == 7
    assert on["a"]["w"].dtype == torch.bfloat16 and torch.equal(on["a"]["w"], tree["a"]["w"])
    assert isinstance(on["b"], _Pair) and float(on["list"][1]) == 0.5
    # the JAX package's store reads the port's bf16 leaf (through ml_dtypes)
    jback = jstore.restore(jtree, 3, str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jback["a"]["w"], np.float32), tree["a"]["w"].float().numpy())
    # and the port reads what the JAX package's store wrote
    jstore.save({"w": jnp.ones((4,), jnp.bfloat16), "k": jnp.arange(3, dtype=jnp.uint32)}, 5, str(tmp_path))
    back, step = store.restore_latest({"w": 0, "k": 0}, str(tmp_path), device="cpu")
    assert step == 5 and back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].float(), torch.ones(4))
    assert back["k"].tolist() == [0, 1, 2] and back["k"].dtype == torch.int64


def test_store_async_save_keeps_the_values_of_its_call(tmp_path, monkeypatch):
    """A save without blocking writes the tree as it was when ``save`` was
    called, though the caller updates the CPU tensors in place (as the train
    step does) before the writer thread runs."""
    import threading

    tree = {"params": {"w": torch.arange(6, dtype=torch.float32), "h": torch.ones(3, dtype=torch.bfloat16)},
            "step": torch.tensor(4, dtype=torch.int32), "host": np.arange(3, dtype=np.int64)}
    want = {"w": tree["params"]["w"].clone(), "h": tree["params"]["h"].clone(), "host": tree["host"].copy()}
    updated = threading.Event()
    real = np.save

    def after_the_update(path, arr):
        updated.wait(timeout=30)
        real(path, arr)

    monkeypatch.setattr(np, "save", after_the_update)
    _, t = store.save(tree, 1, str(tmp_path), blocking=False)
    with torch.no_grad():
        tree["params"]["w"].add_(100.0)
        tree["params"]["h"].mul_(3.0)
        tree["step"].add_(1)
    tree["host"] += 7
    updated.set()
    t.join(timeout=30)
    monkeypatch.setattr(np, "save", real)
    back, step = store.restore_latest(tree, str(tmp_path), device="cpu")
    assert step == 1 and int(back["step"]) == 4
    assert torch.equal(back["params"]["w"], want["w"]) and torch.equal(back["params"]["h"], want["h"])
    np.testing.assert_array_equal(back["host"].numpy(), want["host"])


def test_store_async_save_and_crash_mid_write(tmp_path, monkeypatch):
    tree, _ = _tree()
    _, t = store.save(tree, 1, str(tmp_path), blocking=False)
    t.join(timeout=30)
    assert store.latest_step(str(tmp_path)) == 1
    calls = []
    real = np.save

    def crash(path, arr):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk gone")
        real(path, arr)

    monkeypatch.setattr(np, "save", crash)
    with pytest.raises(OSError):
        store.save(tree, 2, str(tmp_path))
    monkeypatch.setattr(np, "save", real)
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert store.latest_step(str(tmp_path)) == 1  # the torn step never became visible
    back, step = store.restore_latest(tree, str(tmp_path), device="cpu")
    assert step == 1 and torch.equal(back["a"]["x"], tree["a"]["x"])
    assert store.restore_latest(tree, str(tmp_path / "none")) == (None, None)


# ---------------------------------------------------------------- cross loads


def _base(**kw) -> dict:
    base = dict(m_out=12, L_out=8, m_in=6, L_in=4, alpha=0.02, k=5, val_lo=0.0, val_hi=1.0,
                c_max=32, c_in=8, h_max=4, p_max=64, build_chunk=128, query_chunk=8)
    base.update(kw)
    return base


def _clustered(n=256, d=8, seed=1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, (n // 16, 1, d))
    return (centers + 0.01 * rng.standard_normal((n // 16, 16, d))).reshape(-1, d).astype(np.float32)


DEPLOYS = {
    "single": (dict(), lambda m: m.single()),
    "grid_r2": (dict(), lambda m: m.grid(nu=2, p=2, replication=2)),
    "stream": (dict(use_inner=False),
               lambda m: m.streaming(nu=2, p=2, node_capacity=160, delta_cap=32)),
}


def _assert_same(res_t, res_j, rows, q):
    for f in ("comparisons", "compaction_overflow", "routed"):
        np.testing.assert_array_equal(res_t.__getattribute__(f).numpy(), np.asarray(getattr(res_j, f)), err_msg=f)
    pts, qt = torch.as_tensor(rows), torch.as_tensor(q)
    why = ttopk.topk_mismatch(
        res_t.knn_dist, res_t.knn_idx, torch.as_tensor(np.array(res_j.knn_dist)),
        torch.as_tensor(np.array(res_j.knn_idx)),
        lambda r, idx: (pts[idx.long()] - qt[r]).abs().sum(-1), rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


def _rows(index) -> np.ndarray:
    """The points a global neighbour index names (streaming: the stores)."""
    if index.deploy.kind == "streaming":
        return np.concatenate([np.array(nd.store) for nd in index.pipeline_index])
    return np.array(index._state["data"])


def _jax_index(kind: str):
    """The JAX index for ``kind``; streaming has ingested one batch."""
    kw, deploy = DEPLOYS[kind]
    data = _clustered()
    cfg = jp.SLSHConfig.compose(**_base(**kw), backend="reference")
    index = japi.build(jax.random.PRNGKey(1), data, cfg, deploy(japi))
    if kind == "stream":
        index.ingest(_clustered(n=32, seed=7), ts=1.0)
    return index


@pytest.mark.parametrize("kind,compact", [("single", False), ("grid_r2", False), ("stream", False),
                                          ("stream", True)])
def test_jax_saved_index_loads_and_answers_in_the_port(kind, compact, tmp_path):
    jidx = _jax_index(kind)
    if compact:
        jidx.compact(2.0)
    q = _clustered(n=32, seed=8)[:12]
    jidx.save(str(tmp_path / "jax"))
    tidx = api.load(str(tmp_path / "jax"), device="cpu")
    assert tidx.device == CPU and tidx.cfg.backend == "torch" and tidx.deploy.kind == jidx.deploy.kind
    assert dataclasses.asdict(tidx.deploy) == {k: v for k, v in dataclasses.asdict(jidx.deploy).items()
                                               if k not in ("reducer", "mesh")}
    _assert_same(tidx.query(q), jidx.query(q), _rows(jidx), q)
    if kind == "grid_r2":
        assert tidx.plan.r_max == 2 and tidx.plan.n_devices == jidx.plan.n_devices
    if kind == "stream":
        assert tidx.n_index() == jidx.n_index()
        r_t, r_j = tidx.ingest(_clustered(n=32, seed=9), ts=3.0), jidx.ingest(_clustered(n=32, seed=9), ts=3.0)
        assert (r_t.node, r_t.inserted, r_t.compacted) == (r_j.node, r_j.inserted, r_j.compacted)
        _assert_same(tidx.query(q), jidx.query(q), _rows(jidx), q)
    # saved again by the port: the same leaves, dtypes and shapes
    tidx.save(str(tmp_path / "port"))
    mj, mt = _manifest(str(tmp_path / "jax")), _manifest(str(tmp_path / "port"))
    if kind != "stream":
        assert mt == mj
    else:  # the port re-saved after one more ingest: same layout
        assert (mt["leaves"], mt["dtypes"]) == (mj["leaves"], mj["dtypes"])


@pytest.mark.parametrize("kind", ["single", "grid_r2", "stream"])
def test_port_saved_index_loads_and_answers_in_jax(kind, tmp_path):
    kw, deploy = DEPLOYS[kind]
    data = _clustered()
    jcfg = jp.SLSHConfig.compose(**_base(**kw), backend="reference")
    family = params.from_jax_params(*jp.make_family(jax.random.PRNGKey(1), data.shape[1], jcfg), CPU)
    cfg = tp.SLSHConfig.compose(**_base(**kw), backend="torch")
    tidx = api.build(1, data, cfg, deploy(api), device="cpu", params=family)
    if kind == "stream":
        tidx.ingest(_clustered(n=32, seed=7), ts=1.0)
    q = _clustered(n=32, seed=8)[:12]
    tidx.save(str(tmp_path / "port"))
    jidx = japi.load(str(tmp_path / "port"))
    assert jidx.cfg.backend == "reference" and jidx.deploy.kind == tidx.deploy.kind
    _assert_same(tidx.query(q), jidx.query(q), _rows(tidx), q)
    back = api.load(str(tmp_path / "port"), device="cpu")  # and the port's own round trip is bit-exact
    a, b = tidx.query(q), back.query(q)
    for f in ("knn_dist", "knn_idx", "comparisons", "compaction_overflow", "routed"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    if kind == "grid_r2":
        np.testing.assert_array_equal(jidx.plan.replicas, tidx.plan.replicas)
    if kind == "stream":
        assert back._state["core"].rr == tidx._state["core"].rr == jidx._state["core"].rr == 1


def test_backend_names_cross_over(tmp_path):
    """The port's "cuda" backend saves as the JAX package's "pallas" (its
    hand-written kernels) and "torch" as "reference" (its plain path); a
    load without a device wants the card."""
    data = _clustered(n=64)
    idx = api.build(0, data, api.make_config(**_base()), api.single(), device="cpu")
    assert idx.cfg.backend == "cuda"
    idx.save(str(tmp_path))
    with open(tmp_path / "dslsh.json") as f:
        meta = json.load(f)
    assert meta["cfg"]["backend"] == "pallas" and meta["cfg"]["interpret"] is None
    assert meta["deploy"]["reducer"] == "allgather"
    assert api.load(str(tmp_path), device="cpu").cfg.backend == "cuda"
    if not torch.cuda.is_available():  # load runs on the card unless told otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.load(str(tmp_path))
