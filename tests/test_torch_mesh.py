"""The port's mesh deployment against the JAX package.

One rank per mesh cell over ``torch.distributed`` (gloo, on the CPU): a
one-rank ``make_local_mesh(1, 1)`` in this process against JAX's mesh on
``make_local_mesh(1, 1)`` (the ``dslsh_build`` and ``mesh_query`` that
``dslsh.mesh`` runs, under ``jax.jit``, as the handle's eager shard_map
takes about 30 s here), and spawned worlds of 4-8 ranks
(``launch.mesh.spawn`` running ``launch.mesh_job.run``, one world per mesh
shape with its cases batched inside, started while this process computes
the JAX side) against JAX's simulated grid handle, which JAX's own
multi-device tests pin equal to its mesh (``test_distributed.py``,
``test_routing.py``). Inputs come from numpy seeds; the JAX family crosses
through an ``.npz`` into ``dslsh.build(params=...)``. Integers must be
equal, ``knn_dist`` within rtol = 1e-6 and ``knn_idx`` tie-aware
(``core.topk.topk_mismatch``); the tree and all-gather Reducers must agree
bit for bit, and every rank must hold the same family and answer.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import distributed as jD
from repro.core import pipeline as jp
from repro.core import routing as jr
from repro.launch import mesh as jmesh
from repro_torch import api
from repro_torch.checkpoint import store as tstore
from repro_torch.core import distributed as tD
from repro_torch.core import topk as ttopk
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import mesh_job
from repro_torch.runtime import ft as tft
from repro_torch.sharding import ctx

RTOL, ATOL = 1e-6, 0.0
FIELDS = ("knn_dist", "knn_idx", "comparisons", "compaction_overflow", "routed")


def _base(**kw) -> dict:
    # tests/test_distributed.py:140-146 and tests/test_routing.py:322-324
    base = dict(
        m_out=10, L_out=8, m_in=6, L_in=4, alpha=0.02, k=5, val_lo=0.0,
        val_hi=1.0, c_max=32, c_in=8, h_max=4, p_max=64, build_chunk=128,
        query_chunk=8,
    )
    base.update(kw)
    return base


def _jcfg(cfg_kw: dict):
    """The JAX config of ``cfg_kw`` on its plain backend (the port's runs
    its kernels' plain versions on the CPU)."""
    return jp.SLSHConfig.compose(**cfg_kw, backend="reference")


def _uniform(n: int, d: int = 12, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).random((n, d), dtype=np.float32)


def _clustered(n: int, d: int = 12, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, (n // 16, 1, d))
    return (centers + 0.01 * rng.standard_normal((n // 16, 16, d))).reshape(-1, d).astype(np.float32)


def _np(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _assert_answer(got: dict, ref, data: np.ndarray, queries: np.ndarray) -> None:
    """``got`` (the port's fields as numpy) against a JAX result."""
    ref = {f: _np(getattr(ref, f)) for f in FIELDS}
    for f in ("comparisons", "compaction_overflow", "routed"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_allclose(got["knn_dist"], ref["knn_dist"], rtol=RTOL, atol=ATOL)
    pts, qx = torch.as_tensor(data), torch.as_tensor(queries)
    why = ttopk.topk_mismatch(
        torch.as_tensor(got["knn_dist"]), torch.as_tensor(got["knn_idx"]),
        torch.as_tensor(ref["knn_dist"]), torch.as_tensor(ref["knn_idx"]),
        lambda rows, idx: (pts[idx.long()] - qx[rows]).abs().sum(-1), rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


def _fields(res) -> dict:
    return {f: _np(getattr(res, f)) for f in FIELDS}


def _equal(a: dict, b: dict) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _family_npz(path, key, d: int, cfg) -> None:
    """Write the JAX family for ``key`` where a rank reads it."""
    outer, inner = jp.make_family(key, d, cfg)
    np.savez(path, outer_dims=np.asarray(outer.dims), outer_thrs=np.asarray(outer.thrs),
             outer_salts=np.asarray(outer.salts), inner_proj=np.asarray(inner.proj),
             inner_salts=np.asarray(inner.salts))


def _down(nu: int) -> np.ndarray:
    """The straggler mask a heartbeat monitor gives when the last of ``nu``
    nodes misses its deadline (``runtime/ft.py`` feeding ``drop_mask``)."""
    monitor = tft.HeartbeatMonitor(n_nodes=nu, deadline_s=1.0, start=0.0)
    for node in range(nu - 1):
        monitor.beat(node, t=5.0)
    return monitor.drop_mask(now=5.5)


_ROUTED_STEPS = [
    ("query", {"reducer": "tree"}), ("query", {}),
    ("query", {"reducer": "tree", "max_cells": 2}), ("query", {"max_cells": 2}),
    ("query", {"drop_mask": "down"}),
]
# one world per mesh shape: (shape, config, data, queries, key, routed, steps)
WORLDS = {
    # tests/test_distributed.py:132-160's mesh, n = 512, d = 12
    "2x4": ((2, 4), _base(), _uniform(512), 10, 0, False, [
        ("query", {}), ("query", {"reducer": "tree"}),
        ("query", {"drop_mask": "down"}), ("query", {"reducer": "tree", "drop_mask": "down"}),
    ]),
    # tests/test_routing.py:315-339's meshes, n = 528: 8 cells, a
    # non-power-of-two 6-cell tree, rep = 2 over 2 x 2
    "4x2": ((4, 2), _base(), _clustered(528), 10, 0, True, _ROUTED_STEPS),
    "2x3": ((2, 3), _base(L_out=6), _clustered(528), 9, 0, True, _ROUTED_STEPS),
    "2x2x2": ((2, 2, 2), _base(), _clustered(528), 8, 0, True, _ROUTED_STEPS),
    # the 2 x 2 x 2 world's cells without the rep axis, saved and loaded
    "2x2": ((2, 2), _base(), _clustered(528), 8, 0, True, [
        ("query", {"reducer": "tree"}), ("save", "mesh_ck"), ("load", "mesh_ck"),
        ("query", {"reducer": "tree"}), ("query", {}), ("query", {"max_cells": 2}),
    ]),
}


def _case(name: str):
    """(shape, config, data, queries, JAX key, routed, steps, down) of a world."""
    shape, cfg_kw, data, nq, seed, routed, steps = WORLDS[name]
    q = data[:nq] + np.float32(0.005) if routed else data[:nq]
    return shape, cfg_kw, data, q, jax.random.PRNGKey(seed), routed, steps, _down(shape[-2])


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """Every spawned world, started one after another in the background
    from the module's first test on, while the tests compute the JAX side
    -> name -> (future of the rank reports, the world's directory)."""
    pool = ThreadPoolExecutor(1)
    out = {}
    for name in WORLDS:
        shape, cfg_kw, data, q, key, routed, steps, down = _case(name)
        d = tmp_path_factory.mktemp(f"world_{name}")
        np.save(d / "data.npy", data)
        np.save(d / "queries.npy", q)
        _family_npz(d / "family.npz", key, data.shape[1], _jcfg(cfg_kw))
        steps = tuple(
            (op, str(d / arg)) if op in ("save", "load")
            else (op, {**arg, "drop_mask": down.tolist()} if arg.get("drop_mask") == "down" else arg)
            for op, arg in steps
        )
        job = mesh_job.MeshJob(
            mesh=shape, data=str(d / "data.npy"), queries=str(d / "queries.npy"), cfg=cfg_kw,
            params=str(d / "family.npz"), routed=routed, steps=steps, device="cpu",
        )
        out[name] = (pool.submit(tmesh.spawn, mesh_job.run, int(np.prod(shape)), store_dir=str(d / "store"),
                                 args=(job,), timeout_s=120), d)
    yield out
    pool.shutdown(wait=True)


def _reports(future) -> list[dict]:
    """The world's rank reports, once every rank is done; checks that every
    rank holds the same family and answers alike."""
    reports = future.result(timeout=300)
    assert [r["rank"] for r in reports] == list(range(len(reports)))
    assert len({r["family_digest"] for r in reports}) == 1
    for i, step in enumerate(reports[0]["steps"]):
        if step["op"] == "query":
            assert len({r["steps"][i]["digest"] for r in reports}) == 1
    return reports


def _answers(reports) -> list[dict]:
    return [s["answer"] for s in reports[0]["steps"] if s["op"] == "query"]


# ------------------------------------------------------- one rank, in-process


@pytest.fixture(scope="module")
def jax_mesh11():
    """JAX's routed mesh on ``make_local_mesh(1, 1)``: its handle's state,
    and its all-gather answer (routed answers equal broadcast ones)."""
    cfg_kw = _base()
    data = _uniform(256, d=8, seed=0)
    q = data[:5]
    jcfg, key, grid = _jcfg(cfg_kw), jax.random.PRNGKey(1), jD.Grid(nu=1, p=1)
    mesh = jmesh.make_local_mesh(1, 1)
    jdata = jnp.asarray(data)
    index = jax.jit(lambda d: jD.dslsh_build(mesh, key, d, jcfg, grid))(jdata)
    plan = jr.make_plan(index, jcfg, grid, replication=1)

    answer = jax.jit(lambda i, d, x: jD.mesh_query(mesh, i, d, x, jcfg, grid, plan=plan))(index, jdata, jnp.asarray(q))
    handle = japi.Index(japi.mesh(mesh, routed=True), jcfg, {"index": index, "data": jdata, "plan": plan})
    return dict(cfg_kw=cfg_kw, data=data, q=q, params=jp.make_family(key, 8, jcfg), mesh=mesh, handle=handle,
                allgather=answer)


def test_one_rank_mesh_matches_jax_mesh(jax_mesh11):
    j = jax_mesh11
    mesh = tmesh.make_local_mesh(1, 1, device="cpu")
    assert mesh.backend is None and mesh.shape == {"data": 1, "model": 1}
    index = api.build(0, j["data"], api.make_config(**j["cfg_kw"]), api.mesh(mesh, routed=True), params=j["params"])
    res = _fields(index.query(j["q"]))
    _assert_answer(res, j["allgather"], j["data"], j["q"])
    tree = api.build(0, j["data"], api.make_config(**j["cfg_kw"]), api.mesh(mesh, routed=True, reducer="tree"),
                     params=j["params"])
    _equal(_fields(tree.query(j["q"])), res)
    unrouted = api.build(0, j["data"], api.make_config(**j["cfg_kw"]), api.mesh(mesh), params=j["params"])
    for f in FIELDS[:4]:
        np.testing.assert_array_equal(_fields(unrouted.query(j["q"]))[f], res[f], err_msg=f)
    assert index.n_index() == 256 and index.device == torch.device("cpu")


def test_dslsh_query_warns_and_matches_mesh_query():
    cfg_kw = _base()
    data = _uniform(256, d=8, seed=0)
    mesh = tmesh.make_local_mesh(1, 1, device="cpu")
    index = api.build(1, data, api.make_config(**cfg_kw), api.mesh(mesh))
    res = index.query(data[:4])
    with pytest.warns(DeprecationWarning, match="dslsh_query is deprecated"):
        legacy = tD.dslsh_query(
            mesh, index.pipeline_index, index._state["data"], torch.as_tensor(data[:4]),
            index.cfg, index.grid,
        )
    for a, f in zip(legacy, FIELDS[:4]):
        assert torch.equal(a, getattr(res, f))


def test_mesh_deployment_validation():
    with pytest.raises(api.ConfigError, match="device mesh"):
        api.Deployment(kind="mesh")
    with pytest.raises(api.ConfigError, match="unknown reducer"):
        api.mesh(tmesh.make_local_mesh(1, 1, device="cpu"), reducer="ring")
    # the rep axis replicates without routed=True, as in JAX
    mesh = ctx.Mesh(("rep", "data", "model"), (2, 1, 1), (0, 0, 0), torch.device("cpu"))
    dep = api.mesh(mesh)
    assert (dep.replication, dep.routed, dep.nu, dep.p) == (2, False, 1, 1)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_local_mesh(2, 2, device="cpu")
    cfg = api.make_config(**_base())
    data = _uniform(64, d=8)
    index = api.build(0, data, cfg, api.mesh(tmesh.make_local_mesh(1, 1, device="cpu")))
    with pytest.raises(api.ConfigError, match="with_routing derives a plan from a grid"):
        index.with_routing()
    with pytest.raises(api.ConfigError, match="drop_cells"):
        index.query(data[:2], drop_cells=np.zeros((1, 1), bool))
    with pytest.raises(api.ConfigError, match="max_cells requires a routed"):
        index.query(data[:2], max_cells=1)


def test_mesh_refuses_backends_other_than_gloo(tmp_path, monkeypatch):
    # NCCL waits for a machine with a card per rank; nothing falls back to gloo
    with pytest.raises(NotImplementedError, match="only 'gloo'"):
        tmesh.spawn(mesh_job.run, 2, store_dir=str(tmp_path / "w"), backend="nccl")
    assert not (tmp_path / "w").exists()  # refused before any rank started
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert tmesh.make_local_mesh(1, 1, device="cpu").backend == "gloo"
        monkeypatch.setattr(ctx.dist, "get_backend", lambda *a: "nccl")  # as under torchrun --backend nccl
        with pytest.raises(NotImplementedError, match="only 'gloo'"):
            tmesh.make_local_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_cross_loads_with_jax(jax_mesh11, tmp_path):
    j = jax_mesh11
    tmesh11 = tmesh.make_local_mesh(1, 1, device="cpu")
    # JAX-saved mesh -> the port
    j["handle"].save(str(tmp_path / "j"))
    loaded = api.load(str(tmp_path / "j"), device_mesh=tmesh11)
    assert loaded.deploy.kind == "mesh" and loaded.plan is not None
    _assert_answer(_fields(loaded.query(j["q"])), j["allgather"], j["data"], j["q"])
    # port-saved mesh -> JAX: the state it restores is JAX's own build
    index = api.build(0, j["data"], api.make_config(**j["cfg_kw"]), api.mesh(tmesh11, routed=True),
                      params=j["params"])
    index.save(str(tmp_path / "t"))
    back = japi.load(str(tmp_path / "t"), device_mesh=j["mesh"])
    assert back.deploy.kind == "mesh" and back.deploy.routed and back.plan is not None
    for a, b in zip(jax.tree.leaves(back._state), jax.tree.leaves(j["handle"]._state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------- spawned worlds


def test_mesh_2x4_both_reducers_and_drop_mask_match_jax(worlds):
    shape, cfg_kw, data, q, key, _, _, down = _case("2x4")
    assert down.tolist() == [False, True]  # node 1 missed its deadline
    jindex = japi.build(key, jnp.asarray(data), _jcfg(cfg_kw), japi.grid(nu=2, p=4))
    ref, ref_drop = jindex.query(jnp.asarray(q)), jindex.query(jnp.asarray(q), drop_mask=down)
    reports = _reports(worlds["2x4"][0])
    ag, tree, ag_drop, tree_drop = _answers(reports)
    _assert_answer(ag, ref, data, q)
    _equal(tree, ag)
    _assert_answer(ag_drop, ref_drop, data, q)
    _equal(tree_drop, ag_drop)
    assert (ag_drop["knn_idx"] < 256).all()  # node 1's points left the answer
    steps = reports[0]["steps"]
    assert steps[0]["reducer"]["batches"] == 1 and steps[0]["reducer"]["sent_bytes"] > 0
    assert steps[0]["reducer"]["host_copy_bytes"] == 0  # the CPU's tensors are the host's


@pytest.fixture(scope="module")
def jax_routed_2x2():
    """JAX's routed grid(2, 2) on the 2 x 2 x 2 and 2 x 2 worlds' data."""
    _, cfg_kw, data, _, key, _, _, _ = _case("2x2")
    return japi.build(key, jnp.asarray(data), _jcfg(cfg_kw), japi.grid(nu=2, p=2, routed=True))


@pytest.mark.parametrize("name", ["4x2", "2x3", "2x2x2"])
def test_routed_mesh_matches_jax(worlds, jax_routed_2x2, name):
    """Routed answers equal JAX's routed grid, with max_cells and drop_mask too."""
    shape, cfg_kw, data, q, key, _, _, down = _case(name)
    jindex = jax_routed_2x2 if shape[-2:] == (2, 2) else japi.build(
        key, jnp.asarray(data), _jcfg(cfg_kw), japi.grid(nu=shape[-2], p=shape[-1], routed=True))
    jq = jnp.asarray(q)
    ref, capped, dropped = jindex.query(jq), jindex.query(jq, max_cells=2), jindex.query(jq, drop_mask=down)
    tree, ag, tree_cap, ag_cap, ag_drop = _answers(_reports(worlds[name][0]))
    _assert_answer(tree, ref, data, q)
    _equal(ag, tree)
    _assert_answer(tree_cap, capped, data, q)
    _equal(ag_cap, tree_cap)
    assert tree_cap["routed"].sum(axis=(0, 1)).max() <= 2
    _assert_answer(ag_drop, dropped, data, q)


def test_mesh_save_is_the_jax_grid_format_and_loads(worlds, jax_routed_2x2, tmp_path):
    """A routed 2 x 2 mesh saves the JAX routed grid checkpoint of the same
    index (leaf names, dtypes, shapes and values), differing only in
    "kind"; loaded back onto the world it answers as before (routed, and
    with max_cells), and as the 2 x 2 x 2 world, whose rows the rep axis
    splits."""
    jck = tmp_path / "grid_ck"
    jax_routed_2x2.save(str(jck))
    future, d = worlds["2x2"]
    before, after, after_ag, after_cap = _answers(_reports(future))
    _equal(after, before)
    _equal(after_ag, before)
    rep_tree, _, rep_cap, _, _ = _answers(_reports(worlds["2x2x2"][0]))
    _equal(before, rep_tree)
    _equal(after_cap, rep_cap)
    ck = d / "mesh_ck"
    meta_m, meta_g = (json.loads((c / "dslsh.json").read_text()) for c in (ck, jck))
    assert meta_m["deploy"]["kind"] == "mesh"
    meta_m["deploy"]["kind"] = "grid"
    assert meta_m["deploy"] == meta_g["deploy"]
    man_m, man_g = (json.loads((c / "step_00000000" / "manifest.json").read_text()) for c in (ck, jck))
    assert man_m["leaves"] == man_g["leaves"] and man_m["dtypes"] == man_g["dtypes"]
    assert any(n.startswith("state_plan") for n in man_g["leaves"])
    for name in man_g["leaves"]:
        a, b = (np.load(c / "step_00000000" / f"{name}.npy") for c in (ck, jck))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------------- persistence


def test_restore_shardings_keeps_each_ranks_block(tmp_path):
    tree = {"cells": np.arange(2 * 3 * 4, dtype=np.uint32).reshape(2, 3, 4),
            "rows": np.arange(6 * 5, dtype=np.float32).reshape(6, 5),
            "flat": np.arange(12, dtype=np.int32).reshape(6, 2), "whole": np.float32(7.5)}
    tstore.save(tree, 3, str(tmp_path))
    skel = {k: 0 for k in tree}
    for coords in ((0, 0), (1, 2)):
        mesh = ctx.Mesh(("data", "model"), (2, 3), coords, torch.device("cpu"))
        shardings = {
            "cells": ctx.NamedSharding(mesh, ("data", "model")),
            "rows": ctx.NamedSharding(mesh, ("data",)),
            "flat": ctx.NamedSharding(mesh, (("data", "model"),)),
            "whole": ctx.NamedSharding(mesh),
        }
        got = tstore.restore(skel, 3, str(tmp_path), shardings=shardings)
        j, c = coords
        assert got["cells"].dtype == torch.int64 and got["cells"].shape == (1, 1, 4)
        np.testing.assert_array_equal(got["cells"].numpy(), tree["cells"][j:j + 1, c:c + 1])
        np.testing.assert_array_equal(got["rows"].numpy(), tree["rows"][3 * j:3 * j + 3])
        np.testing.assert_array_equal(got["flat"].numpy(), tree["flat"][3 * j + c:3 * j + c + 1])
        assert float(got["whole"]) == 7.5
    with pytest.raises(ValueError, match="does not split"):
        ctx.NamedSharding(ctx.Mesh(("data",), (4,), (1,), torch.device("cpu")), ("data",)).block(np.zeros((6, 2)))


def test_kernel_build_renames_the_library_into_place(tmp_path, monkeypatch):
    """nvcc writes to a temporary name and the library is ``os.replace``d
    into place, so ranks starting together never load a partial one."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    seen, replaced = [], []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            seen.append(out)
            with open(out, "wb") as f:
                f.write(b"\x7fELF")

        def communicate(self):
            return "ptxas info: 0 bytes spill", None

    real_replace = os.replace

    def spy(src, dst):
        replaced.append((str(src), str(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.os, "replace", spy)
    paths = _build.build(("hash_pack",))
    final = paths["hash_pack"]
    assert final.exists() and final.read_bytes() == b"\x7fELF"
    assert len(seen) == 1 and seen[0] != str(final) and os.path.dirname(seen[0]) == str(tmp_path)
    assert (seen[0], str(final)) in replaced
    assert final.with_suffix(".log").read_text().startswith("ptxas")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([final.name, final.with_suffix(".log").name])
    assert _build.build(("hash_pack",)) == paths and len(seen) == 1  # built: nothing to do
