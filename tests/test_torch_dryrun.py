"""The port's sharding rules, structs and dry-run against the JAX package.

Every leaf's spec comes from the same logical axes and rules as JAX's:
``logical_to_spec`` and ``param_specs`` of every FULL architecture equal
JAX's on the 16 x 16 and 2 x 16 x 16 production meshes (JAX's
``logical_to_spec`` is called with a stand-in whose ``.shape`` is the
axis dict, as it reads nothing else), and so do the input and cache specs
of every architecture x cell. The byte counts the dry-run reports over the
global structs equal ``_tree_bytes`` of JAX's ``param_structs``,
``opt_state_structs`` (32- and 8-bit moments) and ``cache_structs``
(``jax.eval_shape`` only; nothing is compiled). Last, the dry-run traces
one rank's program of one FULL cell per kind, and skips a cell JAX skips.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.sharding import ctx as jctx
from repro.train import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import ctx
from repro_torch.train import loop as tloop

MESHES = {"16x16": dryrun.MESHES[False], "2x16x16": dryrun.MESHES[True]}


def _standin(axes, shape):
    """What JAX's ``logical_to_spec`` reads of a mesh: ``.shape``."""
    return SimpleNamespace(shape=dict(zip(axes, shape)))


def _norm(spec) -> tuple:
    """A spec's entries, trailing wholes dropped (P() and (None,) alike)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jleaves(tree, prefix=""):
    """(path, PDef) of JAX's defs, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _jleaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _tleaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tleaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jbytes(tree) -> float:
    """``repro.launch.dryrun._tree_bytes`` (that module sets XLA_FLAGS when
    imported, so its arithmetic is repeated here)."""
    return sum(float(jnp.dtype(s.dtype).itemsize) * float(math.prod(s.shape)) if s.shape
               else float(jnp.dtype(s.dtype).itemsize) for s in jax.tree.leaves(tree))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_equal_jax_on_the_production_meshes(arch, mesh_name):
    axes, shape = MESHES[mesh_name]
    jmodel = japi.build_model(jconfigs.get(arch))
    tmodel = tapi.build_model(tconfigs.get(arch))
    want = {n: _norm(jctx.logical_to_spec(_standin(axes, shape), jctx.ShardingRules(), p.logical, p.shape))
            for n, p in _jleaves(jmodel.defs)}
    tdefs = dict(_tleaves(tmodel.defs))
    assert set(tdefs) == set(want)
    for n, p in tdefs.items():
        assert p.axes == dict(_jleaves(jmodel.defs))[n].logical, n
        assert _norm(ctx.logical_to_spec(_standin(axes, shape), ctx.ShardingRules(), p.axes, p.shape)) == want[n], n
    with ctx.use_mesh(ctx.dry_mesh(axes, shape)):
        got = dict(_tleaves(tmodel.param_specs()))
    assert {n: _norm(s) for n, s in got.items()} == want


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_input_and_cache_specs_equal_jax_for_every_cell(arch):
    jmodel = japi.build_model(jconfigs.get(arch))
    tmodel = tapi.build_model(tconfigs.get(arch))
    for axes, shape in MESHES.values():
        mesh, standin = ctx.dry_mesh(axes, shape), _standin(axes, shape)
        for cell in tapi.SHAPE_CELLS:
            for name, (shp, _, logical) in jmodel.input_defs(cell).items():
                want = jctx.logical_to_spec(standin, jctx.ShardingRules(), logical, shp)
                got = tmodel.input_specs(cell, mesh)[name]
                assert tuple(got.shape) == shp
                assert _norm(got.sharding.spec) == _norm(want), (cell, name)
            if tapi.SHAPE_CELLS[cell]["kind"] != "decode":
                continue
            c = japi.SHAPE_CELLS[cell]
            jcache = jax.eval_shape(lambda: japi._family_module(jmodel.cfg).init_cache(jmodel.cfg, c["batch"], c["seq"]))
            jaxes = jmodel.cache_logical_axes()
            tstructs = tmodel.cache_structs(cell, mesh)
            jflat = dict(_jleaves(jcache))
            for n, s in _tleaves(tstructs):
                j = jflat[n]
                assert tuple(s.shape) == tuple(j.shape) and s.dtype == getattr(torch, jnp.dtype(j.dtype).name), n
                logical = dict(_jleaves(jaxes, ""))[n] if "/" in n else jaxes[n]
                want = jctx.logical_to_spec(standin, jctx.ShardingRules(), tuple(logical), j.shape)
                assert _norm(s.sharding.spec) == _norm(want), (cell, n)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_opt_and_cache_bytes_equal_jax(arch):
    jmodel = japi.build_model(jconfigs.get(arch))
    tmodel = tapi.build_model(tconfigs.get(arch))
    assert tmodel.n_params == jmodel.n_params
    assert dryrun._tree_bytes(tmodel.param_structs()) == _jbytes(jmodel.param_structs())
    for bits in (32, 8):
        want = _jbytes(jloop.opt_state_structs(jmodel, None, jadamw.AdamWConfig(state_bits=bits)))
        got = dryrun._tree_bytes(tloop.opt_state_structs(tmodel, None, tadamw.AdamWConfig(state_bits=bits)))
        assert got == want, bits
    for cell, c in tapi.SHAPE_CELLS.items():
        if c["kind"] == "decode":
            assert dryrun._tree_bytes(tmodel.cache_structs(cell)) == _jbytes(jmodel.cache_structs(cell)), cell


def test_moment_scales_drop_a_mesh_axis_that_no_longer_divides():
    """8-bit moments' block scales keep the parameter's spec, except on the
    quantized axis when the shrunken dim no longer divides (JAX's rule)."""
    mesh = ctx.dry_mesh(("data", "model"), (16, 16))
    model = tapi.build_model(tconfigs.get("granite-8b"))
    structs = tloop.opt_state_structs(model, mesh, tadamw.AdamWConfig(state_bits=8))
    wq = structs.m["layers"]["wq"]  # (36, 4096, 4096): fsdp on data, quantized along axis 1 -> 32 blocks
    assert wq["q"].dtype == torch.int8 and tuple(wq["s"].shape) == (36, 32, 4096)
    assert wq["q"].sharding.spec == (None, "data", "model") and wq["s"].sharding.spec == (None, "data", "model")
    embed = structs.v["embed"]  # (49152, 4096): tensor on model, quantized along axis 0 -> 384 blocks
    assert embed["q"].dtype == torch.uint8 and embed["s"].sharding.spec[0] == "model"


@pytest.mark.parametrize("arch, cell", [("hubert-xlarge", "train_4k"), ("phi-3-vision-4.2b", "prefill_32k"),
                                        ("olmoe-1b-7b", "decode_32k")])
def test_dry_run_traces_one_rank_of_a_full_cell(arch, cell):
    rec = dryrun.run_cell(arch, cell, False, "")
    assert rec["status"] in ("ok", "fail"), rec.get("error")
    if rec["status"] == "fail":  # only a spec past the card's memory may fail a cell
        assert rec["error"].startswith("a rank holds"), rec["error"]
    assert rec["devices"] == 256 and rec["flops"] > 0
    model = tapi.build_model(tconfigs.get(arch))
    assert rec["param_bytes"] == dryrun._tree_bytes(model.param_structs())
    assert rec["memory"]["rank_bytes"] == rec["memory"]["spec_bytes"] > 0
    kinds = set(rec["collective_bytes"])
    assert kinds <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"}
    if tapi.SHAPE_CELLS[cell]["kind"] == "train":  # the gradients' and the loss's sums
        assert rec["collective_bytes"]["all-reduce"] > 0 and "opt_bytes" in rec
    if arch == "olmoe-1b-7b":  # decode: the experts' sum and context-parallel attention
        assert rec["collective_bytes"]["all-reduce"] > 0 and "cache_bytes" in rec


def test_dry_run_skips_what_jax_skips(tmp_path):
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", True, str(tmp_path))
    assert rec == {"arch": "hubert-xlarge", "cell": "decode_32k", "mesh": "2x16x16", "status": "skip",
                   "reason": "encoder-only arch: no decode step"}
    assert (tmp_path / "dryrun_hubert-xlarge_decode_32k_2x16x16.json").exists()
