"""The LM families under a mesh against the one-process port and the JAX
package.

One spawned 2 x 2 gloo world on the CPU (``launch.mesh.spawn`` running
``lm_mesh_ranks.run``: the package's ``launch.lm_mesh_job`` and the tests'
own steps, started in the background from the module's first test while
this process computes the references) runs every case:

* serving and the step-0 loss and gradients of the four families' smoke
  configs against the one-process port on the same weights and rows: dense
  (granite), ssm (mamba2) and hybrid (hymba) within one bf16 ulp of the
  largest logit and 2^-6 of a gradient leaf's largest element (the data
  ranks' bf16 gradients are summed after rounding); moe at one layer
  (olmoe, both combines, capacity n_experts / top_k so none drops) within
  2^-5 (the expert-parallel bodies sum bf16 partials, as the JAX package
  does); moe at the smoke config's two layers (phi3.5-moe), where the
  second layer's router sees those bf16 sums and a near-tied route may
  flip, with the loss within rtol 1e-3 and every gradient at a cosine of
  at least 0.95;
* the moe bodies alone (``gather`` and ``a2a``) with their ``aux`` and the
  gradients of x and every weight (aux included) against JAX's local
  ``moe_apply`` at capacity 8.0, and decode's one token (the local path
  over the gathered batch, experts summed over the expert axis) at 1.25,
  within ``tests/test_moe_ep.py``'s tolerance; ``gather``'s aux is the
  local path's, ``a2a``'s the mean over the expert axis's sequence blocks
  of JAX's local aux of each block (every row of the batch); at capacity
  1.25, where per-shard capacities drop other tokens, the outputs against
  JAX's own expert-parallel bodies on a 2 x 2 mesh of 4 host devices (a
  subprocess) and the aux against the same JAX witnesses;
* context-parallel decode attention against JAX's local form at 1e-4 and
  against JAX's own context-parallel form;
* ``launch.train.train`` under the mesh with a checkpoint: rank 0 gathers
  every split leaf and writes the JAX format; restored here it equals the
  mesh's tree, and a one-process run resumes from it at the mesh's loss;
* the holding rule: every serving weight, master, 32- and 8-bit moment and
  cache leaf a rank holds has the shape of its block under the JAX spec;
* one tensor-parallel dense block (granite-smoke's heads and FFN split
  over the model axis) and its gradients against one process, both in
  float32 (bf16 replaced by float32), at float32 tolerance;
* one train step with 8-bit moments whose blocks straddle quantization
  blocks (granite-smoke's embedding and FFN), the moments dequantized
  against one process's within twice the gradients' tolerance;
* granite-smoke's prefill logits, the JAX package's weights carried to the
  ranks by ``params.model_params_from_numpy``, against the JAX package's
  own on its 2 x 2 mesh of 4 host devices (the JAX subprocess), at the
  one-process test's tolerance (``tests/test_torch_models.py``);
  granite-smoke's and phi3.5-moe-smoke's loss, the masters carried by
  ``params.train_state_from_numpy``, against JAX's on that mesh at the
  one-process loss tolerance (``tests/test_torch_train.py``);
* the activation layout: no rank gathers the embedding or the head along
  the vocabulary when it divides (serving and training), a vocabulary
  that does not divide (127) takes the whole path and matches one
  process, the stream entering every block is the rank's rows and block
  of positions, and the blockwise loss matches ``common.softmax_xent_plain``.

Every row of the spawned world's gradients is put back together along
every dim a leaf's spec splits (``fsdp`` and ``tensor`` too).

A second world, 1 x 4 as ``chip_smoke.py``'s ``lm_mesh`` phase serves
mamba2-780m and hymba-1.5b, runs their smoke configs with the phase's own
references (``chip_smoke.ssm_serve_reference``), jobs and checks: the clean
runs pass the card's checks, and each of the phase's planted faults
(``lm_mesh_ranks``' ``planted`` step) moves the logits past the card's
tolerance on row-passes that count as a catch. The tightened fault rule
(``chip_smoke.served_checks``, ``fault_caught``) is held on synthetic
logits and routes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import sys
import textwrap
import types
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import chip_smoke
import jax
import jax.numpy as jnp
import lm_mesh_ranks
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import common as jC
from repro.models import moe as jmoe
from repro.models.api import ModelConfig as JConfig
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store as tstore
from repro_torch.launch import lm_mesh_job
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import common as tC
from repro_torch.models import dense as tdense
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tPM
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import ctx
from repro_torch.train import loop as tl

MESH = (2, 2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = {"xla_allow_excess_precision": False}
ULP = 2.0**-7  # one bf16 ulp, relative


def _over(arch: str, **kw) -> dict:
    cfg = tconfigs.get(arch, smoke=True)
    if cfg.family == "moe":
        kw.setdefault("capacity_factor", cfg.n_experts / cfg.top_k)
    return kw


# (arch, overrides, logit tolerance, gradient tolerance or "loose", loss rtol)
FAMILIES = {
    "dense": ("granite-8b", {}, ULP, 2.0**-6, 1e-5),
    "ssm": ("mamba2-780m", {}, ULP, 2.0**-6, 1e-5),
    "hybrid": ("hymba-1.5b", {}, ULP, 2.0**-6, 1e-5),
    "moe_gather": ("olmoe-1b-7b", _over("olmoe-1b-7b", n_layers=1, moe_impl="gather"), 2.0**-5, 2.0**-5, 1e-3),
    "moe_a2a": ("olmoe-1b-7b", _over("olmoe-1b-7b", n_layers=1, moe_impl="a2a"), 2.0**-5, 2.0**-5, 1e-3),
    "moe_two_layers": ("phi3.5-moe-42b-a6.6b", _over("phi3.5-moe-42b-a6.6b"), 2.0**-4, "loose", 1e-3),
}
PROMPT, DECODE = 16, 3
ROUTED = ("moe_gather", "moe_a2a")  # the cases whose ranks record moe's routes
MOE_CFG = JConfig(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                  d_ff=64, vocab=64, n_experts=8, top_k=2)
CKPT_ARCH, CKPT_OVER = "olmoe-1b-7b", _over("olmoe-1b-7b", n_layers=1)


def _cfg(arch: str, over: dict):
    return dataclasses.replace(tconfigs.get(arch, smoke=True), **over)


def _max_len(cfg, even: bool = True) -> int:
    n = PROMPT + cfg.meta_tokens + DECODE + 1
    return n + (n % 2 != (0 if even else 1))


def _inputs(arch: str, seed: int):
    cfg = tconfigs.get(arch, smoke=True)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (4, PROMPT)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, (4, DECODE)).astype(np.int32)
    return prompts, feed


def _moe_inputs():
    rng = np.random.default_rng(5)
    d, f, e = MOE_CFG.d_model, MOE_CFG.d_ff, MOE_CFG.n_experts
    p = {"router": (rng.standard_normal((d, e)) * 0.3).astype(np.float32),
         "e_gate": (rng.standard_normal((e, d, f)) / 6).astype(np.float32),
         "e_up": (rng.standard_normal((e, d, f)) / 6).astype(np.float32),
         "e_down": (rng.standard_normal((e, f, d)) / 8).astype(np.float32)}
    x = rng.standard_normal((4, 16, d)).astype(np.float32)
    return p, x


def _cp_inputs():
    rng = np.random.default_rng(6)
    b, hq, hkv, smax, dh = 4, 8, 4, 64, 16
    q = rng.standard_normal((b, 1, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, smax, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, smax, hkv, dh)).astype(np.float32)
    return q, k, v, np.asarray([60, 17, 33, 64], np.int32)


def _port_moe_cfg(cap: float, impl: str = "gather"):
    return tapi.ModelConfig(**{**dataclasses.asdict(MOE_CFG), "capacity_factor": cap, "moe_impl": impl})


SPEC_FAMILIES = {"dense": "granite-8b", "moe": "olmoe-1b-7b", "ssm": "mamba2-780m", "hybrid": "hymba-1.5b"}
TP_CFG = tconfigs.get("granite-8b", smoke=True)
CARRIED_LEN = 32
JAX_LOGIT_ATOL = 0.03  # tests/test_torch_models.py's LOGIT_ATOL, the one-process port against JAX


def _tp_inputs():
    rng = np.random.default_rng(8)
    p = {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
         for k, d in tdense.layer_defs(TP_CFG).items()}
    for k in ("ln1", "ln2"):
        p[k] = (1.0 + 0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p, rng.standard_normal((4, 16, TP_CFG.d_model)).astype(np.float32)


def _psum_input():
    return np.random.default_rng(12).standard_normal((4, 1024)).astype(np.float32)


LOSS_ARCHS = {"granite": "granite-8b", "phi": "phi3.5-moe-42b-a6.6b"}  # the loss against JAX on its mesh
# the cross entropy alone: JAX's expert-parallel bodies take each data
# shard's own routing statistics for aux, the port the global batch's
# (ROADMAP Queue 3)
NO_AUX = {"aux_loss_coef": 0.0}
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's, the one-process port against JAX
ODD_VOCAB = {"vocab": 127}  # granite-smoke with a vocabulary that does not split over 2


def _odd_inputs():
    rng = np.random.default_rng(15)
    return (rng.integers(0, ODD_VOCAB["vocab"], (4, PROMPT)).astype(np.int32),
            rng.integers(0, ODD_VOCAB["vocab"], (4, DECODE)).astype(np.int32))


def _xent_inputs():
    rng = np.random.default_rng(16)
    b, s, d, v = 4, 32, 32, 96
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            (rng.standard_normal((d, v)) * d**-0.5).astype(np.float32),
            rng.integers(0, v, (b, s)).astype(np.int32), rng.random((b, s)) < 0.7)


def _job(d) -> lm_mesh_job.LMMeshJob:
    ckpt_dir = str(d / "ckpt")
    steps = []
    for name, (arch, over, *_) in FAMILIES.items():
        prompts, feed = _inputs(arch, list(FAMILIES).index(name))
        cfg = _cfg(arch, over)
        steps.append(("serve", dict(arch=arch, smoke=True, overrides=over, prompts=prompts,
                                    max_len=_max_len(cfg), decode=DECODE, feed=feed, routes=name in ROUTED)))
        steps.append(("grads_kept", dict(arch=arch, smoke=True, overrides=over, rows=prompts)))
    prompts, feed = _inputs("granite-8b", 7)
    steps.append(("serve", dict(arch="granite-8b", smoke=True, prompts=prompts,
                                max_len=_max_len(tconfigs.get("granite-8b", smoke=True), even=False),
                                decode=DECODE, feed=feed)))
    p, x = _moe_inputs()
    for cap, impl in ((8.0, "gather"), (8.0, "a2a"), (1.25, "gather"), (1.25, "a2a")):
        steps.append(("moe", dict(cfg=_port_moe_cfg(cap), p=p, x=x, impl=impl, with_grads=cap == 8.0)))
    steps.append(("moe", dict(cfg=_port_moe_cfg(1.25), p=p, x=x[:, :1], impl="gather", with_grads=True)))
    steps.append(("cp_decode", dict(zip(("q", "k", "v", "cur"), _cp_inputs()))))
    steps.append(("train", dict(arch=CKPT_ARCH, smoke=True, overrides=CKPT_OVER, steps=2, batch=4, seq=16,
                                ckpt_dir=ckpt_dir, ckpt_every=2)))
    # the mesh resumes from its own checkpoint (each rank restores its blocks)
    steps.append(("train", dict(arch=CKPT_ARCH, smoke=True, overrides=CKPT_OVER, steps=3, batch=4, seq=16,
                                ckpt_dir=ckpt_dir)))
    for fam, arch in SPEC_FAMILIES.items():
        cfg = tconfigs.get(arch, smoke=True)
        steps.append(("shapes", dict(arch=arch, prompts=_inputs(arch, 9)[0], max_len=_max_len(cfg))))
    p, x = _tp_inputs()
    steps.append(("tp_block", dict(cfg=TP_CFG, p=p, x=x)))
    steps.append(("moments8", dict(arch="granite-8b", rows=_inputs("granite-8b", 10)[0])))
    steps.append(("psum_forms", dict(x=_psum_input())))
    steps.append(("serve_carried", dict(arch="granite-8b", params=str(d / "granite.npz"),
                                        prompts=_inputs("granite-8b", 11)[0], max_len=CARRIED_LEN)))
    for name, arch in LOSS_ARCHS.items():
        steps.append(("loss_carried", dict(arch=arch, overrides=NO_AUX, params=str(d / f"{name}.npz"),
                                           rows=_inputs(arch, 12)[0])))
    for arch in LOSS_ARCHS.values():  # granite-smoke's d_ff as its vocabulary's would give w_gate the head's shape
        steps.append(("vocab_gathers", dict(arch=arch, overrides={"d_ff": 96}, prompts=_inputs(arch, 13)[0],
                                            max_len=_max_len(tconfigs.get(arch, smoke=True)))))
    prompts, feed = _odd_inputs()
    steps.append(("serve", dict(arch="granite-8b", smoke=True, overrides=ODD_VOCAB, prompts=prompts,
                                max_len=_max_len(TP_CFG), decode=DECODE, feed=feed)))
    steps.append(("grads_kept", dict(arch="granite-8b", smoke=True, overrides=ODD_VOCAB, rows=prompts)))
    for arch in SPEC_FAMILIES.values():
        steps.append(("stream_shapes", dict(arch=arch, prompts=_inputs(arch, 14)[0],
                                            max_len=_max_len(tconfigs.get(arch, smoke=True)))))
    steps.append(("xent", dict(zip(("x", "head", "labels", "mask"), _xent_inputs()), chunk=16)))
    return lm_mesh_job.LMMeshJob(mesh=MESH, steps=tuple(steps), device="cpu")


STEP = {}  # case name -> index of its step in the job
_i = 0
for _name in FAMILIES:
    STEP[f"serve_{_name}"], STEP[f"grads_{_name}"] = _i, _i + 1
    _i += 2
for _name in ("serve_fallback", "moe_gather_8", "moe_a2a_8", "moe_gather_125", "moe_a2a_125", "moe_decode",
              "cp_decode", "train_ckpt", "train_resumed", *(f"shapes_{f}" for f in SPEC_FAMILIES), "tp_block",
              "moments8", "psum_forms", "serve_carried", *(f"loss_{n}" for n in LOSS_ARCHS),
              *(f"gathers_{n}" for n in LOSS_ARCHS), "serve_odd_vocab", "grads_odd_vocab",
              *(f"stream_{f}" for f in SPEC_FAMILIES), "xent"):
    STEP[_name] = _i
    _i += 1

JAX_EP = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.models import common as C
    from repro.models import moe
    from repro.models.api import ModelConfig
    from repro.launch.mesh import make_local_mesh
    from repro.sharding import ctx

    inp = np.load(sys.argv[1])
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                      d_ff=64, vocab=64, n_experts=8, top_k=2, capacity_factor=1.25)
    p = {k: jnp.asarray(inp[k]) for k in ("router", "e_gate", "e_up", "e_down")}
    mesh = make_local_mesh(2, 2)
    out = {}
    with ctx.use_mesh(mesh):
        for impl in ("gather", "a2a"):
            c = dataclasses.replace(cfg, moe_impl=impl)
            o, a = jax.jit(lambda p, x: moe.moe_apply(p, x, c))(p, jnp.asarray(inp["x"]))
            out[impl + "_out"], out[impl + "_aux"] = np.asarray(o, np.float32), np.asarray(a)
        args = [jnp.asarray(inp[k]) for k in ("q", "k", "v", "cur")]
        out["cp"] = np.asarray(jax.jit(lambda *a: C.decode_attention_cp(*a))(*args))
        # granite-smoke's prefill on the 2 x 2 mesh, from the weights the ranks carry across
        from repro import configs
        from repro.models import dense
        params = {}
        with np.load(sys.argv[3]) as f:
            for name in f.files:
                node = params
                *path, leaf = name.split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(f[name])
        gcfg = configs.get("granite-8b", smoke=True)
        prefill = jax.jit(lambda p, t: dense.prefill(gcfg, p, {"tokens": t}, int(sys.argv[5]))[0])
        out["granite_prefill"] = np.asarray(prefill(params, jnp.asarray(np.load(sys.argv[4]))), np.float32)
        # the loss of granite-smoke and phi3.5-moe-smoke on the mesh, from the weights the ranks carry across
        from repro.models import api
        for name, arch in (("granite", "granite-8b"), ("phi", "phi3.5-moe-42b-a6.6b")):
            tree = {}
            with np.load(os.path.join(os.path.dirname(sys.argv[3]), name + ".npz")) as f:
                for key in f.files:
                    node = tree
                    *path, leaf = key.split("/")
                    for k in path:
                        node = node.setdefault(k, {})
                    node[leaf] = jnp.asarray(f[key])
            model = api.build_model(dataclasses.replace(configs.get(arch, smoke=True), aux_loss_coef=0.0))
            rows = jnp.asarray(np.load(os.path.join(os.path.dirname(sys.argv[3]), name + "_loss_rows.npy")))
            loss = jax.jit(lambda p, t: model.loss_fn(p, {"tokens": t})).lower(tree, rows).compile(
                {"xla_allow_excess_precision": False})  # XLA:CPU's excess precision flips near-tied moe routes
            out[name + "_loss"] = np.asarray(loss(tree, rows))
    np.savez(sys.argv[2], **out)
    print("OK")
    """
)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawned world's future, the JAX subprocess and their directory."""
    d = tmp_path_factory.mktemp("lm_mesh")
    p, x = _moe_inputs()
    np.savez(d / "inp.npz", x=x, **p, **dict(zip(("q", "k", "v", "cur"), _cp_inputs())))
    for name, arch in LOSS_ARCHS.items():
        jparams = japi.build_model(jconfigs.get(arch, smoke=True)).init(jax.random.PRNGKey(0))
        np.savez(d / f"{name}.npz", **lm_mesh_job._flat(jax.tree.map(np.asarray, jparams)))
        np.save(d / f"{name}_loss_rows.npy", _inputs(arch, 12)[0])
    np.save(d / "granite_prompts.npy", _inputs("granite-8b", 11)[0])
    jax_ep = subprocess.Popen([sys.executable, "-c", JAX_EP, str(d / "inp.npz"), str(d / "jax_ep.npz"),
                               str(d / "granite.npz"), str(d / "granite_prompts.npy"), str(CARRIED_LEN)],
                              env=dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu"), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(tmesh.spawn, lm_mesh_ranks.run, 4, store_dir=str(d / "store"),
                      args=(_job(d),), timeout_s=240)
    yield {"future": fut, "jax": jax_ep, "dir": d}
    pool.shutdown(wait=True)
    jax_ep.wait()


def _reports(world) -> list[dict]:
    reports = world["future"].result(timeout=600)
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    return reports


def _jax_ep(world) -> dict:
    out, err = world["jax"].communicate(timeout=600)
    assert world["jax"].returncode == 0, err[-3000:]
    with np.load(world["dir"] / "jax_ep.npz") as f:
        return dict(f)


def _rows(reports, step: int, key) -> np.ndarray:
    """The ranks' row blocks of ``key(step report)`` put back in row order
    (one rank of each model line)."""
    parts = {}
    for r in reports:
        s = r["steps"][step]
        parts[tuple(s["rows"]) if "rows" in s else r["coords"][0]] = key(s)
    return np.concatenate([parts[k] for k in sorted(parts)], 0)


def _serve_one(arch, over, prompts, feed, max_len, routes: bool = False):
    """The one-process logits of each pass, and with ``routes`` each
    pass's moe routes (``moe.routes_table``)."""
    cfg = _cfg(arch, over)
    model = tapi.build_model(cfg)
    params = model.init(0, "cpu")
    out, noted = [], []

    def run(fn):
        tmoe.ROUTES = [] if routes else None
        try:
            lg, cache = fn()
        finally:
            rec, tmoe.ROUTES = tmoe.ROUTES, None
        out.append(lg.float().numpy())
        noted.append(tmoe.routes_table([rec]) if routes else None)
        return cache

    with torch.no_grad():
        cache = run(lambda: model.prefill(params, {"tokens": torch.as_tensor(prompts)}, max_len))
        for i in range(feed.shape[1]):
            cache = run(lambda: model.decode_step(params, cache, torch.as_tensor(feed[:, i : i + 1])))
    return (out, noted) if routes else out


def _grads_one(arch, over, rows):
    cfg = _cfg(arch, over)
    model = tapi.build_model(cfg)
    params = model.init_masters(0, "cpu")
    loss, grads = tl._value_and_grad(model, params, {"tokens": torch.as_tensor(rows)})
    names = list(lm_mesh_job._flat(params))
    return float(loss), {n: g.float().numpy() for n, g in zip(names, grads)}, lm_mesh_job._flat(model.defs)


def _assemble(reports, step: int, name: str, pdef, key=None, sharding=None) -> np.ndarray:
    """A gradient leaf whole, each rank's block (``key(step report)``, by
    default its ``grads[name]``) put at its place along every dim its spec
    splits (``sharding(mesh)``, by default ``pdef``'s; ``pdef`` needs only
    ``.shape`` then); the ranks that hold the same block (its replicas)
    must hold the same values."""
    out, seen = None, {}
    for r in reports:
        mesh = ctx.dry_mesh(("data", "model"), MESH, tuple(r["coords"]))
        sh = tPM.sharding_of(pdef, mesh) if sharding is None else sharding(mesh)
        at = tuple(slice(i * (n0 // n), (i + 1) * (n0 // n))
                   for (n, i), n0 in zip(sh._cuts(pdef.shape, sh.spec), pdef.shape))
        got = (key or (lambda s: s["grads"][name]))(r["steps"][step])
        assert got.shape == sh.block_shape(pdef.shape), (name, got.shape)
        where = tuple((a.start, a.stop) for a in at)
        if where in seen:
            np.testing.assert_array_equal(got, seen[where], err_msg=f"{name}: the replicas' blocks differ")
            continue
        seen[where] = got
        out = np.zeros(pdef.shape, got.dtype) if out is None else out
        out[at] = got
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_serving_under_the_mesh_matches_one_process(world, name):
    arch, over, tol, *_ = FAMILIES[name]
    prompts, feed = _inputs(arch, list(FAMILIES).index(name))
    cfg = _cfg(arch, over)
    want = _serve_one(arch, over, prompts, feed, _max_len(cfg))
    reports = _reports(world)
    step = STEP[f"serve_{name}"]
    if cfg.family != "ssm":  # the attention cache's positions in blocks over the model axis
        assert reports[0]["steps"][step]["seq_blocks"] == 2
    for j, w in enumerate(want):
        got = _rows(reports, step, lambda s, j=j: s["passes"][j]["logits"])
        np.testing.assert_allclose(got, w, rtol=0, atol=tol * float(np.abs(w).max()), err_msg=f"pass {j}")


@pytest.mark.parametrize("name", ROUTED)
def test_moe_routes_under_the_mesh_match_one_process(world, name):
    """The routes the ranks record, put together over the global batch, are
    one process's: the same experts for every token of every layer and
    pass (the mesh's router reads the same bits: one layer, nothing summed
    across ranks before it), and no copy dropped by a2a's receivers."""
    arch, over, *_ = FAMILIES[name]
    prompts, feed = _inputs(arch, list(FAMILIES).index(name))
    want = _serve_one(arch, over, prompts, feed, _max_len(_cfg(arch, over)), routes=True)[1]
    reports = _reports(world)
    for j, w in enumerate(want):
        got = tmoe.routes_table([r["steps"][STEP[f"serve_{name}"]]["passes"][j]["routes"] for r in reports])
        assert len(got) == len(w) == 1
        assert got[0]["dropped"] == 0
        np.testing.assert_array_equal(got[0]["used"], w[0]["used"], err_msg=f"pass {j}")
        np.testing.assert_array_equal(got[0]["top_e"], w[0]["top_e"], err_msg=f"pass {j}")
        assert w[0]["used"].sum() == w[0]["used"].shape[0] * w[0]["used"].shape[1] * _cfg(arch, over).top_k


def test_decode_falls_back_to_local_attention_when_the_cache_does_not_split(world):
    prompts, feed = _inputs("granite-8b", 7)
    cfg = tconfigs.get("granite-8b", smoke=True)
    want = _serve_one("granite-8b", {}, prompts, feed, _max_len(cfg, even=False))
    reports = _reports(world)
    assert reports[0]["steps"][STEP["serve_fallback"]]["seq_blocks"] == 1
    for j, w in enumerate(want):
        got = _rows(reports, STEP["serve_fallback"], lambda s, j=j: s["passes"][j]["logits"])
        np.testing.assert_allclose(got, w, rtol=0, atol=ULP * float(np.abs(w).max()))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_step0_loss_and_gradients_under_the_mesh_match_one_process(world, name):
    arch, over, _, tol, loss_rtol = FAMILIES[name]
    prompts, _ = _inputs(arch, list(FAMILIES).index(name))
    loss, grads, defs = _grads_one(arch, over, prompts)
    reports = _reports(world)
    step = STEP[f"grads_{name}"]
    losses = {r["steps"][step]["loss"] for r in reports}
    assert len(losses) == 1  # every rank computes the global batch's loss
    got_loss = losses.pop()
    assert abs(got_loss - loss) <= loss_rtol * abs(loss)
    for n, want in grads.items():
        got = _assemble(reports, step, n, defs[n])
        assert got.shape == want.shape, n
        if tol == "loose":
            cos = float((got * want).sum() / max(np.sqrt((got * got).sum() * (want * want).sum()), 1e-30))
            assert cos >= 0.95, (n, cos)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()), err_msg=n)


def _jax_moe(p, x, cap: float, aux_blocks: int = 1):
    """JAX's local ``moe_apply`` (jitted without excess precision): out, aux,
    and the gradients of sum(out^2) + aux with respect to x and each
    weight. With ``aux_blocks`` > 1, aux is the mean of the local aux of
    each of that many blocks of the sequence (every row of the batch):
    what ``a2a``'s pmean over the expert axis of each block's statistics
    computes."""
    cfg = dataclasses.replace(MOE_CFG, capacity_factor=cap)

    def f(p, x):
        out, aux = jmoe.moe_apply(p, x, cfg)
        if aux_blocks > 1:
            aux = jnp.mean(jnp.stack([jmoe.moe_apply(p, xb, cfg)[1] for xb in jnp.split(x, aux_blocks, axis=1)]))
        return jnp.sum(out.astype(jnp.float32) ** 2) + aux, (out, aux)

    args = ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True)).lower(*args).compile(EXACT)
    (_, (out, aux)), (gp, gx) = fn(*args)
    return np.asarray(out, np.float32), float(aux), {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}


def _aux_blocks(impl: str) -> int:
    return MESH[1] if impl == "a2a" else 1


def _moe_grads(reports, step: int) -> dict:
    defs = tmoe.layer_defs(_port_moe_cfg(8.0))
    out = {k: _assemble(reports, step, k, defs[k]) for k in ("router", "e_gate", "e_up", "e_down")}
    out["x"] = np.concatenate([r["steps"][step]["grads"]["x"] for r in reports if r["coords"][1] == 0], 0)
    return out


@pytest.mark.parametrize("case", ["moe_gather_8", "moe_a2a_8", "moe_decode"])
def test_moe_bodies_and_gradients_match_jax_local(world, case):
    p, x = _moe_inputs()
    xx, cap = (x[:, :1], 1.25) if case == "moe_decode" else (x, 8.0)
    out, aux, grads = _jax_moe(p, xx, cap, _aux_blocks("a2a" if case == "moe_a2a_8" else "gather"))
    reports = _reports(world)
    step = STEP[case]
    got = np.concatenate([r["steps"][step]["out"] for r in reports if r["coords"][1] == 0], 0)
    # bf16 collectives: tests/test_moe_ep.py's tolerance
    np.testing.assert_allclose(got, out, rtol=5e-2, atol=5e-2)
    for r in reports:
        np.testing.assert_allclose(r["steps"][step]["aux"], aux, rtol=1e-3)
    for k, g in _moe_grads(reports, step).items():
        np.testing.assert_allclose(g, grads[k], rtol=0, atol=5e-2 * float(np.abs(grads[k]).max()), err_msg=k)


@pytest.mark.parametrize("impl", ["gather", "a2a"])
def test_moe_bodies_match_jax_expert_parallel_at_capacity_125(world, impl):
    want = _jax_ep(world)
    reports = _reports(world)
    step = STEP[f"moe_{impl}_125"]
    got = np.concatenate([r["steps"][step]["out"] for r in reports if r["coords"][1] == 0], 0)
    np.testing.assert_allclose(got, want[f"{impl}_out"], rtol=5e-2, atol=5e-2)
    # aux against the local witness, not JAX's expert-parallel aux: JAX's
    # shard bodies return each data shard's own statistics as a replicated
    # value, the port sums them over the batch axes (ROADMAP Queue 3)
    p, x = _moe_inputs()
    aux = _jax_moe(p, x, 1.25, _aux_blocks(impl))[1]
    for r in reports:
        np.testing.assert_allclose(r["steps"][step]["aux"], aux, rtol=1e-3)


def test_context_parallel_decode_matches_jax(world):
    q, k, v, cur = _cp_inputs()
    local = np.asarray(jC.decode_attention_cp(*(jnp.asarray(a) for a in (q, k, v, cur))))
    reports = _reports(world)
    step = STEP["cp_decode"]
    for r in reports:
        assert r["steps"][step]["blocks"] == 2
        np.testing.assert_allclose(r["steps"][step]["out"], local, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["steps"][step]["out"], _jax_ep(world)["cp"], rtol=1e-4, atol=1e-4)


def _digest(a) -> str:
    t = torch.as_tensor(np.ascontiguousarray(a)) if not isinstance(a, torch.Tensor) else a
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def test_checkpoint_saved_under_the_mesh_loads_and_resumes_in_one_process(world):
    reports = _reports(world)
    ckpt = str(world["dir"] / "ckpt")
    assert tstore.latest_step(ckpt) == 2
    cfg = _cfg(CKPT_ARCH, CKPT_OVER)
    model = tapi.build_model(cfg)
    params = model.init_masters(0, "cpu")
    opt = tadamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=2, state_bits=cfg.opt_state_bits)
    restored = tstore.restore({"params": params, "opt": tadamw.init(params, opt)}, 2, ckpt, "cpu")
    flat = lm_mesh_job._flat(restored["params"])
    defs = lm_mesh_job._flat(model.defs)
    for r in reports:
        mesh = ctx.dry_mesh(("data", "model"), MESH, tuple(r["coords"]))
        for n, dig in r["steps"][STEP["train_ckpt"]]["params_digest"].items():
            block = tPM.sharding_of(defs[n], mesh).block(flat[n]).contiguous()
            assert _digest(block) == dig, (n, r["coords"])
    # one process resumes at step 2 and takes step 2 as the mesh, resumed
    # from the same checkpoint, did (the stream starts over on a resume, as
    # the JAX launcher's does)
    history, _, _ = tlaunch.train(cfg, steps=3, batch=4, seq=16, ckpt_dir=ckpt, device="cpu", log=lambda *_: None)
    resumed = [h["loss"] for h in reports[0]["steps"][STEP["train_resumed"]]["history"]]
    assert len(history) == len(resumed) == 1
    assert abs(history[0]["loss"] - resumed[0]) <= 1e-3 * abs(resumed[0])


def _emulated(monkeypatch, n: int, fn, xs: list, gs: list):
    """Each rank r of an n-rank ``model`` axis in this process: the
    forward ``fn(mesh, x_r)`` and the gradient of ``<y_r, g_r>`` with
    respect to x_r, the transport replaced by the ranks' tensors (the
    inputs in the forward, the output gradients in the backward)."""
    feed: dict = {}

    def parts(mesh, axis, t):
        return torch.stack([f.to(t.dtype) for f in feed["now"]])

    def exchange(mesh, axis, t):
        me = ctx.axis_index(mesh, axis)
        return torch.cat([torch.chunk(f, n, dim=0)[me] for f in feed["now"]], dim=0)

    def scatter_sum(mesh, axes, t, dim):
        me = ctx.axis_index(mesh, axes[0])
        return torch.chunk(sum(f.to(t.dtype) for f in feed["now"]), n, dim=dim)[me]

    monkeypatch.setattr(ctx, "_gather_stack", parts)
    monkeypatch.setattr(ctx, "_exchange", exchange)
    monkeypatch.setattr(ctx, "_scatter_sum", scatter_sum)
    ys, grads = [], []
    for r in range(n):
        mesh = ctx.Mesh(("model",), (n,), (r,), torch.device("cpu"), "gloo")
        feed["now"] = xs
        x = xs[r].clone().requires_grad_()
        y = fn(mesh, x)
        feed["now"] = gs
        (g,) = torch.autograd.grad(y, x, gs[r])
        ys.append(y.detach())
        grads.append(g)
    return ys, grads


def _in_mesh(mesh, fn):
    with ctx.use_mesh(mesh):
        return fn()


@pytest.mark.parametrize("name", ["psum", "all_gather_tiled", "psum_scatter", "all_to_all", "gather_dims",
                                  "mean_grad", "keep_block"])
def test_each_collective_function_is_the_adjoint_of_its_forward(monkeypatch, name):
    """A one-process emulation of 4 ranks: each collective computes what
    its JAX namesake does, and its backward is its transpose,
    sum_r <C(x)_r, g_r> = sum_r <x_r, C^T(g)_r>. ``gather_dims`` is the
    tiled all-gather of a weight's ``tensor`` dim; ``mean_grad`` (identity
    forward, the gradient averaged) is the transpose of the identity on a
    replicated input, where every rank's x is the same; so is
    ``keep_block`` (the rank's block of a value the ranks hold alike, the
    blocks' gradients all-gathered and averaged)."""
    n = 4
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(8, 6, dtype=torch.float64, generator=gen) for _ in range(n)]
    if name in ("mean_grad", "keep_block"):
        xs = [xs[0].clone() for _ in range(n)]
    fns = {
        "gather_dims": (lambda m, t: _in_mesh(m, lambda: ctx.gather_dims(t, ("tensor", None), (32, 6))),
                        lambda r: torch.cat(xs, 0)),
        "mean_grad": (lambda m, t: ctx.mean_grad(m, "model", t), lambda r: xs[r]),
        "keep_block": (lambda m, t: ctx.keep_block(m, "model", t, 0), lambda r: xs[r][2 * r : 2 * r + 2]),
        "psum": (lambda m, t: ctx.psum(m, "model", t), lambda r: sum(xs)),
        "all_gather_tiled": (lambda m, t: ctx.all_gather_tiled(m, "model", t, 1), lambda r: torch.cat(xs, 1)),
        "psum_scatter": (lambda m, t: ctx.psum_scatter(m, "model", t, 0), lambda r: sum(xs)[2 * r : 2 * r + 2]),
        "all_to_all": (lambda m, t: ctx.all_to_all(m, "model", t),
                       lambda r: torch.cat([x[2 * r : 2 * r + 2] for x in xs], 0)),
    }
    fn, want = fns[name]
    shape = want(0).shape
    gs = [torch.randn(shape, dtype=torch.float64, generator=gen) for _ in range(n)]
    ys, grads = _emulated(monkeypatch, n, fn, xs, gs)
    for r in range(n):
        torch.testing.assert_close(ys[r], want(r))
    lhs = sum(float((y * g).sum()) for y, g in zip(ys, gs))
    rhs = sum(float((x * g).sum()) for x, g in zip(xs, grads))
    assert abs(lhs - rhs) <= 1e-9 * max(abs(lhs), 1.0)


def test_collectives_are_the_identity_on_one_rank():
    mesh = tmesh.make_local_mesh(1, 1, device="cpu")
    x = torch.randn(4, 6)
    for y in (ctx.psum(mesh, "model", x), ctx.all_gather_tiled(mesh, "model", x, 1),
              ctx.psum_scatter(mesh, "model", x, 0), ctx.all_to_all(mesh, "model", x),
              ctx.pmean(mesh, ("data", "model"), x), ctx.pmax(mesh, "model", x)):
        assert torch.equal(y, x)


def test_dry_collectives_tally_output_bytes():
    mesh = ctx.dry_mesh(("data", "model"), (4, 2))
    ctx.DRY_BYTES.clear()
    x = torch.empty(8, 6, dtype=torch.bfloat16, device="meta")
    assert ctx.all_gather_tiled(mesh, "model", x, 0).shape == (16, 6)
    assert ctx.psum_scatter(mesh, ("data", "model"), x, 0).shape == (1, 6)
    assert ctx.psum(mesh, "data", x).shape == (8, 6)
    assert ctx.all_to_all(mesh, "model", x).shape == (8, 6)
    assert ctx.DRY_BYTES == {"all-gather": 16 * 6 * 2, "reduce-scatter": 6 * 2, "all-reduce": 8 * 6 * 2,
                             "all-to-all": 8 * 6 * 2}


def _struct_shapes(tree, prefix: str = "") -> dict:
    """``name -> block shape`` of every struct of nested dicts (an 8-bit
    moment's ``q`` and ``s`` apart), as ``lm_mesh_ranks.leaf_shapes`` names
    a rank's leaves; an optimizer state's ``step`` left out (the rank
    reports ``m`` and ``v``)."""
    out = {}
    for k in sorted(tree):
        if k == "step":
            continue
        v = tree[k]
        out.update(_struct_shapes(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": tuple(v.sharding.block_shape(v.shape))})
    return out


@pytest.mark.parametrize("family", list(SPEC_FAMILIES))
def test_every_rank_holds_its_spec_block(world, family):
    """Every serving weight, master, moment (32- and 8-bit, block scales as
    ``opt_state_structs`` lays them out) and cache leaf a rank holds has
    the shape of its block under the JAX spec, ``fsdp`` and ``tensor``
    split too."""
    arch = SPEC_FAMILIES[family]
    cfg = tconfigs.get(arch, smoke=True)
    model = tapi.build_model(cfg)
    mod = tapi._family_module(cfg)
    reports = _reports(world)
    split = 0
    for r in reports:
        got = r["steps"][STEP[f"shapes_{family}"]]
        mesh = ctx.dry_mesh(("data", "model"), MESH, tuple(r["coords"]))
        want = {
            "masters": _struct_shapes(model.param_structs(mesh)),
            **{f"moments{bits}": _struct_shapes(tl.opt_state_structs(model, mesh, tadamw.AdamWConfig(state_bits=bits))
                                                ._asdict(), "") for bits in (32, 8)},
            "cache": _struct_shapes(tdryrun._cache_structs(model, 4, _max_len(cfg), mesh)),
        }
        for kind, shapes in want.items():
            assert got[kind] == shapes, (family, kind, r["coords"])
        serving = _struct_shapes(tPM.param_structs(mod.storage_defs(model.defs), mesh))
        held = got["params"]
        for n, shape in serving.items():
            if n in held:
                assert held[n] == shape, (family, n)
            else:  # the dense serving model's per-layer views of a stacked leaf
                head, leaf = n.rsplit("/", 1)
                rows = [held[f"{head}/{i}/{leaf}"] for i in range(shape[0])]
                assert rows == [shape[1:]] * shape[0], (family, n)
        split += sum(s.sharding.block_shape(s.shape) != tuple(s.shape)
                     for s in lm_mesh_job._flat(model.param_structs(mesh)).values())
    assert split > 0  # the fsdp and tensor dims are split, not held whole


def test_tensor_parallel_dense_block_and_gradients_match_one_process(world, monkeypatch):
    """granite-smoke's block with its 4/2 heads and 128 FFN columns split
    over the model axis (attention and the MLP tensor-parallel, the weights'
    d rows over the data axis), in float32 on both sides, against one
    process at float32 tolerance: the output, and the gradients of the
    global sum of squares with respect to x and every weight."""
    p, x = _tp_inputs()
    monkeypatch.setattr(tC, "COMPUTE_DTYPE", torch.float32)
    pp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    xx = torch.as_tensor(x).requires_grad_()
    y = tdense.block_train(TP_CFG, pp, xx, torch.arange(x.shape[1]))
    gs = torch.autograd.grad((y ** 2).sum(), [xx] + [pp[k] for k in sorted(pp)])
    want = {"x": gs[0].numpy(), **{k: g.numpy() for k, g in zip(sorted(pp), gs[1:])}}
    reports = _reports(world)
    step = STEP["tp_block"]
    assert reports[0]["steps"][step]["attn_axes"] == ("model",) == reports[0]["steps"][step]["ffn_axes"]
    got = np.concatenate([r["steps"][step]["out"] for r in reports if r["coords"][1] == 0], 0)
    np.testing.assert_allclose(got, y.detach().numpy(), rtol=1e-5, atol=1e-5)
    gx = np.concatenate([r["steps"][step]["grads"]["x"] for r in reports if r["coords"][1] == 0], 0)
    np.testing.assert_allclose(gx, want["x"], rtol=1e-5, atol=1e-5 * float(np.abs(want["x"]).max()))
    defs = tdense.layer_defs(TP_CFG)
    for k in sorted(p):
        g = _assemble(reports, step, k, defs[k])
        np.testing.assert_allclose(g, want[k], rtol=1e-5, atol=1e-5 * float(np.abs(want[k]).max()), err_msg=k)


def test_8bit_moments_straddling_quantization_blocks_match_one_process(world):
    """granite-smoke on 2 x 2 with 8-bit moments: the embedding's vocab and
    the FFN's 128 columns split into blocks of 64, half a quantization
    block, so the rank quantizes them gathered along that axis and holds
    the block scales whole there (JAX's layout). After one step every
    moment, dequantized, is one process's within twice the gradients'
    tolerance (m and sqrt(v) are the clipped gradient, scaled)."""
    cfg = tconfigs.get("granite-8b", smoke=True)
    model = tapi.build_model(cfg)
    opt = tadamw.AdamWConfig(state_bits=8, warmup_steps=1, total_steps=2)
    params = model.init_masters(0, "cpu")
    state = tadamw.init(params, opt)
    rows = _inputs("granite-8b", 10)[0]
    _, state, metrics = tl.make_train_step(model, opt)(params, state, {"tokens": torch.as_tensor(rows)})
    reports = _reports(world)
    step = STEP["moments8"]
    assert abs(reports[0]["steps"][step]["loss"] - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    straddled = 0
    for which in ("m", "v"):
        for n, ref in lm_mesh_job._flat(getattr(state, which)).items():
            def pick(s, which=which, n=n, part=None):
                node = s[which]
                for k in n.split("/"):
                    node = node[k]
                return node if part is None else node[part]

            def layout(mesh, which=which, n=n, part=None):
                node = getattr(tl.opt_state_structs(model, mesh, opt), which)
                for k in n.split("/"):
                    node = node[k]
                return (node if part is None else node[part]).sharding

            if isinstance(ref, dict):
                parts = {k: _assemble(reports, step, f"{which}/{n}/{k}", ref[k], partial(pick, part=k),
                                      partial(layout, part=k)) for k in ("q", "s")}
                mesh = ctx.dry_mesh(("data", "model"), MESH)
                straddled += layout(mesh, part="s").spec != layout(mesh, part="q").spec
                got, want = lm_mesh_job._moment_values({k: torch.as_tensor(v) for k, v in parts.items()}), \
                    lm_mesh_job._moment_values(ref)
            else:
                got, want = torch.as_tensor(_assemble(reports, step, f"{which}/{n}", ref, pick, layout)), ref
            if which == "v":
                got, want = got.sqrt(), want.sqrt()
            tol = 2 * 2.0**-6 * float(want.abs().max())
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol, err_msg=f"{which}/{n}")
    assert straddled >= 4  # m and v of the embedding and of w_gate, w_up or w_down


def test_carried_weights_prefill_on_the_mesh_matches_jax_on_its_mesh(world):
    """The JAX package's granite-smoke weights, carried to each rank as its
    spec blocks, give the prefill logits JAX computes on its own 2 x 2 mesh
    of 4 host devices, within the one-process test's tolerance, and the
    greedy token wherever JAX's top-2 margin exceeds twice it."""
    want = _jax_ep(world)["granite_prefill"]
    reports = _reports(world)
    step = STEP["serve_carried"]
    got = _rows(reports, step, lambda s: s["logits"])
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_LOGIT_ATOL)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * JAX_LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    cfg = tconfigs.get("granite-8b", smoke=True)
    embed = reports[0]["steps"][step]["held"]["embed"]
    assert embed == (cfg.vocab // MESH[1], cfg.d_model // MESH[0])  # ("tensor", "fsdp") split


def test_psum_forms_give_the_same_bits(world):
    """``ctx.psum`` over data then model as one all-gather of the whole and
    as a reduce-scatter of blocks and an all-gather of the sums (the form
    of large tensors): the same bits on every rank, those of the sum in
    rank order, in float32 and in bf16."""
    x = torch.as_tensor(_psum_input())
    reports = _reports(world)
    for dt in (torch.float32, torch.bfloat16):
        v = {(d, m): (x * (d * MESH[1] + m + 1)).to(dt) for d in range(MESH[0]) for m in range(MESH[1])}
        over_data = {m: v[(0, m)] + v[(1, m)] for m in range(MESH[1])}
        want = (over_data[0] + over_data[1]).float().numpy()
        for r in reports:
            got = r["steps"][STEP["psum_forms"]]
            name = str(dt)[6:]
            np.testing.assert_array_equal(got[f"gather_{name}"], want)
            np.testing.assert_array_equal(got[f"scatter_{name}"], want)


@pytest.mark.parametrize("name", list(LOSS_ARCHS))
def test_carried_masters_loss_on_the_mesh_matches_jax_on_its_mesh(world, name):
    """The JAX package's granite-smoke and phi3.5-moe-smoke weights,
    carried to each rank as its blocks of the training masters, give on
    the 2 x 2 mesh (the embedding, the head and the loss in vocabulary
    blocks, the stream in blocks of positions) the loss JAX computes on
    its own 2 x 2 mesh, within the one-process test's tolerance; every
    rank returns the global batch's. moe's load-balancing term is left out
    (``NO_AUX``)."""
    want = float(_jax_ep(world)[f"{name}_loss"])
    losses = {r["steps"][STEP[f"loss_{name}"]]["loss"] for r in _reports(world)}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(LOSS_ARCHS))
def test_no_rank_gathers_the_vocabulary_when_it_divides(world, name):
    """granite-smoke (tied) and phi3.5-moe-smoke (untied), vocabulary 128
    over a model axis of 2: in a prefill, a decode step and the step-0
    loss and gradients every ``gather_dims`` call on the embedding or the
    head gathers its ``fsdp`` dim alone, never ``tensor``."""
    reports = _reports(world)
    for r in reports:
        got = r["steps"][STEP[f"gathers_{name}"]]
        assert got["vocab_axes"] == ("model",)
        leaves = {leaf for leaf, _ in got["calls"]}
        assert leaves == ({"embed"} if tconfigs.get(LOSS_ARCHS[name], smoke=True).tie_embeddings
                          else {"embed", "lm_head"}), leaves
        for leaf, dims in got["calls"]:
            assert dims == ["fsdp"], (leaf, dims, r["coords"])


def test_a_vocabulary_that_does_not_divide_takes_the_whole_path(world):
    """granite-smoke with a vocabulary of 127 on the 2 x 2 mesh: the spec
    leaves the vocabulary whole (as JAX drops the axis), and serving and
    the step-0 loss and gradients match one process at the dense family's
    tolerances."""
    prompts, feed = _odd_inputs()
    want = _serve_one("granite-8b", ODD_VOCAB, prompts, feed, _max_len(TP_CFG))
    reports = _reports(world)
    for j, w in enumerate(want):
        got = _rows(reports, STEP["serve_odd_vocab"], lambda s, j=j: s["passes"][j]["logits"])
        np.testing.assert_allclose(got, w, rtol=0, atol=ULP * float(np.abs(w).max()), err_msg=f"pass {j}")
    loss, grads, defs = _grads_one("granite-8b", ODD_VOCAB, prompts)
    step = STEP["grads_odd_vocab"]
    assert abs(reports[0]["steps"][step]["loss"] - loss) <= 1e-5 * abs(loss)
    for n, w in grads.items():
        got = _assemble(reports, step, n, defs[n])
        np.testing.assert_allclose(got, w, rtol=0, atol=2.0**-6 * float(np.abs(w).max()), err_msg=n)


@pytest.mark.parametrize("family", list(SPEC_FAMILIES))
def test_the_stream_entering_each_block_is_the_ranks_block(world, family):
    """Between blocks a rank holds its rows and its block of positions of
    the stream: (B / 2, S / 2, D) entering every block of the prefill and
    of the loss path (hymba's S counting its meta tokens), (B / 2, 1, D)
    entering every block of a decode step."""
    cfg = tconfigs.get(SPEC_FAMILIES[family], smoke=True)
    b, s = 4 // MESH[0], (PROMPT + cfg.meta_tokens) // MESH[1]
    for r in _reports(world):
        got = r["steps"][STEP[f"stream_{family}"]]
        assert got == {"prefill": [(b, s, cfg.d_model)], "decode": [(b, 1, cfg.d_model)],
                       "loss": [(b, s, cfg.d_model)]}, (family, r["coords"], got)


def test_vocab_parallel_loss_matches_the_plain_loss(world):
    """``common.chunked_softmax_xent`` on each rank's rows and block of
    positions and its block of a 96-word head (the max over the ranks, the
    log-sum-exp's sum and the gold logit summed over the model axis) against
    ``common.softmax_xent_plain`` in one process: the loss within float32
    rounding (rtol 1e-6) and the gradients of x and the head within 2^-8
    of their largest element (x's gradient rounds to bf16)."""
    x, head, labels, mask = _xent_inputs()
    xx, hh = torch.as_tensor(x).requires_grad_(), torch.as_tensor(head).requires_grad_()
    want = tC.softmax_xent_plain(xx, hh, torch.as_tensor(labels), torch.as_tensor(mask))
    gx, gh = torch.autograd.grad(want, [xx, hh])
    reports = _reports(world)
    step = STEP["xent"]
    for r in reports:
        np.testing.assert_allclose(r["steps"][step]["loss"], float(want.detach()), rtol=1e-6)
    got_x = _rows(reports, step, lambda s: s["grads"]["x"])
    np.testing.assert_allclose(got_x, gx.numpy(), rtol=0, atol=2.0**-8 * float(gx.abs().max()))
    got_h = _assemble(reports, step, "head", types.SimpleNamespace(shape=head.shape),
                      key=lambda s: s["grads"]["head"],
                      sharding=lambda m: ctx.sharding_for(m, (None, "tensor"), head.shape))
    np.testing.assert_allclose(got_h, gh.numpy(), rtol=0, atol=2.0**-8 * float(gh.abs().max()))


# ------------------------------------------------ the SSM families on 1 x 4


SSM_FAULT_CASES = [(arch, kind) for arch, faults in chip_smoke.LMM_SSM_FAULTS.items() for kind, _ in faults]


def _ssm_steps(arch: str) -> range:
    """The steps of ``arch``'s served run and of its faults in the 1 x 4 job."""
    i = 0
    for a, kinds in chip_smoke.LMM_SSM_FAULTS.items():
        if a == arch:
            return range(i, i + 1 + len(kinds))
        i += 1 + len(kinds)
    raise KeyError(arch)


@pytest.fixture(scope="module")
def world14(tmp_path_factory):
    """The 1 x 4 world of the card's SSM serving cases at smoke size, started
    in the background, and the one-process references it is held to."""
    d = tmp_path_factory.mktemp("lm_mesh14")
    refs = {arch: chip_smoke.ssm_serve_reference(torch.device("cpu"), arch, True, str(d))
            for arch in chip_smoke.LMM_SSM_PROMPT}
    steps = []
    for arch, ref in refs.items():
        def served(decode, ref=ref, arch=arch):
            return dict(arch=arch, smoke=True, seed=chip_smoke.SEED, prompts=ref["prompts"], max_len=ref["max_len"],
                        decode=decode, feed=ref["tokens"][:, :decode])

        steps.append(("serve", served(chip_smoke.LMM_SSM_STEPS)))
        steps += [("planted", dict(kind=kind, op="serve", **served(decode)))
                  for kind, decode in chip_smoke.LMM_SSM_FAULTS[arch]]
    job = lm_mesh_job.LMMeshJob(mesh=chip_smoke.LMM_SSM_SERVE_MESH, steps=tuple(steps), device="cpu")
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(tmesh.spawn, lm_mesh_ranks.run, 4, store_dir=str(d / "store"), args=(job,), timeout_s=240)
    yield {"future": fut, "refs": refs}
    pool.shutdown(wait=True)


def _ssm_reports(world14, arch: str) -> list:
    """Each rank's reports of ``arch``'s cases as ``chip_smoke.lm_mesh_rank``
    gives them: the served run's, then each fault's."""
    reports = world14["future"].result(timeout=600)
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    return [[{"steps": [r["steps"][i]]} for i in _ssm_steps(arch)] for r in reports]


@pytest.mark.parametrize("arch", list(chip_smoke.LMM_SSM_PROMPT))
def test_ssm_serving_on_1x4_passes_the_card_checks(world14, arch):
    """The card's checks of the served run on 1 x 4 (every pass within the
    tolerance of the one-process reference, the ranks' tokens equal, held
    bytes) and of its planted faults (each caught) all pass at smoke size;
    the cache's positions split over the 4 ranks where the model attends."""
    ref = world14["refs"][arch]
    checks, reading = chip_smoke.ssm_serve_results(ref, _ssm_reports(world14, arch), on_card=False)
    assert [m for ok, m in checks if not ok] == []
    assert reading["seq_blocks"] == (4 if ref["cfg"].family == "hybrid" else None)
    assert max(max(e) for e in reading["logits_max_abs_err"]) <= ref["tol"]


@pytest.mark.parametrize("arch,kind", SSM_FAULT_CASES)
def test_each_planted_ssm_fault_moves_the_logits_past_the_card_tolerance(world14, arch, kind):
    ref = world14["refs"][arch]
    fi, decode = next((i, d) for i, (k, d) in enumerate(chip_smoke.LMM_SSM_FAULTS[arch]) if k == kind)
    n = decode + 1
    reports = _ssm_reports(world14, arch)
    got, _ = chip_smoke.global_passes([r[1 + fi]["steps"][0] for r in reports], n, chip_smoke.LMM_SSM_BATCH)
    _, reading = chip_smoke.served_checks(kind, ref["logits"][:n], None, got, None, ref["tol"], ref["cfg"])
    assert chip_smoke.fault_caught(reading), reading
    assert max(max(e) for e in reading["logits_max_abs_err"]) > ref["tol"]


def _routes(top_e, top_p, n_experts: int = 4) -> list:
    """One layer's routes (``moe.routes_table``'s form) of rows whose read
    token took ``top_e[r][0]`` (top_k 1), its router's top-2 ``top_p[r]``."""
    b = len(top_e)
    used = np.zeros((b, 1, n_experts), bool)
    for r, e in enumerate(top_e):
        used[r, -1, e[0]] = True
    return [dict(used=used, top_p=np.asarray(top_p, np.float32)[:, None], top_e=np.asarray(top_e)[:, None],
                 dropped=0)]


@pytest.mark.parametrize("case", ["excused_only", "alike_row", "flip_past_tie"])
def test_a_fault_seen_only_on_excused_row_passes_is_missed(case):
    """A planted fault counts as caught only where a check of a row-pass
    that is not excused fails: its routes alike and its logits past the
    tolerance, or its routes differing past a near tie. Logits far off on
    row-passes whose flip is a near tie (excused), with too few row-passes
    alike for the run's own check, are a miss."""
    cfg = types.SimpleNamespace(top_k=1)
    ref_logits = [np.zeros((2, 8), np.float32)]
    ref_routes = [_routes([[0, 1], [2, 3]], [[0.50, 0.49], [0.50, 0.48]])]
    got_logits = [np.full((2, 8), 3.0, np.float32)]  # every row far off
    if case == "excused_only":  # both rows took the runner-up, each at a near tie
        got_routes = [_routes([[1, 0], [3, 2]], [[0.50, 0.49], [0.50, 0.48]])]
    elif case == "alike_row":  # row 1 routes alike
        got_routes = [_routes([[1, 0], [2, 3]], [[0.50, 0.49], [0.50, 0.48]])]
    else:  # row 1 took its runner-up though its reference had no near tie
        ref_routes = [_routes([[0, 1], [2, 3]], [[0.50, 0.49], [0.90, 0.05]])]
        got_routes = [_routes([[1, 0], [3, 2]], [[0.50, 0.49], [0.90, 0.05]])]
    checks, reading = chip_smoke.served_checks("t", ref_logits, ref_routes, got_logits, got_routes, 0.1, cfg)
    failed = [m for ok, m in checks if not ok]
    if case == "excused_only":
        # the run's own check fails (no row-pass routes alike), which counted as a catch before
        assert failed and all("row-passes route as one process does" in m for m in failed)
        assert not chip_smoke.fault_caught(reading)
    else:
        assert chip_smoke.fault_caught(reading)
        assert "row 1" in reading["catches"][0]
