"""The LM families under a mesh, run on every rank: serving, the step-0
gradients and training through ``launch.train``.

What :func:`repro_torch.launch.mesh.spawn` runs for the LM families on one
host::

    job = LMMeshJob(mesh=(1, 4), steps=(
        ("serve", dict(arch="phi3.5-moe-42b-a6.6b", overrides={"n_layers": 8},
                       prompts="prompts.npy", max_len=528, decode=8)),
    ))
    reports = spawn(run, 4, store_dir=tmp, args=(job,))

Each rank builds ``make_local_mesh(*job.mesh)`` and runs the steps under
``ctx.use_mesh``, each pass started on a barrier and timed to its end on
the device:

* ``("serve", {arch, smoke, overrides, seed, prompts, max_len, decode,
  feed, routes})``: the model's weights (this rank's blocks, drawn whole
  leaf by leaf and cut, one rank at a time behind a barrier, and kept for
  the next serve step of the same weights), prefill of this rank's rows
  of the global ``prompts`` (a ``.npy`` path or an array), then
  ``decode`` greedy steps, or steps fed with the tokens of ``feed`` (B,
  decode) when given. Reports the
  logits of each pass (this rank's rows), the tokens, each pass's seconds,
  kernel launches, ``ctx.TRAFFIC`` and the bytes of the residual stream a
  rank holds between blocks (``stream_bytes``, ``common.STREAM``), and
  peak device memory; with ``routes``, each pass's moe routes as
  ``moe.ROUTES`` records them.
* ``("grads", {arch, smoke, overrides, seed, rows, compare})``: the
  training masters (drawn on every rank at once), the loss and the reduced
  gradients (``train.loop``) of the global ``rows``, each held here, block
  by block, against the one-process ``grads`` saved at ``compare`` (a
  ``torch.save``d dict with ``grads``, ``gaps`` and ``loss``); only
  per-leaf readings come back, with the pass's ``ctx.TRAFFIC`` and
  ``stream_bytes``.
* ``("train", {arch, smoke, overrides, steps, batch, seq, lr, ckpt_dir,
  ckpt_every, compare_moments})``: ``launch.train.train`` under the mesh;
  the history, the bytes held on the card after the masters' draw and
  after the first step (masters and moments) beside their blocks' bytes
  under the JAX spec, and with ``compare_moments`` (a path of some
  one-process moments after one step of the same run) each of those
  leaves' blocks held against the matching block, read after the first
  step; the run's ``ctx.TRAFFIC`` and ``stream_bytes``.

:func:`run` takes the table of steps as an argument, so another rank
program can add its own steps to :data:`OPS`.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.models import common as C
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as PM
from repro_torch.optim import adamw
from repro_torch.sharding import ctx
from repro_torch.train import loop as tl


@dataclasses.dataclass(frozen=True)
class LMMeshJob:
    """What every rank of an LM mesh run does (see the module docstring)."""

    mesh: tuple[int, int]  # (data, model)
    steps: tuple = ()
    device: str | None = None  # the rank's device (the card unless told otherwise)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cfg(arch: str, smoke: bool = False, overrides: dict | None = None):
    return dataclasses.replace(configs.get(arch, smoke=smoke), **(overrides or {}))


def _array(a) -> np.ndarray:
    return np.load(a) if isinstance(a, str) else np.asarray(a)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _Timer:
    """A pass started on a barrier, timed to its end on the device, with its
    kernel launches, transport bytes and the largest stream a block took
    (``common.STREAM``: the bytes of the residual stream a rank holds
    between blocks)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        ctx.barrier(self.mesh)
        _sync(self.mesh.device)
        _build.reset_launches()
        self.traffic = dict(ctx.TRAFFIC)
        C.STREAM = []
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.mesh.device)
        self.seconds = time.perf_counter() - self.t0
        self.launches = dict(_build.LAUNCHES)
        self.moved = {k: ctx.TRAFFIC[k] - self.traffic[k] for k in ctx.TRAFFIC}
        noted, C.STREAM = C.STREAM, None
        self.stream_bytes = max((b for _, b in noted), default=0)
        return False

    def record(self) -> dict:
        return {"seconds": self.seconds, "launches": self.launches, "traffic": self.moved,
                "stream_bytes": self.stream_bytes}


def _allocated(dev: torch.device) -> int | None:
    """The bytes of live tensors on the card (None on the CPU), cuBLAS's
    workspaces freed first: they are the library's, not the model's, and
    an earlier matmul leaves them allocated."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated(dev)


def _since(base: int | None, dev: torch.device) -> int | None:
    """The bytes allocated on the card since ``base`` (None on the CPU)."""
    return None if base is None else _allocated(dev) - base


_SERVED: dict = {}  # the last serving weights drawn on this rank and the bytes they hold, by what they depend on


def _serving_weights(mesh, model, cfg, seed: int):
    """``model.init(seed)`` on this rank, drawn one rank at a time (the
    others wait behind a barrier, so one whole leaf is live at a time:
    phi3.5-moe's stacked ``e_gate`` is 13 GB in float32 at 8 layers), and
    kept for the next serve step of the same weights (the combine and the
    capacity do not change them) -> (the weights, the bytes on the card
    once drawn)."""
    key = (dataclasses.replace(cfg, moe_impl="gather", capacity_factor=1.0), seed, tuple(mesh.shape.items()))
    if key not in _SERVED:
        _SERVED.clear()
        base = _allocated(mesh.device)
        for r in range(mesh.size):
            if mesh.rank == r:
                _SERVED[key] = model.init(seed, mesh.device)
                _sync(mesh.device)
                if mesh.device.type == "cuda":
                    torch.cuda.empty_cache()
            ctx.barrier(mesh)
        _SERVED[key] = (_SERVED[key], _since(base, mesh.device))
    return _SERVED[key]


def serve(mesh, arch, smoke=False, overrides=None, seed=0, prompts=None, max_len=None, decode=0,
          feed=None, routes=False) -> dict:
    cfg = _cfg(arch, smoke, overrides)
    model = api.build_model(cfg)
    dev = mesh.device
    prompts = _array(prompts)
    rows = ctx.sharding_for(mesh, ("batch", None), prompts.shape)
    feed = None if feed is None else rows.block(_array(feed))
    params, held = _serving_weights(mesh, model, cfg, seed)
    toks = torch.as_tensor(np.array(rows.block(prompts)), device=dev)
    mod = api._family_module(cfg)
    out = {"rows": [int(x) for x in _row_range(rows, prompts.shape[0])], "passes": [], "held_bytes": held,
           "spec_bytes": PM.block_bytes(PM.param_structs(mod.storage_defs(model.defs), mesh))}

    def timed(fn):
        moe_mod.ROUTES = [] if routes else None
        try:
            with _Timer(mesh) as t:
                logits, cache = fn()
        finally:
            noted, moe_mod.ROUTES = moe_mod.ROUTES, None
        out["passes"].append(dict(t.record(), logits=_np(logits), **({"routes": noted} if routes else {})))
        return logits, cache

    with torch.no_grad():
        logits, cache = timed(lambda: model.prefill(params, {"tokens": toks}, max_len))
        tokens = []
        for i in range(decode):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            if feed is not None:
                nxt = torch.as_tensor(np.array(feed[:, i : i + 1]), device=dev, dtype=torch.int32)
            tokens.append(_np(nxt)[:, 0])
            logits, cache = timed(lambda: model.decode_step(params, cache, nxt))
    out["tokens"] = np.stack(tokens, 1) if tokens else None
    out["seq_blocks"] = cache.get("seq_blocks")
    return out


def _row_range(rows, n: int) -> range:
    idx = rows.block(np.arange(n)[:, None])[:, 0]
    return range(int(idx[0]), int(idx[-1]) + 1)


def step0_grads(mesh, arch, smoke=False, overrides=None, seed=0, rows=None):
    """The training masters and the loss and reduced gradients of the
    global ``rows`` under ``mesh`` -> (model, leaf names, this rank's
    gradient blocks, the report: seconds, launches, traffic, loss and
    gradient norm)."""
    cfg = _cfg(arch, smoke, overrides)
    model = api.build_model(cfg)
    dev = mesh.device
    rows = _array(rows)
    block = ctx.sharding_for(mesh, ("batch", None), rows.shape).block(rows)
    params = model.init_masters(seed, dev)
    batch = {"tokens": torch.as_tensor(np.array(block), device=dev)}
    with _Timer(mesh) as t:
        loss, gl = tl._value_and_grad(model, params, batch, 1.0 / mesh.size)
        gnorm = tl.mesh_grads(mesh, model, gl)
    return model, list(_flat(params)), gl, dict(t.record(), loss=float(loss), grad_norm=float(gnorm))


def grads(mesh, arch, smoke=False, overrides=None, seed=0, rows=None, compare=None) -> dict:
    model, names, gl, out = step0_grads(mesh, arch, smoke, overrides, seed, rows)
    out["check"] = _compare_grads(mesh, model, names, gl, compare)
    return out


def _grad_stats(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float, float]:
    """(max |a - b|, max |b|, cosine) in float64, one layer slice at a time."""
    err = scale = dot = na = nb = 0.0
    for x, y in zip(*((t.unbind(0) if t.dim() >= 3 else (t,)) for t in (a, b))):
        x, y = x.double(), y.double()
        err, scale = max(err, float((x - y).abs().max())), max(scale, float(y.abs().max()))
        dot, na, nb = dot + float((x * y).sum()), na + float((x * x).sum()), nb + float((y * y).sum())
    return err, scale, dot / max((na * nb) ** 0.5, 1e-300)


def _compare_grads(mesh, model, names, gl, path: str) -> dict:
    """This rank's reduced gradients against the matching blocks of the
    one-process ones saved at ``path``: per leaf (max error, the leaf's
    largest element, cosine, the one-process gap to another float32 order)."""
    ref = torch.load(path, mmap=True)
    shard = _flat(model.defs)
    out = {}
    for n, g in zip(names, gl):
        want = PM.sharding_of(shard[n], mesh).block(ref["grads"][n]).to(g.device)
        out[n] = _grad_stats(g, want) + (ref["gaps"][n],)
    return out


def train(mesh, arch, smoke=False, overrides=None, steps=2, batch=4, seq=64, lr=1e-3, ckpt_dir="",
          ckpt_every=25, compare_moments=None) -> dict:
    from repro_torch.launch import train as launch_train

    cfg = _cfg(arch, smoke, overrides)
    model = api.build_model(cfg)
    base = _allocated(mesh.device)
    with ctx.use_mesh(mesh):
        params = model.init_masters(0, mesh.device)
        held = {"masters": _since(base, mesh.device)}
        opt_structs = tl.opt_state_structs(model, mesh, adamw.AdamWConfig(state_bits=cfg.opt_state_bits))
    spec = {"masters": PM.block_bytes(model.param_structs(mesh))}
    spec["state"] = spec["masters"] + PM.block_bytes(opt_structs)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    check, marks = {}, []  # (a step's end, the seconds the check after it took)

    def on_step(i, params, state):
        _sync(mesh.device)
        end = time.perf_counter()
        if i == 0:
            held["state"] = _since(base, mesh.device)  # masters and moments, the gradients freed
            if compare_moments is not None:
                check.update(_compare_moments(mesh, model, state, compare_moments))
        marks.append((end, time.perf_counter() - end))

    with _Timer(mesh) as t:
        history, params, state = launch_train.train(
            cfg, steps=steps, batch=batch, seq=seq, lr=lr, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, mesh=mesh,
            params=params, log=lambda *_: None, on_step=on_step)
    out = dict(t.record(), history=history, check=check, held_bytes=held, spec_bytes=spec)
    starts = [t.t0] + [e + c for e, c in marks[:-1]]
    out["step_ms"] = [(e - s0) * 1e3 for (e, _), s0 in zip(marks, starts)]
    out["params_digest"] = {n: _digest(p) for n, p in _flat(params).items()}
    if mesh.device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    return out


def _is_moment(v) -> bool:
    return isinstance(v, dict) and set(v) == {"q", "s"}


def _flat(tree: dict, prefix: str = "") -> dict:
    """``name -> leaf`` of nested dicts, keys sorted (``layers/wq``); an
    8-bit moment's ``{"q", "s"}`` is one leaf, as is a ``PDef``."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) and not _is_moment(v) else {f"{prefix}{k}": v})
    return out


def _moment_values(m) -> torch.Tensor:
    """A moment leaf as float32 values: 8-bit ``{"q", "s"}`` dequantized
    along the axis its scales shrink."""
    if not isinstance(m, dict):
        return m.float()
    q, s_ = m["q"], m["s"]
    ax = next(i for i, (a, b) in enumerate(zip(q.shape, s_.shape)) if a != b)
    deq = adamw.dequantize_moment if q.dtype == torch.int8 else adamw.dequantize_moment_pos
    return deq(q, s_.float(), q.shape[ax] // s_.shape[ax], ax)


def _compare_moments(mesh, model, state, path: str) -> dict:
    """The moments of each leaf the one-process file at ``path`` holds
    (``m/<leaf>`` and ``v/<leaf>``, 8-bit ones as ``{"q", "s"}``) against
    the matching block of them (``train.loop.opt_state_structs``'s
    layout): per leaf (max |m - m_ref|, max |m_ref|) and the same of
    sqrt(v), each dequantized."""
    ref = torch.load(path, mmap=True)
    structs = tl.opt_state_structs(model, mesh, adamw.AdamWConfig(state_bits=model.cfg.opt_state_bits))
    out = {}
    for which, tree, st in (("m", state.m, structs.m), ("v", state.v, structs.v)):
        layout = _flat(st)
        for n, leaf in _flat(tree).items():
            if f"{which}/{n}" not in ref:
                continue
            got = _moment_values(leaf)
            want_raw, sh = ref[f"{which}/{n}"], layout[n]
            want_raw = {k: sh[k].sharding.block(v).to(got.device) for k, v in want_raw.items()} \
                if isinstance(want_raw, dict) else sh.sharding.block(want_raw).to(got.device)
            want = _moment_values(want_raw)
            if which == "v":
                got, want = got.sqrt(), want.sqrt()
            out[f"{which}/{n}"] = [float((got - want).abs().max()), float(want.abs().max())]
    return out


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


OPS = {"serve": serve, "grads": grads, "train": train}


def run(job: LMMeshJob, ops: dict | None = None) -> dict:
    """Run ``job`` on this rank (every rank of the process group calls it),
    each step looked up in ``ops`` (:data:`OPS` by default) -> this rank's
    report."""
    ops = OPS if ops is None else ops
    mesh = mesh_mod.make_local_mesh(*job.mesh, device=job.device)
    report = {"rank": mesh.rank, "coords": mesh.coords, "steps": []}
    for op, kw in job.steps:
        if op not in ops:
            raise ValueError(f"unknown LM mesh job step {op!r}")
        with ctx.use_mesh(mesh):
            report["steps"].append(ops[op](mesh, **kw))
    if mesh.device.type == "cuda":
        report["peak_mem_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    return report
