"""AdamW with global-norm clipping and a warmup+cosine schedule.

Counterpart of ``repro.optim.adamw``: the same :class:`AdamWConfig`,
schedule, moment storage and update, over trees of tensors (nested dicts
in the JAX package's layout). Moments are float32, or with
``state_bits=8`` blockwise-quantized ``{"q", "s"}`` dicts: int8 for m,
uint8 of the fourth root for v, one float32 scale per block of
``q_block`` along the first axis that splits into such blocks, and the
JAX package's shapes, so a checkpoint crosses between the packages.

The update runs under ``torch.no_grad()`` and writes the parameters and
the moments in place (the tensors the caller holds are the new ones).
Layer-stacked leaves are updated one layer slice at a time, as the JAX
package's ``lax.map`` does, so the float32 temporaries are one layer's.

Where XLA compiles a float operation into another form than the one
written, this module writes XLA's form, so that the quantized moments
are the JAX package's integers: a division by a constant is a multiply by
its float32 reciprocal, ``u**4`` is ``(u*u)*(u*u)``, and XLA:CPU contracts
the moments' ``b1 * m + (1 - b1) * g`` into one fused multiply-add,
``fma(b1, m, (1 - b1) * g)`` (:func:`fma`). Where XLA fuses a moment into
its block's max reduction it may contract it otherwise, so a block scale
can differ from the JAX package's by an ulp. The parameter update itself is
written plainly: it need not be bit-exact, and its schedule's ``pow``
differs from XLA's by an ulp anyway.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0
    state_bits: int = 32  # 8 => blockwise-int8 moments (bitsandbytes-style)
    q_block: int = 128  # quantization block along the quantized axis


# ---------------------------------------------------- 8-bit moment storage
def quant_axis(shape: tuple, block: int) -> int | None:
    """First axis evenly divisible into ``block`` chunks (None = keep f32)."""
    for i, s in enumerate(shape):
        if s >= block and s % block == 0:
            return i
    return None


def _blocks(x: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    nb = x.shape[axis] // block
    return x.reshape(x.shape[:axis] + (nb, block) + x.shape[axis + 1 :])


def quantize_moment(x: torch.Tensor, block: int, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along ``axis`` (for m)."""
    xb = _blocks(x, block, axis)
    scale = torch.amax(xb.abs(), dim=axis + 1) * _F32_RECIP_127 + 1e-20
    q = torch.clamp(torch.round(xb / scale.unsqueeze(axis + 1)), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_moment(q: torch.Tensor, scale: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    xb = _blocks(q, block, axis).float() * scale.unsqueeze(axis + 1)
    return xb.reshape(q.shape)


def quantize_moment_pos(x: torch.Tensor, block: int, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise fourth-root-compressed uint8 quantization for the
    nonnegative second moment: linear int8 collapses small v entries to 0,
    the fourth-root map keeps about ten orders of magnitude within a
    block."""
    xb = _blocks(x, block, axis)
    vmax = torch.amax(xb, dim=axis + 1) + 1e-30
    u = torch.pow(xb / vmax.unsqueeze(axis + 1), 0.25)
    q = torch.clamp(torch.round(u * 255.0), 0, 255).to(torch.uint8)
    return q.reshape(x.shape), vmax


def dequantize_moment_pos(q: torch.Tensor, vmax: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    u = _blocks(q, block, axis).float() * _F32_RECIP_255
    u2 = u * u  # u**4 as XLA's integer power computes it: (u*u)*(u*u)
    return (u2 * u2 * vmax.unsqueeze(axis + 1)).reshape(q.shape)


def _f32(x: float) -> float:
    """The float32 nearest ``x``, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


_F32_RECIP_127 = _f32(1.0 / 127.0)
_F32_RECIP_255 = _f32(1.0 / 255.0)


def fma(a: float | torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once, as a fused multiply-add (the
    form XLA:CPU compiles it into); ``a`` a float32 tensor or a Python
    float taken at float32. The product of two float32 values is exact in
    float64, so only the sum rounds twice (to float64, then float32), which
    differs from one rounding only when the float64 sum lands exactly on a
    float32 tie."""
    a64 = a.double() if isinstance(a, torch.Tensor) else _f32(a)
    return (b.double() * a64 + c.double()).float()


class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor  # () int32


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup to
    ``peak_lr``, then cosine decay to ``min_lr_frac`` of it; float32."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * (step + 1.0) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    """The leaves of nested dicts (keys sorted, as ``jax.tree`` orders
    them) and lists; None leaves (gradients of unread parameters) kept."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _moment_zeros(p: torch.Tensor, cfg: AdamWConfig, signed: bool):
    ax = quant_axis(tuple(p.shape), cfg.q_block) if cfg.state_bits == 8 else None
    if ax is not None:
        q = torch.zeros(p.shape, dtype=torch.int8 if signed else torch.uint8, device=p.device)
        sshape = p.shape[:ax] + (p.shape[ax] // cfg.q_block,) + p.shape[ax + 1 :]
        return {"q": q, "s": torch.zeros(sshape, dtype=torch.float32, device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params: dict, cfg: AdamWConfig | None = None) -> AdamWState:
    cfg = cfg or AdamWConfig()
    dev = _leaves(params)[0].device
    return AdamWState(
        _tree_map(lambda p: _moment_zeros(p, cfg, True), params),
        _tree_map(lambda p: _moment_zeros(p, cfg, False), params),
        torch.zeros((), dtype=torch.int32, device=dev),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves in the
    JAX package's order (dict keys sorted), added one after another."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


def _is_moment_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or (isinstance(x, dict) and set(x) == {"q", "s"})


def _moment_leaves(tree) -> list:
    if _is_moment_leaf(tree):
        return [tree]
    return [x for k in sorted(tree) for x in _moment_leaves(tree[k])]


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict) -> tuple[dict, AdamWState, dict]:
    """One AdamW step: clip by the global norm, update every leaf in place.

    ``grads`` mirrors ``params``; a leaf whose gradient is None (the loss
    never reads it, as hubert's ``embed``) counts as a zero gradient, as
    ``jax.grad`` gives one, so it is still decayed and its moments still
    decay. Returns ``(params, state, {"grad_norm", "lr"})``; ``params`` and
    the moments are the tensors given, written in place."""
    p_flat = _leaves(params)
    g_flat = [g if g is not None else torch.zeros_like(p) for g, p in zip(_leaves(grads), p_flat)]
    m_flat, v_flat = _moment_leaves(state.m), _moment_leaves(state.v)
    if not len(p_flat) == len(g_flat) == len(m_flat) == len(v_flat):
        raise ValueError("params, grads and the moments must have the same leaves")
    gnorm = global_norm(g_flat)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device), step.float())
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device), step.float())

    def upd(p, g, m, v):
        quantized = isinstance(m, dict)
        if quantized:
            ax = quant_axis(tuple(p.shape), cfg.q_block)
            mf = dequantize_moment(m["q"], m["s"], cfg.q_block, ax)
            vf = dequantize_moment_pos(v["q"], v["s"], cfg.q_block, ax)
        else:
            mf, vf = m, v
        gf = g.float() * scale
        mf = fma(cfg.b1, mf, (1 - cfg.b1) * gf)
        vf = fma(cfg.b2, vf, (1 - cfg.b2) * torch.square(gf))
        mh = mf / b1c
        vh = vf / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        if quantized:
            for dst, (q, s) in ((m, quantize_moment(mf, cfg.q_block, ax)), (v, quantize_moment_pos(vf, cfg.q_block, ax))):
                dst["q"].copy_(q)
                dst["s"].copy_(s)
        else:
            m.copy_(mf)
            v.copy_(vf)

    def slice_of(x, i):
        return {k: t[i] for k, t in x.items()} if isinstance(x, dict) else x[i]

    for p, g, m, v in zip(p_flat, g_flat, m_flat, v_flat):
        if p.dim() >= 3 and p.shape[0] <= 512:
            # layer-stacked matrices: one layer slice at a time, so the
            # float32 dequantize/update temporaries are per layer
            for i in range(p.shape[0]):
                upd(p[i], g[i], slice_of(m, i), slice_of(v, i))
        else:
            upd(p, g, m, v)
    return params, AdamWState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}

