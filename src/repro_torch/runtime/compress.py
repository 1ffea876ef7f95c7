"""Gradient compression at the gradient boundary: int8 with error
feedback (the counterpart of ``repro.runtime.compress``).

Each leaf's gradient plus its carried residual is quantized to int8 with
one per-leaf scale and dequantized; what the quantization lost is carried
to the next step (EF-SGD / 1-bit-Adam style). On one card there is no
all-reduce to shrink, so the compression changes the numbers the
optimizer sees, exactly as the JAX package's does, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import _F32_RECIP_127, fma


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One scale for the whole tensor: ``amax / 127``, which XLA compiles
    as a multiply by the float32 reciprocal."""
    amax = torch.amax(x.abs()) + 1e-12
    scale = amax * _F32_RECIP_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: dict) -> dict:
    return {k: init_error_feedback(p) if isinstance(p, dict) else torch.zeros(p.shape, device=p.device)
            for k, p in params.items()}


def compress_grads(grads: dict, ef: dict) -> tuple[dict, dict]:
    """Returns (compressed-dequantized grads, new error-feedback state)."""
    newg, newe = {}, {}
    for k, g in grads.items():
        if isinstance(ef[k], dict):
            newg[k], newe[k] = compress_grads(g, ef[k])
            continue
        gf = g.float() + ef[k]
        q, scale = quantize_int8(gf)
        # the residual gf - q * scale, one fused multiply-add as XLA:CPU
        # compiles it
        newg[k], newe[k] = dequantize_int8(q, scale), fma(-scale, q.float(), gf)
    return newg, newe
