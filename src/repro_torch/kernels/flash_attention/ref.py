"""Plain PyTorch version of the flash-attention kernel
(``csrc/flash_attention.cu``): a port of ``repro.kernels.flash_attention.ref``.

Exact softmax attention through float32, cast once to q's dtype, with
GQA, causal, sliding-window (with attention sinks) and kv-length masks.
``q_offset`` and
``kv_len`` are ints or per-row ``(B,)`` tensors, the kernel's calling
convention.
"""
from __future__ import annotations

import torch


def per_row(val, b: int, device) -> torch.Tensor:
    """An int or a ``()``/``(B,)`` tensor as a contiguous ``(B,)`` int32
    tensor on ``device``."""
    if isinstance(val, torch.Tensor):
        if val.dim() > 1 or (val.dim() == 1 and val.shape[0] != b):
            raise ValueError(f"per-row values must be () or ({b},), got {tuple(val.shape)}")
        return val.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(val), dtype=torch.int32, device=device)


def visible(b: int, sq: int, skv: int, *, causal: bool, window, q_offset, kv_len, device,
            sink: int = 0) -> torch.Tensor:
    """(B, Sq, Skv) bool: the keys each query row may see. With a window,
    the first ``sink`` keys stay visible to every row (attention sinks)."""
    q_pos = per_row(q_offset, b, device)[:, None] + torch.arange(sq, device=device)  # (B, Sq)
    k_pos = torch.arange(skv, device=device)
    ok = torch.ones((b, sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos[:, :, None]
    if window is not None:
        ok &= (k_pos > q_pos[:, :, None] - window) | (k_pos < sink)
    if kv_len is not None:
        ok &= k_pos < per_row(kv_len, b, device)[:, None, None]
    return ok


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, dh)
    k: torch.Tensor,  # (B, Hkv, Skv, dh)
    v: torch.Tensor,  # (B, Hkv, Skv, dh)
    *,
    causal: bool = True,
    window: int | None = None,
    kv_len=None,
    q_offset=0,
    sink: int = 0,
) -> torch.Tensor:
    """Query row i of batch row b sits at position ``q_offset[b] + i``; a
    row that sees no key gives zeros."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr)
    s = s / torch.tensor(float(dh), dtype=torch.float32, device=q.device).sqrt()
    allowed = visible(b, sq, skv, causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
                      device=q.device, sink=sink)
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows -> zeros
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
