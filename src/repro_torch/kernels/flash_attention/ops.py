"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``,
kernel F).

Replaces the JAX package's ``flash_attention_pallas``
(``repro/kernels/flash_attention/flash_attention.py``) and its padding
wrapper ``ops.flash_attention``. The layout is the JAX one, q
``(B, Hq, Sq, dh)`` and k, v ``(B, Hkv, Skv, dh)``, but any strides with a
contiguous last axis are taken as they are, so the model passes transposed
views of its ``(B, S, H, dh)`` activations and KV cache without a copy, and
the output keeps q's strides. ``q_offset`` and ``kv_len`` are per batch row
(an int applies to every row): one launch serves a prefill and a batched
decode step whose rows have their own cache lengths. A CPU tensor takes
the plain version (``ref.attention_ref``); a CUDA tensor launches the
kernel or raises.

The kernel has no backward pass (nor has the Pallas kernel it replaces),
so a CUDA input that requires gradients while grad mode is on is refused:
its output would carry no gradient. The loss path takes
``models.common.chunked_attention_train`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

DH_MAX = 256  # FA_DH_MAX in flash_attention.cu
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_launch": [_build.PTR] * 4 + [_build.INT] * 6 + [_I64] * 12
    + [ctypes.c_float] + [_build.INT] * 3 + [_build.PTR] * 3,
}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset=0,
    kv_len=None,
    sink: int = 0,
) -> torch.Tensor:
    """Attention of q ``(B, Hq, Sq, dh)`` over k, v ``(B, Hkv, Skv, dh)``
    with q-head ``h`` reading kv-head ``h // (Hq / Hkv)``; query row ``i``
    of batch row ``b`` sits at ``q_offset[b] + i`` and sees keys below
    ``kv_len[b]`` (default Skv), at or before it when ``causal``, and within
    ``window`` of it or among the first ``sink`` keys (attention sinks; no
    effect without a window). Float32 accumulation; output in q's dtype.
    The kernel takes bfloat16, the model path's dtype; the plain version on
    a CPU tensor takes any float dtype."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len, q_offset=q_offset, sink=sink)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, Hq, Sq, dh) and k, v (B, Hkv, Skv, dh) expected, got"
                         f" {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward pass: its inputs require gradients, and its output"
                           " would carry none; differentiate models.common.chunked_attention_train instead")
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hkv < 1 or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not 1 <= dh <= DH_MAX:
        raise ValueError(f"head_dim {dh} outside [1, {DH_MAX}]")
    if not torch.bfloat16 == q.dtype == k.dtype == v.dtype:
        raise ValueError(f"the kernel takes bfloat16 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head_dim axis of q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be at least 1")
    if sink < 0:
        raise ValueError(f"sink={sink} must not be negative")
    qo = ref.per_row(q_offset, b, q.device)
    kl = ref.per_row(skv if kv_len is None else kv_len, b, q.device)
    out = torch.empty_like(q)  # q's strides, so a transposed view stays one
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        1.0 / dh**0.5, int(causal), 0 if window is None else int(window), 0 if window is None else int(sink),
        qo.data_ptr(), kl.data_ptr(), _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_attention")
    return out
