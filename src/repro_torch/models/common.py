"""Transformer building blocks of the port (forward only).

Counterpart of the forward parts of ``repro.models.common``: matmuls take
bf16 operands, norms, rotary embeddings and softmax run in float32, and
each function returns its input's dtype, as in the JAX package. There is
no mesh: the sharding constraints and the context-parallel decode merge
have nothing to do on one card.

Both attention functions run the flash kernel (kernel F,
``kernels/flash_attention``) on a CUDA tensor. Their plain versions,
direct ports of ``chunked_attention``'s and ``_partial_attn_local``'s
arithmetic, run on a CPU tensor.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

COMPUTE_DTYPE = torch.bfloat16


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (S,) or (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (dh/2,)
    pos = positions if positions.dim() == 2 else positions[None, :]
    ang = (pos[:, :, None].float() * freqs)[:, :, None, :]  # (1|B, S, 1, dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hq, dh)
    k: torch.Tensor,  # (B, Skv, Hkv, dh)
    v: torch.Tensor,  # (B, Skv, Hkv, dh)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset=0,
    kv_len=None,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Online-softmax attention -> (B, Sq, Hq, dh) in q's dtype.

    ``q_offset`` and ``kv_len`` are ints or per-row ``(B,)`` tensors. On a
    CUDA tensor one flash-kernel launch computes it (``q_chunk`` is the
    plain version's chunking and has no effect there)."""
    if q.device.type == "cuda":
        out = fa_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
        )
        return out.transpose(1, 2)
    return _chunked_attention_plain(q, k, v, causal, window, q_offset, kv_len, q_chunk)


def _chunked_attention_plain(q, k, v, causal, window, q_offset, kv_len, q_chunk):
    """``repro.models.common.chunked_attention``'s arithmetic, one query
    chunk at a time (q scaled before the dot, scores masked to -inf, the row
    max clamped at -1e30, the sum at 1e-30)."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / (dh**0.5)
    q_chunk = min(q_chunk, sq)
    qf = (q.float() * scale).reshape(b, sq, hkv, group, dh)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(skv, device=q.device)
    qo = fa_ref.per_row(q_offset, b, q.device)
    kl = None if kv_len is None else fa_ref.per_row(kv_len, b, q.device)
    outs = []
    for c0 in range(0, sq, q_chunk):
        qc = qf[:, c0 : c0 + q_chunk]
        n = qc.shape[1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf)  # (B, hkv, g, qc, skv)
        q_pos = qo[:, None] + c0 + torch.arange(n, device=q.device)  # (B, qc)
        ok = torch.ones((b, n, skv), dtype=torch.bool, device=q.device)
        if causal:
            ok &= k_pos <= q_pos[:, :, None]
        if window is not None:
            ok &= k_pos > q_pos[:, :, None] - window
        if kl is not None:
            ok &= k_pos < kl[:, None, None]
        s = s.masked_fill(~ok[:, None, None], float("-inf"))
        m = torch.amax(s, dim=-1, keepdim=True).clamp_min(-1e30)  # fully masked rows
        p = torch.exp(s - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, vf) / l.clamp_min(1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, hq, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention_cp(
    q: torch.Tensor,  # (B, 1, Hq, dh)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, dh)
    v_cache: torch.Tensor,
    cur_len: torch.Tensor,  # () or (B,) int — number of valid cache positions
) -> torch.Tensor:
    """One query token per row over its first ``cur_len[b]`` cache
    positions -> (B, 1, Hq, dh). On a CUDA tensor: one flash-kernel launch
    with ``q_offset = cur_len - 1`` and ``kv_len = cur_len`` per row."""
    b, _, hq, dh = q.shape
    cl = fa_ref.per_row(cur_len, b, q.device)
    if q.device.type == "cuda":
        out = fa_ops.flash_attention(
            q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
            causal=False, q_offset=cl - 1, kv_len=cl,
        )
        return out.transpose(1, 2)
    return _decode_attention_plain(q, k_cache, v_cache, cl)


def _decode_attention_plain(q, k_cache, v_cache, cl):
    """``repro.models.common._partial_attn_local``'s arithmetic over the
    first ``cl[b]`` cache positions of each row (q scaled before the dot)."""
    b, _, hq, dh = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = 1.0 / (dh**0.5)
    qq = q[:, 0].reshape(b, hkv, group, dh).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qq, k_cache.float())
    ok = torch.arange(s_max, device=q.device)[None, :] < cl[:, None]  # (B, S_max)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, 1, hq, dh).to(q.dtype)


# ----------------------------------------------------------------- MLPs
def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor, kind: str) -> torch.Tensor:
    """The block's MLP; weights are used in bf16 (cast here if they are not
    held that way already)."""
    xc = x.to(COMPUTE_DTYPE)

    def w(name):
        return params[name].to(COMPUTE_DTYPE)

    if kind == "swiglu":
        g = xc @ w("w_gate")
        u = xc @ w("w_up")
        h = F.silu(g.float()).to(COMPUTE_DTYPE) * u
    elif kind == "relu2":  # nemotron squared-ReLU
        h = xc @ w("w_up")
        h = torch.square(F.relu(h.float())).to(COMPUTE_DTYPE)
    elif kind == "gelu":  # jax.nn.gelu's default is the tanh form
        h = xc @ w("w_up")
        h = F.gelu(h.float(), approximate="tanh").to(COMPUTE_DTYPE)
    else:
        raise ValueError(kind)
    return (h @ w("w_down")).to(x.dtype)


# ------------------------------------------------------------- embeddings
def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens.long()].to(COMPUTE_DTYPE)
