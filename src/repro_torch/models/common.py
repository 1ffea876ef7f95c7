"""Transformer building blocks of the port.

Counterpart of ``repro.models.common``: matmuls take bf16 operands, norms,
rotary embeddings and softmax run in float32, and each function returns
its input's dtype, as in the JAX package. Under an ambient mesh
(``sharding.ctx.use_mesh``) every function works on this rank's block:
:func:`whole` gathers a weight's ``fsdp`` and ``tensor`` blocks before
use (ZeRO), :func:`row_parallel` sums a tensor-parallel matmul's partial
products over the ``tensor`` axes, :func:`mlp_apply` takes either;
:func:`constrain` checks the JAX package's logical names and moves
nothing; :func:`chunked_softmax_xent` returns the global batch's loss
(numerator and token count summed over the batch axes);
:func:`decode_attention_cp` merges the partial softmax of the cache's
sequence blocks over the ``seq`` axes (context parallelism), with the JAX
package's fallback to local attention when the cache's length does not
split. An attention cache under a mesh carries ``"seq_blocks"``, the
number of blocks its sequence dim is cut into (:func:`seq_cut`), since a
block's length alone does not tell whether it is one.

Both inference attention functions run the flash kernel (kernel F,
``kernels/flash_attention``) on a CUDA tensor. Their plain versions,
direct ports of ``chunked_attention``'s and ``_partial_attn_local``'s
arithmetic, run on a CPU tensor. Kernel F has no backward pass (nor has
the Pallas kernel it replaces): the loss path takes
:func:`chunked_attention_train`, the plain arithmetic with a checkpoint
per query chunk, on every device, as the JAX package's training path
takes the XLA ``chunked_attention``.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain

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
    sink: int = 0,  # with a window, the first ``sink`` keys stay visible (meta tokens)
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
            causal=causal, window=window, q_offset=q_offset, kv_len=kv_len, sink=sink,
        )
        return out.transpose(1, 2)
    return _chunked_attention_plain(q, k, v, causal, window, q_offset, kv_len, q_chunk, sink=sink)


def _chunked_attention_plain(q, k, v, causal, window, q_offset, kv_len, q_chunk, remat=False, sink=0):
    """``repro.models.common.chunked_attention``'s arithmetic, one query
    chunk at a time (q scaled before the dot, scores masked to -inf, the row
    max clamped at -1e30, the sum at 1e-30; with a window, keys below
    ``sink`` stay visible). With ``remat`` each chunk runs
    under a checkpoint, so the backward pass recomputes its scores instead
    of holding every chunk's (``jax.checkpoint`` around the chunk body)."""
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

    def one_chunk(qc, c0: int):
        n = qc.shape[1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf)  # (B, hkv, g, qc, skv)
        if causal or window is not None or kl is not None:  # else every key is visible
            q_pos = qo[:, None] + c0 + torch.arange(n, device=q.device)  # (B, qc)
            ok = torch.ones((b, n, skv), dtype=torch.bool, device=q.device)
            if causal:
                ok &= k_pos <= q_pos[:, :, None]
            if window is not None:
                ok &= (k_pos > q_pos[:, :, None] - window) | (k_pos < sink)
            if kl is not None:
                ok &= k_pos < kl[:, None, None]
            s = s.masked_fill(~ok[:, None, None], float("-inf"))
        m = torch.amax(s, dim=-1, keepdim=True).clamp_min(-1e30)  # fully masked rows
        p = torch.exp(s - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, vf) / l.clamp_min(1e-30)
        return o.permute(0, 3, 1, 2, 4).reshape(b, n, hq, dh)

    chunks = [qf[:, c0 : c0 + q_chunk] for c0 in range(0, sq, q_chunk)]
    if remat and len(chunks) > 1:
        outs = [checkpoint(one_chunk, qc, i * q_chunk, use_reentrant=False) for i, qc in enumerate(chunks)]
    else:
        outs = [one_chunk(qc, i * q_chunk) for i, qc in enumerate(chunks)]
    return torch.cat(outs, dim=1).to(q.dtype)


def chunked_attention_train(
    q: torch.Tensor,  # (B, Sq, Hq, dh)
    k: torch.Tensor,  # (B, Skv, Hkv, dh)
    v: torch.Tensor,  # (B, Skv, Hkv, dh)
    *,
    causal: bool = True,
    window: int | None = None,
    sink: int = 0,  # with a window, the first ``sink`` keys stay visible (hymba's meta tokens)
    q_chunk: int = 512,
) -> torch.Tensor:
    """The differentiable form of :func:`chunked_attention` for the loss
    path, on every device: its plain arithmetic, each of several query
    chunks under a checkpoint (the JAX package's training attention)."""
    return _chunked_attention_plain(q, k, v, causal, window, 0, None, q_chunk, remat=True, sink=sink)


def decode_attention_cp(
    q: torch.Tensor,  # (B, 1, Hq, dh)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, dh), or this rank's seq block
    v_cache: torch.Tensor,
    cur_len: torch.Tensor,  # () or (B,) int — number of valid cache positions
    seq_blocks: int = 1,
) -> torch.Tensor:
    """One query token per row over its first ``cur_len[b]`` cache
    positions -> (B, 1, Hq, dh).

    Local form (no mesh, or a cache held whole, ``seq_blocks`` 1): on a
    CUDA tensor one flash-kernel launch with ``q_offset = cur_len - 1`` and
    ``kv_len = cur_len`` per row; on the CPU ``_partial_attn_local``'s
    arithmetic. Context-parallel form (the cache's sequence cut into
    ``seq_blocks`` over the mesh's ``seq`` axes): each rank computes the
    partial softmax statistics ``(m, l, acc)`` of its block, its positions
    offset by ``block index * block length``, then ``m`` is maxed, and
    ``l`` and ``acc`` rescaled and summed, over the ``seq`` axes (the JAX
    package's shard body; plain torch on every device, as the JAX
    package's is XLA code). The batch is the rank's block on both sides,
    as the JAX package's batch-spec rule keeps it."""
    b, _, hq, dh = q.shape
    cl = fa_ref.per_row(cur_len, b, q.device)
    if seq_blocks > 1:
        mesh = ctx.get_mesh()
        axis = _seq_axes(mesh)[0]
        s_loc = k_cache.shape[1]
        off = ctx.axis_index(mesh, axis) * s_loc
        m, l, acc = _partial_attn_local(q[:, 0], k_cache, v_cache, off, cl)
        g_m = ctx.pmax(mesh, axis, m)
        corr = torch.exp(m - g_m)
        both = ctx.psum(mesh, axis, torch.cat([l * corr, acc * corr], dim=-1))  # one collective for both sums
        g_l, g_acc = both[..., :1], both[..., 1:]
        out = g_acc / g_l.clamp_min(1e-30)
        return out.reshape(b, 1, hq, dh).to(q.dtype)
    if q.device.type == "cuda":
        out = fa_ops.flash_attention(
            q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
            causal=False, q_offset=cl - 1, kv_len=cl,
        )
        return out.transpose(1, 2)
    return _decode_attention_plain(q, k_cache, v_cache, cl)


def _seq_axes(mesh) -> tuple:
    return tuple(a for a in ctx.get_rules().seq if a in mesh.shape)


def seq_cut(max_len: int) -> tuple[int, int]:
    """(blocks, this rank's block) of an attention cache of ``max_len``
    positions under the ambient mesh: the ``seq`` axes' size when it
    divides ``max_len``, else one block (the JAX package's fallback rule);
    ``(1, 0)`` without a mesh."""
    mesh = ctx.get_mesh()
    if mesh is None:
        return 1, 0
    tp = _seq_axes(mesh)
    n = ctx.mesh_axis_size(*tp)
    if n == 1 or max_len % n:
        return 1, 0
    return n, ctx.axis_index(mesh, tp[0])


def cache_fill(dst: torch.Tensor, src: torch.Tensor, blocks: int, block: int) -> None:
    """Prefill's keys or values ``src`` (B, S, Hkv, dh), computed whole,
    into ``dst`` (B, S_max / blocks, Hkv, dh), this rank's block of the
    cache: the positions of the block that the prompt covers."""
    s_loc = dst.shape[1]
    lo = block * s_loc
    n = max(0, min(src.shape[1] - lo, s_loc))
    if n:
        dst[:, :n] = src[:, lo : lo + n].to(dst.dtype)


def cache_write(dst: torch.Tensor, new: torch.Tensor, cur: torch.Tensor, blocks: int = 1, block: int = 0) -> None:
    """Each row's new key or value ``new`` (B, Hkv, dh) at its position
    ``cur[b]`` of ``dst`` (B, S_loc, Hkv, dh), this rank's block of a cache
    cut into ``blocks``: written only on the rank whose block holds the
    position."""
    b, s_loc = dst.shape[:2]
    rows = torch.arange(b, device=dst.device)
    if blocks == 1:
        dst[rows, cur.long()] = new.to(dst.dtype)
        return
    local = cur.long() - block * s_loc
    mine = (local >= 0) & (local < s_loc)
    at = local.clamp(0, s_loc - 1)
    dst[rows, at] = torch.where(mine[:, None, None], new.to(dst.dtype), dst[rows, at])


def cache_room(cur: torch.Tensor, positions: int) -> None:
    """Raise when a row's cache of ``positions`` is full (the JAX package
    drops that write); a meta tensor (the dry-run) is not read."""
    if cur.device.type != "meta" and int(cur.max()) >= positions:
        raise ValueError(f"a row's cache is full ({positions} positions)")


def _partial_attn_local(q1, kf, vf, pos_offset, cl):
    """``repro.models.common._partial_attn_local``: the masked partial
    softmax of q1 (B, Hq, dh) over a cache slice (B, s_loc, Hkv, dh) whose
    first position is ``pos_offset`` -> ``(m, l, acc)`` (q scaled before
    the dot, the row max clamped at -1e30)."""
    b, hq, dh = q1.shape
    s_loc, hkv = kf.shape[1], kf.shape[2]
    group = hq // hkv
    qq = q1.reshape(b, hkv, group, dh).float() * (1.0 / (dh**0.5))
    s = torch.einsum("bhgd,bkhd->bhgk", qq, kf.float())
    ok = (pos_offset + torch.arange(s_loc, device=q1.device))[None, :] < cl[:, None]  # (B, s_loc)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, vf.float())
    return m, l, acc


def _decode_attention_plain(q, k_cache, v_cache, cl):
    """``repro.models.common._partial_attn_local``'s arithmetic over the
    first ``cl[b]`` cache positions of each row (q scaled before the dot)."""
    b, _, hq, dh = q.shape
    _, l, acc = _partial_attn_local(q[:, 0], k_cache, v_cache, 0, cl)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, 1, hq, dh).to(q.dtype)


# ------------------------------------------------------- weights on a mesh
def whole(w: torch.Tensor, pdef, names: tuple = ("fsdp", "tensor")) -> torch.Tensor:
    """``w``, this rank's block of the leaf ``pdef`` declares (a layer's row
    of a stacked leaf takes the one-layer declaration), in bf16 and
    gathered whole along its dims whose logical axes are in ``names``
    (``sharding.ctx.gather_dims``, looked up at each call; its backward is
    ZeRO's float32 reduce-scatter of the gradient). Without a mesh, ``w``
    in bf16."""
    return ctx.gather_dims(w, pdef.axes, pdef.shape, names, COMPUTE_DTYPE)


def col_input(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``x`` as the input of matmuls in bf16 operands (:func:`col_matmul`).
    With ``axes`` (the weights are a tensor-parallel column block) its bf16
    values in float32 through ``ctx.mean_grad``: each rank's share of its
    gradient, from its columns alone, is float32 and meets the others'
    before it rounds to ``x``'s dtype, as one matmul over every column
    rounds once."""
    if not axes:
        return x.to(COMPUTE_DTYPE)
    return ctx.mean_grad(ctx.get_mesh(), axes, x.to(COMPUTE_DTYPE).float())


def col_matmul(xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``xin @ w`` with bf16 operands -> bf16: one bf16 matmul, or float32
    products of the bf16 values where ``xin`` is :func:`col_input`'s
    float32 form."""
    return (xin @ w.to(COMPUTE_DTYPE).to(xin.dtype)).to(COMPUTE_DTYPE)


def row_parallel(a: torch.Tensor, w: torch.Tensor, axes: tuple, dtype: torch.dtype) -> torch.Tensor:
    """``a @ w`` in bf16 operands -> ``dtype``; with ``axes`` (a
    tensor-parallel row block: ``a``'s last dim and ``w``'s rows are this
    rank's block) the float32 partial products summed over ``axes`` in
    rank order (``ctx.psum``) and rounded once, as one matmul rounds its
    float32 accumulator."""
    if not axes:
        return (a.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)).to(dtype)
    part = a.to(COMPUTE_DTYPE).float() @ w.to(COMPUTE_DTYPE).float()
    return ctx.psum(ctx.get_mesh(), axes, part).to(dtype)


# ----------------------------------------------------------------- MLPs
def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor, kind: str, row_axes: tuple = ()) -> torch.Tensor:
    """The block's MLP; weights are used in bf16 (cast here if they are not
    held that way already). With ``row_axes`` the weights are this rank's
    tensor-parallel blocks (the FFN columns of ``w_gate``/``w_up``, the
    matching rows of ``w_down``) and the output is summed over those axes
    (:func:`row_parallel`)."""
    xc = col_input(x, row_axes)

    def up(name):
        return col_matmul(xc, params[name])

    if kind == "swiglu":
        g = up("w_gate")
        u = up("w_up")
        h = F.silu(g.float()).to(COMPUTE_DTYPE) * u
    elif kind == "relu2":  # nemotron squared-ReLU
        h = up("w_up")
        h = torch.square(F.relu(h.float())).to(COMPUTE_DTYPE)
    elif kind == "gelu":  # jax.nn.gelu's default is the tanh form
        h = up("w_up")
        h = F.gelu(h.float(), approximate="tanh").to(COMPUTE_DTYPE)
    else:
        raise ValueError(kind)
    h = constrain(h, "batch", None, "tensor")
    return row_parallel(h, params["w_down"], row_axes, x.dtype)


# --------------------------------------------------------- embeddings / CE
def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return constrain(embed[tokens.long()].to(COMPUTE_DTYPE), "batch", "seq", None)


def chunked_softmax_xent(
    x: torch.Tensor,  # (B, S, D) final hidden
    lm_head: torch.Tensor,  # (D, V)
    labels: torch.Tensor,  # (B, S) int
    mask: torch.Tensor,  # (B, S) bool
    seq_chunk: int = 1024,
) -> torch.Tensor:
    """Mean cross entropy over the masked positions, without stacking
    (B, S, V) logits: each sequence chunk's bf16 logits are made, reduced
    and, when there are several chunks, recomputed in the backward pass
    under a checkpoint (``repro.models.common.chunked_softmax_xent``).
    Under a mesh the rows are this rank's block, and the numerator and the
    count are summed over the batch axes: every rank returns the global
    batch's mean (a mean of the ranks' means would be wrong wherever the
    masks differ)."""
    b, s, _ = x.shape
    seq_chunk = min(seq_chunk, s)
    if s % seq_chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {seq_chunk}")
    head = lm_head.to(COMPUTE_DTYPE)  # cast once; the gradient still reaches the master

    def one(xi, li, mi):
        logits = constrain((xi.to(COMPUTE_DTYPE) @ head).float(), "batch", None, "tensor")
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.long()[..., None])[..., 0]
        nll = torch.where(mi, lse - gold, 0.0)
        return torch.stack([nll.sum(), mi.float().sum()])

    parts = [(x[:, c0 : c0 + seq_chunk], labels[:, c0 : c0 + seq_chunk], mask[:, c0 : c0 + seq_chunk])
             for c0 in range(0, s, seq_chunk)]
    if len(parts) == 1:
        tot, cnt = one(*parts[0])
    else:
        tot, cnt = torch.stack([checkpoint(one, *part, use_reentrant=False) for part in parts]).sum(0)
    mesh = ctx.get_mesh()
    if mesh is not None:
        axes = ctx.batch_axes(mesh)
        tot, cnt = ctx.psum(mesh, axes, tot), ctx.psum(mesh, axes, cnt.detach())
    return tot / cnt.clamp_min(1.0)
