"""Transformer building blocks of the port.

Counterpart of ``repro.models.common``: matmuls take bf16 operands, norms,
rotary embeddings and softmax run in float32, and each function returns
its input's dtype, as in the JAX package. Under an ambient mesh
(``sharding.ctx.use_mesh``) every function works on this rank's block:
the residual stream is held in blocks of positions over the ``seq`` axes
wherever they divide the sequence (``ctx.seq_split``; :func:`gather_seq`
and :func:`keep_seq` move between the block and the whole sequence);
:func:`whole` gathers a weight's ``fsdp`` and ``tensor`` blocks before
use (ZeRO); :func:`col_input` gathers a column-parallel matmul's input
along the sequence and :func:`row_parallel` sums a tensor-parallel
matmul's partial products over the ``tensor`` axes, reduce-scattered back
to the stream's blocks (JAX's sequence-parallel layout);
:func:`mlp_apply` takes either; :func:`embed_tokens` and
:func:`head_logits` work on the rank's block of the vocabulary;
:func:`chunked_softmax_xent` returns the global batch's loss from the
rank's vocabulary columns (the row's log-sum-exp and gold logit summed
over the ``tensor`` axes; numerator and token count over the batch axes);
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

# A tracing hook: while a list, every block of every family appends the
# shape and bytes of the stream entering it (:func:`note_stream`), as this
# rank holds it; None, the default, records nothing.
STREAM: list | None = None


def note_stream(x: torch.Tensor) -> None:
    """Record ``x``, the stream entering a block, in :data:`STREAM`."""
    if STREAM is not None:
        STREAM.append((tuple(x.shape), x.numel() * x.element_size()))


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


# ------------------------------------------------------ the stream's layout
def gather_seq(x: torch.Tensor, seq: tuple) -> torch.Tensor:
    """``x`` (B, S / n, ...), this rank's block of positions over the
    ``seq`` axes, all-gathered whole along dim 1 (its backward
    reduce-scatters the gradient in float32); ``x`` where ``seq`` is ()."""
    return ctx.all_gather_tiled(ctx.get_mesh(), seq, x, 1) if seq else x


def keep_seq(x: torch.Tensor, seq: tuple) -> torch.Tensor:
    """This rank's block of positions of ``x`` (B, S, ...), computed alike
    on the ranks of the ``seq`` axes (``ctx.keep_block``); ``x`` where
    ``seq`` is ()."""
    return ctx.keep_block(ctx.get_mesh(), seq, x, 1) if seq else x


def _sum_to_seq(part: torch.Tensor, axes: tuple, seq: tuple) -> torch.Tensor:
    """The sum of ``part`` over ``axes`` in rank order, as the stream holds
    it: this rank's block of positions where ``seq`` splits the sequence
    (a reduce-scatter where the two are the same axes), else whole."""
    mesh = ctx.get_mesh()
    if seq and tuple(seq) == tuple(axes):
        return ctx.psum_scatter(mesh, axes, part, 1)
    return keep_seq(ctx.psum(mesh, axes, part), seq)


def last_position(x: torch.Tensor, seq: tuple) -> torch.Tensor:
    """The last position's row (B, D) of ``x`` (B, S, D), which lies on the
    last rank of the ``seq`` axes where they split the sequence: each
    rank's last row all-gathered, the last of them kept (B x D a rank, not
    the stream)."""
    if not seq:
        return x[:, -1]
    return ctx.all_gather_tiled(ctx.get_mesh(), seq, x[:, -1:], 1)[:, -1]


def col_input(x: torch.Tensor, axes: tuple, seq: tuple = ()) -> torch.Tensor:
    """``x`` as the input of matmuls in bf16 operands (:func:`col_matmul`),
    whole along the sequence (gathered where ``seq`` splits it: the
    gather's backward sums the ranks' gradients over ``seq``, in float32).
    With ``axes`` (the weights are a tensor-parallel column block) its
    bf16 values in float32: each rank's share of its gradient, from its
    columns alone, is float32 and meets the others' before it rounds to
    ``x``'s dtype, as one matmul over every column rounds once
    (``ctx.mean_grad`` over the tensor axes ``seq`` leaves out). Without
    them the ranks run the whole computation on the whole gradient
    (:func:`keep_seq`), their gradients of ``x`` are equal and their sum
    exact, and ``x`` is gathered in bf16."""
    xb = x.to(COMPUTE_DTYPE)
    if not axes:
        return gather_seq(xb, seq)
    wide = gather_seq(xb.float() if xb.requires_grad else xb, seq).float()
    rest = tuple(a for a in axes if a not in seq)
    return ctx.mean_grad(ctx.get_mesh(), rest, wide) if rest else wide


def col_matmul(xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``xin @ w`` with bf16 operands -> bf16: one bf16 matmul, or float32
    products of the bf16 values where ``xin`` is :func:`col_input`'s
    float32 form."""
    return (xin @ w.to(COMPUTE_DTYPE).to(xin.dtype)).to(COMPUTE_DTYPE)


def row_parallel(a: torch.Tensor, w: torch.Tensor, axes: tuple, dtype: torch.dtype, seq: tuple = ()) -> torch.Tensor:
    """``a @ w`` in bf16 operands -> ``dtype``, for the positions of
    ``a`` (B, S, F) the stream holds: this rank's block where ``seq``
    splits the sequence. With ``axes`` (a tensor-parallel row block:
    ``a``'s last dim and ``w``'s rows are this rank's block) the float32
    partial products summed over ``axes`` in rank order, reduce-scattered
    to the rank's positions where ``seq`` is the same axes (``ctx.psum``
    and ``ctx.psum_scatter`` give the same bits), and rounded once, as one
    matmul rounds its float32 accumulator."""
    if not axes:
        return (keep_seq(a, seq).to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)).to(dtype)
    part = a.to(COMPUTE_DTYPE).float() @ w.to(COMPUTE_DTYPE).float()
    return _sum_to_seq(part, axes, seq).to(dtype)


# ----------------------------------------------------------------- MLPs
def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor, kind: str, row_axes: tuple = (),
              seq: tuple = ()) -> torch.Tensor:
    """The block's MLP; weights are used in bf16 (cast here if they are not
    held that way already). With ``row_axes`` the weights are this rank's
    tensor-parallel blocks (the FFN columns of ``w_gate``/``w_up``, the
    matching rows of ``w_down``) and the output is summed over those axes
    (:func:`row_parallel`); ``x`` is then the rank's block of positions
    over ``seq`` (where it splits), gathered for the column blocks and
    reduce-scattered back. Without ``row_axes`` the MLP runs on the
    positions ``x`` has."""
    xc = col_input(x, row_axes, seq)

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
    return row_parallel(h, params["w_down"], row_axes, x.dtype, seq)


# --------------------------------------------------------- embeddings / CE
def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, vocab_axes: tuple = (), seq: tuple = ()) -> torch.Tensor:
    """The rows of ``tokens`` (B, S) in bf16, the positions the stream
    holds (this rank's block where ``seq`` splits the sequence).

    ``embed`` is the table whole along the model dim: the whole vocabulary,
    or with ``vocab_axes`` this rank's block of it. Then each rank takes
    the rows of the tokens in its block and zeros for the others, in
    float32, and the ranks' rows are summed over ``vocab_axes`` in rank
    order (reduce-scattered to the rank's positions where ``seq`` is the
    same axes) and rounded to bf16: every token has one nonzero term, so
    the bits are the whole table's lookup. The block's gradient is a
    scatter-add of this rank's tokens' rows."""
    if not vocab_axes:
        return embed[keep_seq(tokens, seq).long()].to(COMPUTE_DTYPE)
    mesh = ctx.get_mesh()
    v_loc = embed.shape[0]
    local = tokens.long() - ctx.block_index(mesh, vocab_axes) * v_loc
    mine = (local >= 0) & (local < v_loc)
    rows = torch.where(mine[..., None], embed[local.clamp(0, v_loc - 1)].float(), 0.0)
    return _sum_to_seq(rows, vocab_axes, seq).to(COMPUTE_DTYPE)


def head_logits(x: torch.Tensor, head: torch.Tensor, vocab_axes: tuple = ()) -> torch.Tensor:
    """Serving logits (B, V) float32 of rows ``x`` (B, D): the bf16 product
    with ``head`` (D, V), or with ``vocab_axes`` with this rank's block of
    its columns, all-gathered along the vocabulary (bf16 on the wire, the
    product's own dtype)."""
    part = x.to(COMPUTE_DTYPE) @ head.to(COMPUTE_DTYPE)
    if vocab_axes:
        part = ctx.all_gather_tiled(ctx.get_mesh(), vocab_axes, part, 1)
    return part.float()


def chunked_softmax_xent(
    x: torch.Tensor,  # (B, S, D) final hidden
    lm_head: torch.Tensor,  # (D, V), or this rank's block of the vocabulary (D, V / n)
    labels: torch.Tensor,  # (B, S) int
    mask: torch.Tensor,  # (B, S) bool
    seq_chunk: int = 1024,
    vocab_axes: tuple = (),
    seq: tuple = (),
    skip: int = 0,
) -> torch.Tensor:
    """Mean cross entropy over the masked positions, without stacking
    (B, S, V) logits: each sequence chunk's bf16 logits are made, reduced
    and, when there are several chunks, recomputed in the backward pass
    under a checkpoint (``repro.models.common.chunked_softmax_xent``).

    ``x`` is the stream as the rank holds it, its block of positions where
    ``seq`` splits them: it is gathered whole (JAX constrains the logits to
    ``("batch", None, "tensor")``), in :func:`col_input`'s float32 form
    where the ranks' shares of its gradient meet, and its first ``skip``
    positions, which have no label (hymba's meta tokens), are dropped;
    ``labels`` and ``mask`` cover the rest. With ``vocab_axes``
    ``lm_head`` is this rank's block of
    the vocabulary and a chunk's logits stay (B, chunk, V / n): the row's
    max over the ranks is a shift that passes no gradient (``ctx.pmax``),
    and the sum of ``exp(logit - max)`` and the gold logit (its owner's,
    zeros elsewhere) are summed over ``vocab_axes`` in rank order; the
    log-sum-exp differs from a whole row's by float32 rounding. Under a
    mesh the numerator and the count are then summed over the batch axes:
    every rank returns the global batch's mean (a mean of the ranks' means
    would be wrong wherever the masks differ). :func:`softmax_xent_plain`
    is the same loss computed whole."""
    x = col_input(x, vocab_axes, seq)[:, skip:]
    b, s, _ = x.shape
    seq_chunk = min(seq_chunk, s)
    if s % seq_chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {seq_chunk}")
    head = lm_head.to(COMPUTE_DTYPE)  # cast once; the gradient still reaches the master
    mesh = ctx.get_mesh()
    v_loc = head.shape[1]
    v0 = ctx.block_index(mesh, vocab_axes) * v_loc if vocab_axes else 0

    def one(xi, li, mi):
        logits = constrain(col_matmul(xi, head).float(), "batch", None, "tensor")
        local = li.long() - v0
        if not vocab_axes:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, local[..., None])[..., 0]
        else:
            m = ctx.pmax(mesh, vocab_axes, logits.amax(-1))
            mine = (local >= 0) & (local < v_loc)
            own = torch.where(mine, torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0], 0.0)
            sums = ctx.psum(mesh, vocab_axes, torch.stack([torch.exp(logits - m[..., None]).sum(-1), own]))
            lse, gold = m + torch.log(sums[0]), sums[1]
        nll = torch.where(mi, lse - gold, 0.0)
        return torch.stack([nll.sum(), mi.float().sum()])

    parts = [(x[:, c0 : c0 + seq_chunk], labels[:, c0 : c0 + seq_chunk], mask[:, c0 : c0 + seq_chunk])
             for c0 in range(0, s, seq_chunk)]
    if len(parts) == 1:
        tot, cnt = one(*parts[0])
    else:
        tot, cnt = torch.stack([checkpoint(one, *part, use_reentrant=False) for part in parts]).sum(0)
    if mesh is not None:
        axes = ctx.batch_axes(mesh)
        tot, cnt = ctx.psum(mesh, axes, tot), ctx.psum(mesh, axes, cnt.detach())
    return tot / cnt.clamp_min(1.0)


def softmax_xent_plain(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`chunked_softmax_xent` computed whole on one process: the
    (B, S, V) bf16 logits at once, ``F.cross_entropy`` over the masked
    positions (the reference the blockwise loss is held to)."""
    logits = (x.to(COMPUTE_DTYPE) @ lm_head.to(COMPUTE_DTYPE)).float()
    return F.cross_entropy(logits[mask], labels[mask].long())
