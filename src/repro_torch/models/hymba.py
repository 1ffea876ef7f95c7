"""Hymba, the hybrid-head LM of the port (arXiv:2411.13676): the loss
path and the serving path.

Counterpart of ``repro.models.hymba``: each layer runs attention and a
Mamba-2 (SSD) mixer in parallel on the same normed input and averages
their normed outputs; 128 learned meta tokens lead every sequence and stay
visible as attention sinks; attention is sliding-window (``cfg.window``)
everywhere except the few ``cfg.global_layers``. Layers are grouped into
*segments*, runs of SWA layers and single global layers, whose caches
differ in shape. :func:`loss_fn` runs every layer through :func:`_block`,
as ``prefill`` does, with the differentiable attention (whose
sliding-window layers keep the meta tokens as sinks too), and the meta
tokens get their gradient.

Where attention runs: prefill's attention, SWA (window and sink) and
global alike, and the global layers' decode attention are
``common.chunked_attention`` / ``common.decode_attention_cp``, kernel F
on the card. The SWA decode step attends over a ring buffer of the last
``window`` keys plus the meta tokens' keys (:func:`_swa_decode_attn`),
plain torch ops, as the JAX package's is XLA code and no Pallas kernel.

The cache is ``{"len": (B,), "segments": {"seg<i>": {...}}}``: every
segment holds its layers' SSM ``state`` (n, B, H, N, P) and ``conv``
(n, B, K-1, conv_dim) in float32; a global one ``k``/``v`` (n, B, S_max,
Hkv, dh); an SWA one the ring ``k``/``v`` (n, B, W, Hkv, dh), each ring
slot's position ``pos`` (-1 for empty) and the meta tokens' ``sink_k``/
``sink_v``. ``decode_step`` writes K/V and the ring in place and returns
new state and conv tensors. Under a mesh the global layers' K/V hold this
rank's block of positions, as dense's cache does (``"seq_blocks"``); the
sliding-window layers' rings are held whole, as the JAX package's
``cache_logical_axes`` leaves them unsplit; the SSM ``state`` and ``conv``
are held in blocks along ``tensor``, as mamba2's. The weights are this
rank's blocks, every one gathered whole before use (``common.whole``):
hymba-1.5b's 25 heads do not split whole over ``tensor``, so attention is
not tensor-parallel here (``dense.attn_axes``), nor is the MLP. Between
layers the stream (meta tokens first) is the rank's block of positions
wherever the ``seq`` axes divide them: a layer gathers its normed input
along the sequence for attention and the SSM branch, keeps its positions
of both outputs and runs the mix, the residual adds and the MLP on them.
The embedding and the head are used in the rank's block of the
vocabulary where the ``tensor`` axes divide it (hymba-1.5b's 32,001 does
not: the whole path, as JAX drops the axis); the meta rows are whole.

A fault of the JAX package that the port reproduces (ROADMAP.md, Queue 3):
``prefill`` puts positions 0..meta_tokens-1 both in ``sink_k`` and, while
the prompt with its meta tokens is shorter than ``window``, in the ring,
so the SWA decode step counts those meta keys twice until the ring's
slots holding them are overwritten. Decode after ``prefill(s)`` then
differs from ``prefill(s+1)`` while ``s_tot < window + meta_tokens``.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as C
from repro_torch.models import dense, mamba2
from repro_torch.models.params import PDef, stack
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain

BF16 = torch.bfloat16
F32 = torch.float32
_BF16_LEAVES = dense._BF16_LEAVES | mamba2._BF16_LEAVES | {"meta"}


# ------------------------------------------------------------- segments
def segments(cfg) -> list[tuple[str, int]]:
    """[('global', 1), ('swa', n), ...] covering cfg.n_layers in order."""
    segs: list[tuple[str, int]] = []
    i = 0
    while i < cfg.n_layers:
        if i in cfg.global_layers:
            segs.append(("global", 1))
            i += 1
        else:
            j = i
            while j < cfg.n_layers and j not in cfg.global_layers:
                j += 1
            segs.append(("swa", j - i))
            i = j
    return segs


def layer_defs(cfg) -> dict:
    defs = dense.layer_defs(cfg)  # attention + swiglu mlp + ln1/ln2
    defs.update(mamba2.layer_defs(cfg))  # ssm branch ("ln" unused -> drop)
    defs.pop("ln")
    defs["attn_out_norm"] = PDef((cfg.d_model,), "ones", logical=(None,))
    defs["ssm_out_norm"] = PDef((cfg.d_model,), "ones", logical=(None,))
    return defs


def model_defs(cfg) -> dict:
    d = cfg.d_model
    return {
        "embed": dense.embed_def(cfg),
        "meta": PDef((cfg.meta_tokens, d), "embed", logical=(None, None)),
        "segments": {f"seg{i}": stack(layer_defs(cfg), n) for i, (_, n) in enumerate(segments(cfg))},
        "final_norm": PDef((d,), "ones", logical=(None,)),
        "lm_head": dense.head_def(cfg),
    }


def storage_defs(defs: dict) -> dict:
    """``defs`` with the serving storage dtypes: bf16 for the matmul
    weights and the embeddings, the rest as they are."""
    return dense.storage_defs(defs, _BF16_LEAVES)


def _segments(cfg, model):
    """(kind, name, per-layer weight views) of each segment, in order."""
    return [(kind, f"seg{i}", dense.layer_rows(model["segments"][f"seg{i}"]))
            for i, (kind, _) in enumerate(segments(cfg))]


def _embed_with_meta(cfg, model, tokens, emb=None):
    """The meta rows, then the tokens' rows, as the stream holds them (the
    rank's block of the ``meta_tokens + S`` positions where they split)."""
    x = dense.embed_tokens(cfg, model, tokens, emb)
    meta = model["meta"].to(x.dtype)[None].expand(x.shape[0], -1, -1)
    return constrain(torch.cat([meta, x], dim=1), "batch", "seq", None)


def _mix(p, attn_out, ssm_out):
    """The two heads' normed outputs, averaged."""
    return 0.5 * (C.rms_norm(attn_out, p["attn_out_norm"]) + C.rms_norm(ssm_out, p["ssm_out_norm"]))


# ------------------------------------------------------------- blocks
def _block(cfg, p, x, positions, window, attention=None):
    """Full-sequence layer -> (x, k, v, SSM state, conv tail): k and v are
    the rotated keys and the values of every position, the cache's
    entries; ``x`` in and out is the rank's block of positions where the
    ``seq`` axes split them. Sliding-window layers (``window`` set) keep
    the meta tokens visible as sinks; global ones (None) attend causally.
    ``attention`` is the loss path's differentiable one; None is
    ``common.chunked_attention`` (kernel F on the card), looked up at each
    call."""
    attention = attention or C.chunked_attention
    seq = ctx.seq_split(positions.shape[0])
    C.note_stream(x)
    h = C.gather_seq(C.rms_norm(x, p["ln1"]), seq)
    q, k, v = dense._qkv(cfg, p, h)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    attn = attention(q, k, v, causal=True, window=window, sink=cfg.meta_tokens if window else 0,
                     q_chunk=cfg.q_chunk)
    attn_out = dense.attn_out(cfg, p, attn, x.dtype, seq)
    ssm_out, hs, cs = mamba2.ssm_mix(cfg, p, h)
    x = x + _mix(p, attn_out, C.keep_seq(ssm_out, seq)).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + dense.mlp(cfg, p, h2).to(x.dtype)
    return x, k, v, hs, cs


def _block_train(cfg, p, x, positions, window):
    """One layer of the loss path (differentiable attention) -> x."""
    return _block(cfg, p, x, positions, window, C.chunked_attention_train)[0]


def _run_segments(cfg, params, x, positions, remat_policy: str = "dots"):
    """Every layer of every segment on the loss path, each under
    ``remat_policy`` (``dense.remat_block``) -> x before the final norm."""
    for kind, _, layers in _segments(cfg, params):
        window = cfg.window if kind == "swa" else None
        for p in layers:
            x = dense.remat_block(remat_policy, _block_train, cfg, p, x, positions, window)
    return x


def loss_fn(cfg, params, batch, remat_policy: str = "dots") -> torch.Tensor:
    """The next-token cross entropy of a master tree on ``batch``: the
    tokens run behind the meta tokens (whose rows get gradients), whose
    positions are dropped before the head; labels are the tokens shifted
    by one, the last position left out."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    emb = dense.embed_block(cfg, params)
    x = _embed_with_meta(cfg, params, tokens, emb)
    positions = torch.arange(tokens.shape[1] + cfg.meta_tokens, device=x.device)
    x = _run_segments(cfg, params, x, positions, remat_policy)
    x = C.rms_norm(x, params["final_norm"])
    s = tokens.shape[1]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = (torch.arange(s, device=x.device) < s - 1)[None, :].expand(tokens.shape)
    return dense.lm_loss(cfg, params, x, labels, mask, emb, ctx.seq_split(positions.shape[0]), cfg.meta_tokens)


# ------------------------------------------------------------- caches
def init_cache(cfg, batch_size: int, max_len: int, dtype=BF16, device=None) -> dict:
    d_inner, n_heads, conv_dim, _ = mamba2.dims(cfg)
    hkv, dh, w, mt = cfg.n_kv_heads, cfg.head_dim, cfg.window, cfg.meta_tokens

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    cache: dict = {"len": zeros(batch_size, dt=torch.int32), "segments": {}}
    for i, (kind, n) in enumerate(segments(cfg)):
        seg = {
            "state": zeros(n, batch_size, n_heads, cfg.ssm_state, cfg.ssm_headdim, dt=F32),
            "conv": zeros(n, batch_size, cfg.conv_kernel - 1, conv_dim, dt=F32),
        }
        if kind == "global":
            seg["k"] = zeros(n, batch_size, max_len, hkv, dh)
            seg["v"] = zeros(n, batch_size, max_len, hkv, dh)
        else:
            seg["k"] = zeros(n, batch_size, w, hkv, dh)
            seg["v"] = zeros(n, batch_size, w, hkv, dh)
            seg["pos"] = torch.full((n, batch_size, w), -1, dtype=torch.int32, device=device)
            seg["sink_k"] = zeros(n, batch_size, mt, hkv, dh)
            seg["sink_v"] = zeros(n, batch_size, mt, hkv, dh)
        cache["segments"][f"seg{i}"] = seg
    return cache


def cache_logical_axes(cfg) -> dict:
    axes: dict = {"len": ("batch",), "segments": {}}
    for i, (kind, _) in enumerate(segments(cfg)):
        seg = {
            "state": (None, "batch", "tensor", None, None),
            "conv": (None, "batch", None, "tensor"),
            "k": (None, "batch", "seq" if kind == "global" else None, None, None),
            "v": (None, "batch", "seq" if kind == "global" else None, None, None),
        }
        if kind == "swa":
            seg["pos"] = (None, "batch", None)
            seg["sink_k"] = (None, "batch", None, None, None)
            seg["sink_v"] = (None, "batch", None, None, None)
        axes["segments"][f"seg{i}"] = seg
    return axes


# ------------------------------------------------------------- decode
def _swa_decode_attn(cfg, q, seg_k, seg_v, seg_pos, sink_k, sink_v, cur):
    """q: (B,1,Hq,dh); ring (B,W,Hkv,dh) + sink (B,mt,Hkv,dh) -> (B,1,Hq,dh).

    A key is seen when its slot is filled, at or before ``cur``, and a meta
    token or within the window; a meta position still in the ring is seen
    twice (the JAX package's arithmetic)."""
    b, _, hq, dh = q.shape
    hkv = seg_k.shape[2]
    group = hq // hkv
    keys = torch.cat([sink_k, seg_k], dim=1)  # (B, mt+W, Hkv, dh)
    vals = torch.cat([sink_v, seg_v], dim=1)
    mt = sink_k.shape[1]
    sink_pos = torch.arange(mt, device=q.device)[None].expand(b, mt)
    pos = torch.cat([sink_pos, seg_pos], dim=1)  # (B, mt+W)
    c = cur[:, None]
    ok = (pos >= 0) & (pos <= c) & ((pos < mt) | (pos > c - cfg.window))
    qq = q[:, 0].reshape(b, hkv, group, dh).float() / (dh**0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qq, keys.float())
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vals.float())
    out = out / torch.sum(p, dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def _block_decode(cfg, p, x, seg, i: int, kind: str, cur, blocks: int = 1, block: int = 0):
    """Layer ``i`` of segment ``seg`` on one token. x: (B, 1, D). K/V (and
    the ring's positions) are written in place, a global layer's into this
    rank's block of a cache cut into ``blocks``. Returns (x, new state, new
    conv window), whole."""
    C.note_stream(x)
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    h = C.rms_norm(x, p["ln1"])
    q, k, v = dense._qkv(cfg, p, h)
    pos = cur[:, None]
    q = C.apply_rope(q, pos, cfg.rope_theta)
    k = C.apply_rope(k, pos, cfg.rope_theta)
    kc, vc = seg["k"][i], seg["v"][i]
    if kind == "global":
        C.cache_write(kc, k[:, 0], cur, blocks, block)
        C.cache_write(vc, v[:, 0], cur, blocks, block)
        attn = C.decode_attention_cp(q, kc, vc, cur + 1, blocks)
    else:
        slot = (cur % cfg.window).long()
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        seg["pos"][i][rows, slot] = cur
        attn = _swa_decode_attn(cfg, q, kc, vc, seg["pos"][i], seg["sink_k"][i], seg["sink_v"][i], cur)
    attn_out = dense.attn_out(cfg, p, attn, x.dtype)
    ssm_out, hs, cs = mamba2.ssm_step(cfg, p, h, *mamba2.whole_cache(cfg, seg["state"][i], seg["conv"][i]))
    x = x + _mix(p, attn_out, ssm_out).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + dense.mlp(cfg, p, h2).to(x.dtype)
    return x, hs, cs


def decode_step(cfg, model, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, cache): K/V,
    the ring and its positions written in place, new SSM state and conv
    tensors, ``len + 1``."""
    emb = dense.embed_block(cfg, model)
    x = dense.embed_tokens(cfg, model, tokens, emb)
    cur = cache["len"]
    new_segs = {}
    for kind, name, layers in _segments(cfg, model):
        seg = cache["segments"][name]
        blocks, block = 1, 0
        if kind == "global":
            blocks, block, positions = dense.cache_cut(dict(seg, seq_blocks=cache.get("seq_blocks", 1)))
            C.cache_room(cur, positions)
        states, convs = [], []
        for i, p in enumerate(layers):
            x, hs, cs = _block_decode(cfg, p, x, seg, i, kind, cur, blocks, block)
            states.append(hs)
            convs.append(cs)
        new_segs[name] = dict(seg, **mamba2.held_cache(cfg, states, convs))
    x = C.rms_norm(x, model["final_norm"])
    logits = C.head_logits(x[:, 0], dense.head_block(cfg, model, emb), dense.vocab_axes(cfg))
    return logits, dict(cache, len=cur + 1, segments=new_segs)


# ------------------------------------------------------------- prefill
def _ring(k_all, s_tot: int, w: int):
    """The last ``w`` positions of ``k_all`` (n, B, S, ...) placed at
    ``pos % w`` of a ring (n, B, w, ...), with each slot's position (-1 for
    an empty one)."""
    n_l, b = k_all.shape[:2]
    ring = k_all.new_zeros((n_l, b, w) + k_all.shape[3:])
    rpos = torch.full((n_l, b, w), -1, dtype=torch.int32, device=k_all.device)
    if s_tot >= w:
        last = torch.arange(w, device=k_all.device) + (s_tot - w)
        slots = last % w
        ring[:, :, slots] = k_all[:, :, last]
        rpos[:] = last[torch.argsort(slots)].to(torch.int32)
    else:
        ring[:, :, :s_tot] = k_all
        rpos[:, :, :s_tot] = torch.arange(s_tot, dtype=torch.int32, device=k_all.device)
    return ring, rpos


def prefill(cfg, model, batch, max_len: int):
    """Encode a prompt behind the meta tokens and build every segment's
    cache -> (last-position logits (B, V) f32, cache); ``max_len`` counts
    the meta tokens (the global layers' K/V hold ``max_len`` positions)."""
    tokens = torch.as_tensor(batch["tokens"], device=model["embed"].device)
    b = tokens.shape[0]
    emb = dense.embed_block(cfg, model)
    x = _embed_with_meta(cfg, model, tokens, emb)
    s_tot = tokens.shape[1] + cfg.meta_tokens
    if s_tot > max_len:
        raise ValueError(f"prompt of {s_tot} positions (meta tokens included) does not fit a cache of {max_len}")
    positions = torch.arange(s_tot, device=x.device)
    mt, w = cfg.meta_tokens, cfg.window
    blocks, block = C.seq_cut(max_len)
    new_segs = {}
    for kind, name, layers in _segments(cfg, model):
        window = w if kind == "swa" else None
        ks, vs, states, convs = [], [], [], []
        for p in layers:
            x, k, v, hs, cs = _block(cfg, p, x, positions, window)
            ks.append(k.to(BF16))
            vs.append(v.to(BF16))
            states.append(hs)
            convs.append(cs)
        k_all, v_all = torch.stack(ks), torch.stack(vs)  # (n, B, s_tot, Hkv, dh)
        seg: dict = mamba2.held_cache(cfg, states, convs)
        if kind == "global":
            seg["k"] = k_all.new_zeros((len(layers), b, max_len // blocks) + k_all.shape[3:])
            seg["v"] = torch.zeros_like(seg["k"])
            for i in range(len(layers)):
                C.cache_fill(seg["k"][i], k_all[i], blocks, block)
                C.cache_fill(seg["v"][i], v_all[i], blocks, block)
        else:
            seg["k"], seg["pos"] = _ring(k_all, s_tot, w)
            seg["v"], _ = _ring(v_all, s_tot, w)
            seg["sink_k"] = k_all[:, :, :mt].clone()
            seg["sink_v"] = v_all[:, :, :mt].clone()
        new_segs[name] = seg
    x = C.last_position(C.rms_norm(x, model["final_norm"]), ctx.seq_split(s_tot))
    logits = C.head_logits(x, dense.head_block(cfg, model, emb), dense.vocab_axes(cfg))
    cache = {"len": torch.full((b,), s_tot, dtype=torch.int32, device=x.device), "segments": new_segs}
    if ctx.get_mesh() is not None:
        cache["seq_blocks"] = blocks  # the global layers' K/V
    return logits, cache
