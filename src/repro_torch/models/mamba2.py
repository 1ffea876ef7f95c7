"""Mamba-2 (SSD, state-space duality) LM of the port, attention-free: the
loss path and the serving path.

Counterpart of ``repro.models.mamba2``: the chunked SSD algorithm
(arXiv:2405.21060), an intra-chunk quadratic form and an inter-chunk state
recurrence (the JAX package's ``lax.scan``, a loop over chunks here);
``ssd_reference`` is the exact sequential recurrence that the tests hold it
to. The one-token decode step, ``ssm_step``, runs that recurrence. No
kernel runs on this path, as none does on the JAX package's (XLA computes
its SSD). :func:`loss_fn` is the JAX package's; each layer runs under the
config's remat policy. ``ssd_chunked`` keeps no checkpoint per chunk,
where the JAX package wraps its chunk body in ``jax.checkpoint`` (a
memory choice): under remat "full" one layer's chunks are live at a time,
and mamba2-780m's training step at 4 x 1,024 tokens peaks at 16.6 GB on
the card.

One deliberate divergence from the JAX package: ``ssd_chunked`` masks
the intra-chunk decay's exponent before the exp (``exp(where(causal,
li, -inf))``), where the JAX package computes ``where(causal, exp(li),
0)``. The forward output is the same bit for bit; the JAX form's gradient
is not finite once an exponent above the diagonal passes float32's exp
range (ROADMAP.md, Queue 3; ``tests/test_torch_families_train.py``).

The dtypes are the JAX package's, which round at fixed places:

* ``ssm_mix`` keeps the wide tensors (z, x, the conv stream) in bf16 and
  promotes only dt, B and C to float32; ``ssd_chunked`` returns its chunk
  outputs in x's dtype (bf16), ``ssd_reference`` in float32.
* ``causal_conv`` is a sum of K shifted bf16 products, each product and
  each partial sum rounded to bf16, as XLA:CPU computes it (no excess
  precision kept across the fused sum; measured bit for bit). A
  ``conv1d``, which accumulates in float32, would round once.
* ``ssm_mix`` uses ``conv_w``/``conv_b`` in bf16, ``ssm_step`` in float32,
  so the serving weights keep them in ``param_dtype`` and cast at each
  use; ``in_proj``, ``out_proj``, the embedding and the head are held in
  bf16.

The cache is ``{"state": (L, B, H, N, P) f32, "conv": (L, B, K-1, conv_dim)
f32, "len": (B,) int32}``. ``decode_step`` returns new state and conv
tensors and leaves the cache it was given as it was, so a cache gives the
same answer on a second call with the same tokens. ``prefill`` stores the
conv tail in float32, where the JAX package keeps it in bf16 until the
first decode step promotes it: the same values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import dense
from repro_torch.models.params import PDef, stack

BF16 = torch.bfloat16
F32 = torch.float32
_BF16_LEAVES = frozenset({"in_proj", "out_proj", "embed", "lm_head"})


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_state  # x + B + C (n_groups = 1)
    d_proj = 2 * d_inner + 2 * cfg.ssm_state + n_heads  # z, x, B, C, dt
    return d_inner, n_heads, conv_dim, d_proj


def layer_defs(cfg) -> dict:
    d = cfg.d_model
    d_inner, n_heads, conv_dim, d_proj = dims(cfg)
    return {
        "ln": PDef((d,), "ones"),
        "in_proj": PDef((d, d_proj)),
        "conv_w": PDef((conv_dim, cfg.conv_kernel), scale=0.5),
        "conv_b": PDef((conv_dim,), "zeros"),
        "A_log": PDef((n_heads,), "zeros"),
        "D_skip": PDef((n_heads,), "ones"),
        "dt_bias": PDef((n_heads,), "zeros"),
        "ssm_norm": PDef((d_inner,), "ones"),
        "out_proj": PDef((d_inner, d)),
    }


def model_defs(cfg) -> dict:
    return {
        "embed": PDef((cfg.vocab, cfg.d_model), "embed"),
        "layers": stack(layer_defs(cfg), cfg.n_layers),
        "final_norm": PDef((cfg.d_model,), "ones"),
        "lm_head": PDef((cfg.d_model, cfg.vocab)),
    }


def storage_defs(defs: dict) -> dict:
    """``defs`` with the serving storage dtypes: bf16 for the matmul
    weights and the embeddings, the rest as they are."""
    return dense.storage_defs(defs, _BF16_LEAVES)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (C, K) -> (B, S, C), in x's
    dtype, rounding after each product and each sum."""
    k = w.shape[1]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[:, 0]
    for i in range(1, k):
        out = out + xp[:, i : i + s] * w[:, i]
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_reference(xh, dt, A, Bm, Cm):
    """Exact sequential SSD recurrence (test oracle / semantics).

    xh: (B,S,H,P) f32; dt: (B,S,H); A: (H,) negative; Bm/Cm: (B,S,N).
    Returns y (B,S,H,P) f32 and the final state (B,H,N,P)."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    hstate = torch.zeros((b, h, n, p), dtype=F32, device=xh.device)
    ys = []
    for t in range(s):
        x_t, dt_t, b_t, c_t = xh[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        decay = torch.exp(dt_t * A[None])  # (B,H)
        upd = torch.einsum("bn,bhp->bhnp", b_t, dt_t[..., None] * x_t)
        hstate = hstate * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c_t, hstate))
    return torch.stack(ys, dim=1), hstate


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD; ``ssd_reference``'s semantics (from a zero state), y in
    xh's dtype. S need not be a multiple of the chunk: the tail is padded
    with dt = 0, which leaves the state as it is."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:  # dt=0 padding is state-neutral (decay 1, update 0)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (s + pad) // q

    # head groups bound the live (B,Q,Q,hg) decay tensor
    hg = next(c for c in (16, 8, 4, 2, 1) if h % c == 0)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))[None, :, :, None]  # (1,Q,Q,1)

    hstate, ys = torch.zeros((b, h, n, p), dtype=F32, device=xh.device), []
    for c in range(nc):
        sl_t = slice(c * q, (c + 1) * q)
        xq, dtq, bq, cq = xh[:, sl_t], dt[:, sl_t], Bm[:, sl_t], Cm[:, sl_t]
        dA = dtq * A[None, None]  # (B,Q,H)
        cs = torch.cumsum(dA, dim=1)
        total = cs[:, -1]  # (B,H)
        cb = torch.einsum("bin,bjn->bij", cq, bq)  # (B,Q,Q)
        xqf = xq.float()
        groups = []
        for g in range(h // hg):
            sl = slice(g * hg, (g + 1) * hg)
            csg = cs[:, :, sl]  # (B,Q,hg)
            li = csg[:, :, None, :] - csg[:, None, :, :]  # (B,Q,Q,hg)
            # masked before the exp: above the diagonal li sums up to Q - 1
            # positive dt * |A| terms, past float32's exp range at Q = 128
            # once dt averages over 0.7, and where(causal, exp(li), 0)
            # would back-propagate 0 * inf = NaN (ROADMAP.md, Queue 3)
            lmat = torch.exp(torch.where(causal, li, float("-inf")))
            m = cb[..., None] * lmat * dtq[:, None, :, sl]
            groups.append(torch.einsum("bijh,bjhp->bihp", m, xqf[:, :, sl]))
        y_intra = torch.cat(groups, dim=2)  # (B,Q,H,P)
        decay_out = torch.exp(total[:, None] - cs)  # (B,Q,H)
        s_c = torch.einsum("bqh,bqn,bqhp->bhnp", decay_out * dtq, bq, xqf)
        y_inter = torch.einsum("bqn,bhnp->bqhp", cq, hstate) * torch.exp(cs)[..., None]
        hstate = s_c + torch.exp(total)[:, :, None, None] * hstate
        ys.append((y_intra + y_inter).to(xq.dtype))
    return torch.cat(ys, dim=1)[:, :s], hstate


def _split(t, d_inner: int, n: int):
    return torch.split(t, [d_inner, d_inner, n, n, t.shape[-1] - 2 * d_inner - 2 * n], dim=-1)


def ssm_mix(cfg, p, x):
    """The Mamba-2 mixer. x: (B, S, D) -> (out (B, S, D), final state, conv
    tail), the JAX package's ``return_state=True`` form (every serving
    caller keeps the state). The conv tail is the last K-1 rows of the
    pre-activation conv input, in float32."""
    b, s, _ = x.shape
    d_inner, n_heads, _, _ = dims(cfg)
    n = cfg.ssm_state
    # the wide tensors stay bf16 (z, x, the conv stream); only the small SSD
    # control tensors (dt, B, C) are promoted to f32
    proj = x.to(BF16) @ p["in_proj"].to(BF16)
    z, xs, bm, cm, dt = _split(proj, d_inner, n)
    xbc = torch.cat([xs, bm, cm], dim=-1)
    conv = causal_conv(xbc, p["conv_w"].to(BF16), p["conv_b"].to(BF16))
    conv = F.silu(conv.float()).to(BF16)
    xs, bm, cm = torch.split(conv, [d_inner, n, n], dim=-1)
    bm, cm = bm.float(), cm.float()
    dt = _softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, s, n_heads, cfg.ssm_headdim)
    y, h_t = ssd_chunked(xh, dt, a, bm, cm, cfg.ssm_chunk)
    y = y + p["D_skip"].float()[None, None, :, None] * xh
    y = y.reshape(b, s, d_inner)
    y = C.rms_norm(y * F.silu(z), p["ssm_norm"])
    out = (y.to(BF16) @ p["out_proj"].to(BF16)).to(x.dtype)
    return out, h_t, xbc[:, -(cfg.conv_kernel - 1) :].float()


def ssm_step(cfg, p, x, h_state, conv_state):
    """One-token recurrent step. x: (B, 1, D) -> (out (B, 1, D), new state,
    new conv window), new tensors."""
    b = x.shape[0]
    d_inner, n_heads, _, _ = dims(cfg)
    n = cfg.ssm_state
    proj = (x[:, 0].to(BF16) @ p["in_proj"].to(BF16)).float()
    z, xs, bm, cm, dt = _split(proj, d_inner, n)
    xbc = torch.cat([xs, bm, cm], dim=-1)  # (B, conv_dim)
    window = torch.cat([conv_state.float(), xbc[:, None]], dim=1)  # (B, K, C)
    conv = torch.einsum("bkc,ck->bc", window, p["conv_w"].float()) + p["conv_b"].float()
    conv = F.silu(conv)
    xs, bm, cm = torch.split(conv, [d_inner, n, n], dim=-1)
    dt = _softplus(dt + p["dt_bias"][None].float())  # (B, H)
    a = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, n_heads, cfg.ssm_headdim)
    decay = torch.exp(dt * a[None])
    h_state = h_state * decay[:, :, None, None] + torch.einsum("bn,bhp->bhnp", bm, dt[..., None] * xh)
    y = torch.einsum("bn,bhnp->bhp", cm, h_state)
    y = y + p["D_skip"].float()[None, :, None] * xh
    y = y.reshape(b, d_inner)
    y = C.rms_norm(y * F.silu(z), p["ssm_norm"])
    out = (y.to(BF16) @ p["out_proj"].to(BF16)).to(x.dtype)[:, None]
    return out, h_state, window[:, 1:]


# ------------------------------------------------------------- model API
def _block_train(cfg, p, x):
    """One layer of the loss path: x + the mixer on the normed x."""
    return x + ssm_mix(cfg, p, C.rms_norm(x, p["ln"]))[0]


def loss_fn(cfg, params, batch, remat_policy: str = "dots") -> torch.Tensor:
    """The next-token cross entropy of a master tree on ``batch`` (labels
    the tokens shifted by one; the last position left out), each layer
    under ``remat_policy`` (``dense.remat_block``)."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    x = C.embed_tokens(params["embed"], tokens)
    s = x.shape[1]
    for p in dense.layer_rows(params["layers"]):
        x = dense.remat_block(remat_policy, _block_train, cfg, p, x)
    x = C.rms_norm(x, params["final_norm"])
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = (torch.arange(s, device=x.device) < s - 1)[None, :].expand(tokens.shape)
    return C.chunked_softmax_xent(x, params["lm_head"], labels, mask, cfg.loss_chunk)


def init_cache(cfg, batch_size: int, max_len: int, dtype=BF16, device=None) -> dict:
    d_inner, n_heads, conv_dim, _ = dims(cfg)
    return {
        "state": torch.zeros((cfg.n_layers, batch_size, n_heads, cfg.ssm_state, cfg.ssm_headdim),
                             dtype=F32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch_size, cfg.conv_kernel - 1, conv_dim), dtype=F32, device=device),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def prefill(cfg, model, batch, max_len: int):
    """Encode a prompt -> (last-position logits (B, V) f32, cache);
    ``max_len`` sizes nothing (the state is fixed-size)."""
    tokens = torch.as_tensor(batch["tokens"], device=model["embed"].device)
    x = C.embed_tokens(model["embed"], tokens)
    b, s = tokens.shape
    states, convs = [], []
    for p in dense.layer_rows(model["layers"]):
        h = C.rms_norm(x, p["ln"])
        out, h_t, conv_t = ssm_mix(cfg, p, h)
        x = x + out
        states.append(h_t)
        convs.append(conv_t)
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, -1].to(BF16) @ model["lm_head"].to(BF16)).to(F32)
    cache = {"state": torch.stack(states), "conv": torch.stack(convs),
             "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, cache


def decode_step(cfg, model, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, a new cache)."""
    tokens = torch.as_tensor(tokens, device=model["embed"].device)
    x = C.embed_tokens(model["embed"], tokens)
    states, convs = [], []
    for i, p in enumerate(dense.layer_rows(model["layers"])):
        h = C.rms_norm(x, p["ln"])
        out, hs, cs = ssm_step(cfg, p, h, cache["state"][i], cache["conv"][i])
        x = x + out
        states.append(hs)
        convs.append(cs)
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, 0].to(BF16) @ model["lm_head"].to(BF16)).to(F32)
    return logits, {"state": torch.stack(states), "conv": torch.stack(convs), "len": cache["len"] + 1}
