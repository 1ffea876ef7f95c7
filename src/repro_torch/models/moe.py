"""Mixture-of-Experts LM of the port (phi3.5-moe 16e top-2, olmoe 64e
top-8): the loss path and the serving path.

Counterpart of ``repro.models.moe``'s local path, which the JAX package
calls its semantic reference: top-k routing with a capacity per expert,
every expert on the one card. ``moe_apply`` always takes it, as the JAX
package does without a mesh; ``cfg.moe_impl`` is read by the
expert-parallel bodies (``gather``, ``a2a``), which wait for ROADMAP.md
Queue 1 item 3, and has no effect here. :func:`loss_fn` adds the layers'
load-balancing loss to the cross entropy, as the JAX package's does; its
attention is the differentiable ``common.chunked_attention_train``.

Two choices keep the port on the JAX package's integers and bits:

* ``lax.top_k`` breaks ties toward the lowest index; ``torch.topk`` does
  not promise to, so :func:`_top_k` is a stable descending sort.
* The combine, a scatter-add of each expert's weighted outputs into the
  tokens (``out.at[top_pos].add``), is written once per (token, choice):
  each token's up to ``top_k`` expert rows are gathered and summed in
  ascending expert order, starting from zero, as XLA applies the updates.
  A float ``index_add_`` would use atomics on the card, whose order, and
  so whose bits, change from run to run. The backward passes of the
  gathers (``x[top_pos]``, ``flat[picked]``) accumulate by index with
  PyTorch's sort-based indexing backward, which gave the same gradient
  bits on two calls on the card (``chip_smoke.py``, ``families_train``).

The serving weights are one frozen tree in the JAX layout
(:func:`~repro_torch.models.dense.frozen`): the attention weights, the
experts and the embedding in bf16, the router and the norms in
``param_dtype``. The KV cache is dense's, written in place by
``decode_step``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import dense
from repro_torch.models.params import PDef, stack

BF16 = torch.bfloat16
F32 = torch.float32
_BF16_LEAVES = dense._BF16_LEAVES | {"e_gate", "e_up", "e_down"}


def layer_defs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = dense.layer_defs(cfg)
    for name in ("w_gate", "w_up", "w_down"):
        defs.pop(name, None)
    defs["router"] = PDef((d, e), scale=0.02)
    defs["e_gate"] = PDef((e, d, f))
    defs["e_up"] = PDef((e, d, f))
    defs["e_down"] = PDef((e, f, d))
    return defs


def model_defs(cfg) -> dict:
    defs = dense.model_defs(cfg)
    defs["layers"] = stack(layer_defs(cfg), cfg.n_layers)
    return defs


def storage_defs(defs: dict) -> dict:
    """``defs`` with the serving storage dtypes: bf16 for the matmul
    weights and the embeddings, the rest as they are."""
    return dense.storage_defs(defs, _BF16_LEAVES)


# ------------------------------------------------------------- routing
def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties to the lowest
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _capacity(n_tokens: int, cfg) -> int:
    cap = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(cap, 1)


def _route(router_w, xf, cfg):
    """xf: (T, D) f32 -> (weights (T, k), experts (T, k), probs (T, E))."""
    logits = xf @ router_w.to(F32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, cfg.top_k)
    top_w = top_w / torch.sum(top_w, -1, keepdim=True).clamp_min(1e-9)
    return top_w, top_e, probs


def _dispatch(top_w, top_e, cfg, e_start: int, e_count: int):
    """Each expert's tokens, up to the capacity, by router weight:
    ``(top_scores, top_pos, valid)``, each (E_loc, C); a slot with no
    token has a score of -inf and ``valid`` False."""
    t = top_w.shape[0]
    cap = _capacity(t, cfg)
    eids = e_start + torch.arange(e_count, device=top_e.device)
    assign = top_e[None] == eids[:, None, None]  # (E_loc, T, k)
    w_e = torch.where(assign, top_w[None], 0.0).sum(-1)  # (E_loc, T)
    score = torch.where(w_e > 0.0, w_e, float("-inf"))
    top_scores, top_pos = _top_k(score, min(cap, t))  # (E_loc, C)
    return top_scores, top_pos, torch.isfinite(top_scores)


def _expert_compute(e_gate, e_up, e_down, xt):
    """xt: (E_loc, C, D) bf16 -> (E_loc, C, D) bf16 through each expert's
    SwiGLU."""
    g = torch.bmm(xt, e_gate.to(BF16))
    u = torch.bmm(xt, e_up.to(BF16))
    h = F.silu(g.float()).to(BF16) * u
    return torch.bmm(h, e_down.to(BF16))


def _moe_local(p, x_tokens, cfg, e_start: int, e_count: int):
    """Token-choice MoE over experts [e_start, e_start+e_count).

    x_tokens: (T, D). Returns (out (T, D) f32 partial sum, aux loss)."""
    t, d = x_tokens.shape
    xf = x_tokens.float()
    top_w, top_e, probs = _route(p["router"], xf, cfg)
    top_scores, top_pos, valid = _dispatch(top_w, top_e, cfg, e_start, e_count)

    gathered = x_tokens.to(BF16)[top_pos]  # (E_loc, C, D)
    gathered = torch.where(valid[..., None], gathered, 0)
    out_e = _expert_compute(p["e_gate"], p["e_up"], p["e_down"], gathered)
    out_e = out_e.float() * torch.where(valid, top_scores, 0.0)[..., None]

    # the combine: slot[e, tok] is the row of out_e that carries token tok
    # for expert e (or -1); each token sums its rows over its choices in
    # ascending expert order
    cap = top_pos.shape[1]
    slot = torch.full((e_count, t), -1, dtype=torch.long, device=x_tokens.device)
    rows = torch.arange(e_count * cap, device=x_tokens.device).reshape(e_count, cap)
    slot.scatter_(1, top_pos, torch.where(valid, rows, -1))
    flat = torch.cat([out_e.reshape(-1, d), out_e.new_zeros(1, d)])  # row -1: zeros
    choices = torch.sort(top_e, dim=-1).values - e_start  # (T, k)
    local = (choices >= 0) & (choices < e_count)
    tok = torch.arange(t, device=x_tokens.device)[:, None]
    picked = torch.where(local, slot[choices.clamp(0, e_count - 1), tok], -1)  # (T, k)
    out = torch.zeros((t, d), dtype=F32, device=x_tokens.device)
    for j in range(picked.shape[1]):
        out = out + flat[picked[:, j]]

    # load-balancing stats (global across experts; from the full probs)
    load = torch.mean(F.one_hot(top_e, cfg.n_experts).float().sum(1), dim=0)  # (E,) fraction routed
    imp = torch.mean(probs, dim=0)  # (E,)
    aux = cfg.n_experts * torch.sum(load * imp) / cfg.top_k
    return out, aux


def moe_apply(p, x, cfg):
    """x: (B, S, D) -> (out in x's dtype, aux_loss), on the local path."""
    b, s, d = x.shape
    out, aux = _moe_local(p, x.reshape(b * s, d), cfg, 0, cfg.n_experts)
    return out.reshape(b, s, d).to(x.dtype), aux


# ------------------------------------------------------------- blocks
def _block(cfg, p, x, positions, attention=None):
    """Full-sequence block -> (x, k, v, aux), the rotated keys and the
    values being the cache's entries and ``aux`` the layer's load-balancing
    loss. ``attention`` is the loss path's differentiable one; None is
    ``common.chunked_attention`` (kernel F on the card), looked up at each
    call."""
    attention = attention or C.chunked_attention
    b, s, _ = x.shape
    h = C.rms_norm(x, p["ln1"])
    q, k, v = dense._qkv(cfg, p, h)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    attn = attention(q, k, v, causal=cfg.causal, window=cfg.window, q_chunk=cfg.q_chunk)
    x = x + (attn.reshape(b, s, -1).to(BF16) @ p["wo"].to(BF16)).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    mo, aux = moe_apply(p, h2, cfg)
    return x + mo.to(x.dtype), k, v, aux


def block_train(cfg, p, x, positions):
    """Full-sequence block of the loss path (differentiable attention) ->
    (x, aux)."""
    x, _, _, aux = _block(cfg, p, x, positions, C.chunked_attention_train)
    return x, aux


def _block_decode(cfg, p, x, k_cache, v_cache, cur):
    """One-token block. x: (B, 1, D); caches (B, S_max, Hkv, dh), written in
    place at each row's ``cur``."""
    b = x.shape[0]
    h = C.rms_norm(x, p["ln1"])
    q, k, v = dense._qkv(cfg, p, h)
    pos = cur[:, None]
    q = C.apply_rope(q, pos, cfg.rope_theta)
    k = C.apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    k_cache[rows, cur.long()] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, cur.long()] = v[:, 0].to(v_cache.dtype)
    attn = C.decode_attention_cp(q, k_cache, v_cache, cur + 1).reshape(b, 1, -1)
    x = x + (attn.to(BF16) @ p["wo"].to(BF16)).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    return x + moe_apply(p, h2, cfg)[0].to(x.dtype)


# ------------------------------------------------------------- public API
init_cache = dense.init_cache


def loss_fn(cfg, params, batch, remat_policy: str = "dots") -> torch.Tensor:
    """The next-token cross entropy of a master tree on ``batch`` plus the
    load-balancing term, ``aux_loss_coef`` times the layers' mean aux
    loss; the aux losses are summed in float32 from 0 in layer order, as
    the JAX package's scan carries them."""
    x, mask = dense._embed_inputs(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    aux_sum = torch.zeros((), dtype=F32, device=x.device)
    for p in dense.layer_rows(params["layers"]):
        x, aux = dense.remat_block(remat_policy, block_train, cfg, p, x, positions)
        aux_sum = aux_sum + aux
    x = C.rms_norm(x, params["final_norm"])
    tokens = torch.as_tensor(batch["tokens"], device=x.device)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = mask & (positions < s - 1)[None, :]
    ce = C.chunked_softmax_xent(x, dense._lm_head(cfg, params), labels, mask, cfg.loss_chunk)
    return ce + cfg.aux_loss_coef * aux_sum / cfg.n_layers


def prefill(cfg, model, batch, max_len: int):
    """Encode a prompt -> (last-position logits (B, V) f32, filled cache)."""
    x, _ = dense._embed_inputs(cfg, model, batch)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, p in enumerate(dense.layer_rows(model["layers"])):
        x, k, v, _ = _block(cfg, p, x, positions)
        cache["k"][i, :, :s] = k.to(BF16)
        cache["v"][i, :, :s] = v.to(BF16)
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, -1].to(BF16) @ dense._lm_head(cfg, model).to(BF16)).to(F32)
    cache["len"].fill_(s)
    return logits, cache


def decode_step(cfg, model, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, cache); the
    cache's k and v are written in place, as dense's are."""
    tokens = torch.as_tensor(tokens, device=model["embed"].device)
    cur = cache["len"]
    if int(cur.max()) >= cache["k"].shape[2]:
        raise ValueError(f"a row's cache is full ({cache['k'].shape[2]} positions)")
    x = C.embed_tokens(model["embed"], tokens)
    for i, p in enumerate(dense.layer_rows(model["layers"])):
        x = _block_decode(cfg, p, x, cache["k"][i], cache["v"][i], cur)
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, 0].to(BF16) @ dense._lm_head(cfg, model).to(BF16)).to(F32)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cur + 1}
