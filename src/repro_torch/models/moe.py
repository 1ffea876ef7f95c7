"""Mixture-of-Experts LM of the port (phi3.5-moe 16e top-2, olmoe 64e
top-8): the loss path and the serving path.

Counterpart of ``repro.models.moe``: top-k routing with a capacity per
expert. Two execution paths, as in the JAX package:

* local (no mesh): every expert on the one card, the semantic reference;
* expert-parallel (an ambient mesh whose expert axes split both the
  experts and the sequence): each rank holds its block of the expert
  stacks and runs the body ``cfg.moe_impl`` names on its block of the
  sequence, the stream's layout between blocks (``ctx.seq_split``):
  ``gather`` (the JAX body: the sequence block all-gathered, the rank's
  experts over every token, the bf16 partial outputs psum-scattered back
  to blocks over the expert axis) or ``a2a`` (per destination rank the
  top-capacity token copies of the rank's own block exchanged by
  all-to-all and the results sent home). Where the JAX package falls back
  to the local path under a mesh (decode's one token, ``n_experts`` or the
  sequence not splitting, one expert rank), GSPMD still reads the sharded
  stacks; a rank of the port holds only its block, so it gathers its
  positions whole and the batch's tokens over the batch axes, computes its
  experts' share over all of them and sums the shares over the expert
  axes (:func:`_moe_local_mesh`), then keeps its positions. ``aux``
  follows the JAX package over the expert axis (psum / ep in ``gather``,
  pmean in ``a2a``) and sums its statistics over the batch axes, the
  global batch's as GSPMD's local path computes them.

:func:`loss_fn` adds the layers' load-balancing loss to the cross
entropy, as the JAX package's does; its attention is the differentiable
``common.chunked_attention_train``.

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

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import dense
from repro_torch.models.params import PDef, stack
from repro_torch.sharding import ctx

BF16 = torch.bfloat16
F32 = torch.float32
_BF16_LEAVES = dense._BF16_LEAVES | {"e_gate", "e_up", "e_down"}

# A tracing hook: while a list, each moe layer's call appends its routes
# (:func:`_note_routes`), so that a mesh's routing can be held against one
# process's; None, the default, records nothing.
ROUTES: list | None = None


def layer_defs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = dense.layer_defs(cfg)
    for name in ("w_gate", "w_up", "w_down"):
        defs.pop(name, None)
    defs["router"] = PDef((d, e), scale=0.02, logical=(None, None))
    defs["e_gate"] = PDef((e, d, f), logical=("expert", "fsdp", None))
    defs["e_up"] = PDef((e, d, f), logical=("expert", "fsdp", None))
    defs["e_down"] = PDef((e, f, d), logical=("expert", None, "fsdp"))
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


def _aux(top_e, probs, cfg, stats_axes: tuple = ()):
    """The load-balancing loss from the routing of T tokens: ``n_experts``
    times the sum of each expert's routed fraction times its mean router
    probability, over ``top_k``. With ``stats_axes`` (a mesh's batch
    axes) both means are over the tokens of every rank of those axes."""
    counts = F.one_hot(top_e, cfg.n_experts).float().sum(1)  # (T, E)
    if not stats_axes:
        load = torch.mean(counts, dim=0)  # (E,) fraction routed
        imp = torch.mean(probs, dim=0)  # (E,)
    else:
        mesh = ctx.get_mesh()
        n = probs.shape[0] * ctx.mesh_axis_size(*stats_axes)
        load = ctx.psum(mesh, stats_axes, counts.sum(0)) / n
        imp = ctx.psum(mesh, stats_axes, probs.sum(0)) / n
    return cfg.n_experts * torch.sum(load * imp) / cfg.top_k


def _note_routes(used, probs, cfg, layout: tuple, e0: int, dropped: int = 0) -> None:
    """Append one call's routes to :data:`ROUTES` (host arrays): ``used``
    (B, S, E_held), the experts whose outputs each token summed, from
    expert ``e0`` on; ``top_p``/``top_e`` (B, S, top_k + 1), each token's
    largest router probabilities and their experts; where the tokens lie
    in the global batch, ``layout`` = (B, S, first row, first position);
    ``dropped``, the token copies a receiving rank dropped (``a2a``)."""
    b, s, b0, s0 = layout
    top_p, top_e = _top_k(probs, min(cfg.top_k + 1, probs.shape[-1]))
    ROUTES.append(dict(used=used.reshape(b, s, -1).cpu().numpy(), top_p=top_p.reshape(b, s, -1).cpu().numpy(),
                       top_e=top_e.reshape(b, s, -1).cpu().numpy(), b0=b0, s0=s0, e0=e0, dropped=dropped))


def routes_table(records: list) -> list[dict]:
    """What :data:`ROUTES` noted on each rank of one run (``records``, one
    list a rank, one entry a layer's call, in call order), put together
    over the global batch: per call ``used`` (B, S, E) and ``top_p``,
    ``top_e`` (B, S, top_k + 1), and ``dropped`` summed over the ranks."""
    out = []
    for calls in zip(*records):
        ext = [max(c[o] + c["used"].shape[i] for c in calls) for i, o in enumerate(("b0", "s0", "e0"))]
        k1 = calls[0]["top_p"].shape[-1]
        used = np.zeros(ext, bool)
        top_p = np.zeros((*ext[:2], k1), np.float32)
        top_e = np.zeros((*ext[:2], k1), np.int64)
        for c in calls:
            b, s, e = c["used"].shape
            rows, pos = slice(c["b0"], c["b0"] + b), slice(c["s0"], c["s0"] + s)
            used[rows, pos, c["e0"] : c["e0"] + e] |= c["used"]
            top_p[rows, pos], top_e[rows, pos] = c["top_p"], c["top_e"]
        out.append(dict(used=used, top_p=top_p, top_e=top_e, dropped=sum(c["dropped"] for c in calls)))
    return out


def _moe_local(p, x_tokens, cfg, e_start: int, e_count: int, stats_axes: tuple = (), layout: tuple | None = None):
    """Token-choice MoE over experts [e_start, e_start+e_count), whose
    stacks ``p`` holds (all of them, or a rank's block).

    x_tokens: (T, D), the tokens of ``layout`` (see :func:`_note_routes`).
    Returns (out (T, D) f32 partial sum, aux loss)."""
    t, d = x_tokens.shape
    xf = x_tokens.float()
    top_w, top_e, probs = _route(p["router"], xf, cfg)
    top_scores, top_pos, valid = _dispatch(top_w, top_e, cfg, e_start, e_count)
    if ROUTES is not None and layout is not None:
        used = torch.zeros((e_count, t + 1), dtype=torch.bool, device=x_tokens.device)
        used.scatter_(1, torch.where(valid, top_pos, t), True)
        _note_routes(used[:, :t].T, probs, cfg, layout, e_start)

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
    return out, _aux(top_e, probs, cfg, stats_axes)


def _moe_local_mesh(p, x, cfg, mesh, ep_axes: tuple):
    """The JAX package's local path under a mesh (decode's one token, or
    experts that do not split over the expert axes): GSPMD routes every
    token of the global batch against every expert. A rank gathers the
    batch's tokens over the batch axes, computes its experts' share over
    all of them (all experts when it holds them all), sums the shares over
    the expert axes when the stacks are split, and keeps its rows."""
    d = x.shape[-1]
    baxes = ctx.batch_axes(mesh)
    xg = ctx.all_gather_tiled(mesh, baxes, x, dim=0)
    e_held = p["e_gate"].shape[0]
    split = e_held < cfg.n_experts
    e_start = ctx.axis_index(mesh, ep_axes[0]) * e_held if split else 0
    out, aux = _moe_local(p, xg.reshape(-1, d), cfg, e_start, e_held, layout=(*xg.shape[:2], 0, 0))
    if split:
        out = ctx.psum(mesh, ep_axes, out)
    out = ctx.block_along(mesh, baxes, out.reshape(xg.shape), dim=0)
    return out.to(x.dtype), aux


def _moe_gather(p, x, cfg, mesh, axis: str, ep: int):
    """The ``gather`` body (``repro.models.moe.moe_apply``'s shard body):
    ``x`` (B, S / ep, D), the rank's block of the sequence, all-gathered in
    bf16 along it; the rank's experts over every token of its batch block;
    the partial outputs summed over the expert axis in bf16 and scattered
    back to the rank's block (one psum-scatter, in rank order); ``aux``
    psummed over the axis / ep (each rank computed the full statistics)."""
    d = x.shape[-1]
    e_loc = cfg.n_experts // ep
    me = ctx.axis_index(mesh, axis)
    xg = ctx.all_gather_tiled(mesh, axis, x.to(BF16), 1)
    out, aux = _moe_local(p, xg.reshape(-1, d), cfg, me * e_loc, e_loc, ctx.batch_axes(mesh),
                          (*xg.shape[:2], _batch_start(mesh, x.shape[0]), 0))
    # bf16 at the collective boundary, as the JAX package sums the partials
    out = ctx.psum_scatter(mesh, axis, out.reshape(xg.shape).to(BF16), 1)
    aux = ctx.psum(mesh, axis, aux) / ep
    return out.to(x.dtype), aux


def _batch_start(mesh, b_loc: int) -> int:
    """The global index of this rank's first row of the batch."""
    idx = 0
    for a in ctx.batch_axes(mesh):  # the first axis varies slowest
        idx = idx * mesh.shape[a] + ctx.axis_index(mesh, a)
    return idx * b_loc


def _scatter_slots(n: int, idx, valid, slots):
    """(n,) long: ``slots`` where ``valid`` at each ``idx`` (the valid
    indices are distinct), -1 elsewhere; the invalid entries go to a spare
    last slot, so no write lands twice on a used one."""
    out = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    out.scatter_(0, torch.where(valid, idx, n).reshape(-1), torch.where(valid, slots, -1).reshape(-1))
    return out[:n]


def _rows(flat, picks):
    """Sum of ``flat``'s rows at each row of ``picks`` (-1 = none), in
    ascending pick order from zero, as XLA applies a scatter-add's updates."""
    flat = torch.cat([flat, flat.new_zeros(1, flat.shape[1])])  # row -1: zeros
    picks = torch.sort(picks, dim=-1).values
    out = torch.zeros((picks.shape[0], flat.shape[1]), dtype=flat.dtype, device=flat.device)
    for j in range(picks.shape[1]):
        out = out + flat[picks[:, j]]
    return out


def _moe_a2a(p, x, cfg, mesh, axis: str, ep: int):
    """The ``a2a`` body (``repro.models.moe._moe_a2a_body``): each rank
    routes the tokens of ``x`` (B, S / ep, D), its own block of the
    sequence, keeps per destination rank the top-CAP token copies by
    router weight, sends them with their expert ids and weights (three
    all-to-alls), runs its experts over what it received (top-C_in per
    expert), and sends the results home (one all-to-all), where each token
    sums its copies: the output is the rank's block. ``aux`` is pmean over
    the axis of each rank's own statistics."""
    e_loc = cfg.n_experts // ep
    xx = x.to(BF16)
    b_loc, s_loc, d = xx.shape
    t_loc, k = b_loc * s_loc, cfg.top_k
    dev = x.device
    xt = xx.reshape(t_loc, d)
    top_w, top_e, probs = _route(p["router"], xt.float(), cfg)

    # flat token copies and their destination ranks
    flat_w, flat_e = top_w.reshape(-1), top_e.reshape(-1)
    flat_pos = torch.arange(t_loc, device=dev).repeat_interleave(k)
    dest = flat_e // e_loc
    cap = max(1, int(math.ceil(t_loc * k / ep * cfg.capacity_factor)))
    score = torch.where(dest[None, :] == torch.arange(ep, device=dev)[:, None], flat_w[None, :], float("-inf"))
    sel_w, sel_i = _top_k(score, min(cap, score.shape[1]))  # (ep, CAP)
    valid = torch.isfinite(sel_w)
    send_x = torch.where(valid[..., None], xt[flat_pos[sel_i]], 0)  # (ep, CAP, D)
    send_e = torch.where(valid, flat_e[sel_i], 0)
    send_w = torch.where(valid, sel_w, 0.0)

    # exchange: recv[j] = what rank j sent to this one
    recv_x = ctx.all_to_all(mesh, axis, send_x)
    recv_e = ctx.all_to_all(mesh, axis, send_e)
    recv_w = ctx.all_to_all(mesh, axis, send_w)

    # this rank's experts over the received copies
    me = ctx.axis_index(mesh, axis)
    eids = me * e_loc + torch.arange(e_loc, device=dev)
    tokens, te, tw = recv_x.reshape(-1, d), recv_e.reshape(-1), recv_w.reshape(-1)
    escore = torch.where((te[None, :] == eids[:, None]) & (tw[None, :] > 0), tw[None, :], float("-inf"))
    c_in = max(1, int(math.ceil(ep * cap * cfg.capacity_factor / e_loc)))
    g_w, g_i = _top_k(escore, min(c_in, escore.shape[1]))  # (e_loc, C)
    g_valid = torch.isfinite(g_w)
    gathered = torch.where(g_valid[..., None], tokens[g_i], 0)
    out_e = _expert_compute(p["e_gate"], p["e_up"], p["e_down"], gathered)
    out_e = out_e.float() * torch.where(g_valid, g_w, 0.0)[..., None]
    # each received copy is one expert's: its row of out_e, or zeros
    n_in = tokens.shape[0]
    slot = _scatter_slots(n_in, g_i, g_valid, torch.arange(g_i.numel(), device=dev).reshape(g_i.shape))
    out_tokens = _rows(out_e.reshape(-1, d), slot[:, None])

    # send results home, each token summing its copies in slot order
    back = ctx.all_to_all(mesh, axis, out_tokens.reshape(ep, -1, d).to(BF16)).reshape(-1, d)
    home = _scatter_slots(t_loc * k, sel_i, valid, torch.arange(sel_i.numel(), device=dev).reshape(sel_i.shape))
    out = _rows(back.float(), home.reshape(t_loc, k))
    if ROUTES is not None:  # the copies sent, less those their receivers dropped
        used = torch.zeros((t_loc, cfg.n_experts), dtype=torch.bool, device=dev)
        used[flat_pos[sel_i][valid], flat_e[sel_i][valid]] = True
        offered = ((te[None, :] == eids[:, None]) & (tw[None, :] > 0)).sum()
        _note_routes(used, probs, cfg, (b_loc, s_loc, _batch_start(mesh, b_loc), me * s_loc), 0,
                     int(offered - g_valid.sum()))
    aux = _aux(top_e, probs, cfg, ctx.batch_axes(mesh))
    aux = ctx.pmean(mesh, axis, aux)
    return out.reshape(b_loc, s_loc, d).to(BF16).to(x.dtype), aux


def moe_apply(p, x, cfg, seq: tuple = ()):
    """x: (B, S, D), or this rank's block of positions (B, S / n, D) over
    the ``seq`` axes -> (out in x's dtype, the same positions; aux_loss).

    No mesh: the local path. Under a mesh the expert stacks' ``fsdp``
    blocks are gathered first (the rank keeps its experts), then, where the
    expert axes split the experts and the whole sequence, the
    expert-parallel body ``cfg.moe_impl`` picks (``"gather"`` or
    ``"a2a"``) on the rank's block of the sequence over the expert axis
    (``seq``, as the rules' defaults make it); otherwise (decode's one
    token, ``n_experts`` or the sequence not splitting, one expert rank)
    the local path over the global batch, on every position
    (:func:`_moe_local_mesh`)."""
    b, s, d = x.shape
    mesh = ctx.get_mesh()
    if mesh is None:
        out, aux = _moe_local(p, x.reshape(b * s, d), cfg, 0, cfg.n_experts, layout=(b, s, 0, 0))
        return out.reshape(b, s, d).to(x.dtype), aux
    s *= ctx.axis_size(mesh, seq)
    defs = layer_defs(cfg)  # the expert stacks' d dims, split over fsdp: gathered (ZeRO)
    p = dict(p, **{k: C.whole(p[k], defs[k], ("fsdp",)) for k in ("e_gate", "e_up", "e_down")})
    ep_axes = tuple(a for a in ctx.get_rules().expert if a in mesh.shape)
    ep = ctx.mesh_axis_size(*ep_axes) if ep_axes else 1
    if ep == 1 or cfg.n_experts % ep != 0 or s % ep != 0:
        out, aux = _moe_local_mesh(p, C.gather_seq(x, seq), cfg, mesh, ep_axes)
        return C.keep_seq(out, seq), aux
    if p["e_gate"].shape[0] != cfg.n_experts // ep:
        raise ValueError(f"expert stacks of {p['e_gate'].shape[0]} experts; this rank's block is {cfg.n_experts // ep}")
    if tuple(seq) != ep_axes[:1]:
        raise ValueError(f"the expert-parallel bodies take the sequence's blocks over {ep_axes[0]!r}, not over {seq}")
    body = _moe_a2a if cfg.moe_impl == "a2a" else _moe_gather
    return body(p, x, cfg, mesh, ep_axes[0], ep)


# ------------------------------------------------------------- blocks
def _block(cfg, p, x, positions, attention=None):
    """Full-sequence block -> (x, k, v, aux), the rotated keys and the
    values of every position being the cache's entries (this rank's heads
    under tensor-parallel attention, ``dense.attn_axes``) and ``aux`` the
    layer's load-balancing loss; ``x`` in and out is the rank's block of
    positions where the ``seq`` axes split them. ``attention`` is the loss path's differentiable
    one; None is ``common.chunked_attention`` (kernel F on the card),
    looked up at each call."""
    attention = attention or C.chunked_attention
    seq = ctx.seq_split(positions.shape[0])
    C.note_stream(x)
    h = C.rms_norm(x, p["ln1"])
    q, k, v = dense._qkv(cfg, p, h, seq)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    attn = attention(q, k, v, causal=cfg.causal, window=cfg.window, q_chunk=cfg.q_chunk)
    x = x + dense.attn_out(cfg, p, attn, x.dtype, seq)
    h2 = C.rms_norm(x, p["ln2"])
    mo, aux = moe_apply(p, h2, cfg, seq)
    return x + mo.to(x.dtype), k, v, aux


def block_train(cfg, p, x, positions):
    """Full-sequence block of the loss path (differentiable attention) ->
    (x, aux)."""
    x, _, _, aux = _block(cfg, p, x, positions, C.chunked_attention_train)
    return x, aux


def _block_decode(cfg, p, x, k_cache, v_cache, cur, blocks: int = 1, block: int = 0):
    """One-token block. x: (B, 1, D); caches (B, S_max, Hkv, dh), or this
    rank's block of a cache cut into ``blocks``, written in place at each
    row's ``cur``."""
    C.note_stream(x)
    h = C.rms_norm(x, p["ln1"])
    x = x + dense.decode_attention(cfg, p, h, k_cache, v_cache, cur, blocks, block).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    return x + moe_apply(p, h2, cfg)[0].to(x.dtype)


# ------------------------------------------------------------- public API
init_cache = dense.init_cache
cache_logical_axes = dense.cache_logical_axes


def loss_fn(cfg, params, batch, remat_policy: str = "dots") -> torch.Tensor:
    """The next-token cross entropy of a master tree on ``batch`` plus the
    load-balancing term, ``aux_loss_coef`` times the layers' mean aux
    loss; the aux losses are summed in float32 from 0 in layer order, as
    the JAX package's scan carries them."""
    emb = dense.embed_block(cfg, params)
    x, mask = dense._embed_inputs(cfg, params, batch, emb)
    s = mask.shape[1]
    positions = torch.arange(s, device=x.device)
    aux_sum = torch.zeros((), dtype=F32, device=x.device)
    for p in dense.layer_rows(params["layers"]):
        x, aux = dense.remat_block(remat_policy, block_train, cfg, p, x, positions)
        aux_sum = aux_sum + aux
    x = C.rms_norm(x, params["final_norm"])
    tokens = torch.as_tensor(batch["tokens"], device=x.device)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = mask & (positions < s - 1)[None, :]
    ce = dense.lm_loss(cfg, params, x, labels, mask, emb, ctx.seq_split(s))
    return ce + cfg.aux_loss_coef * aux_sum / cfg.n_layers


def prefill(cfg, model, batch, max_len: int):
    """Encode a prompt -> (last-position logits (B, V) f32, filled cache)."""
    emb = dense.embed_block(cfg, model)
    x0, mask = dense._embed_inputs(cfg, model, batch, emb)
    b, s = mask.shape
    positions = torch.arange(s, device=x0.device)
    x, cache = dense.attention_cache(cfg, b, s, max_len, x0.device, dense.layer_rows(model["layers"]),
                                     lambda p, x: _block(cfg, p, x0 if x is None else x, positions)[:3])
    x = C.rms_norm(x, model["final_norm"])
    x = C.last_position(x, ctx.seq_split(s))
    return C.head_logits(x, dense.head_block(cfg, model, emb), dense.vocab_axes(cfg)), cache


def decode_step(cfg, model, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, cache); the
    cache's k and v are written in place, as dense's are."""
    cur = cache["len"]
    blocks, block, positions = dense.cache_cut(cache)
    C.cache_room(cur, positions)
    emb = dense.embed_block(cfg, model)
    x = dense.embed_tokens(cfg, model, tokens, emb)
    for i, p in enumerate(dense.layer_rows(model["layers"])):
        x = _block_decode(cfg, p, x, cache["k"][i], cache["v"][i], cur, blocks, block)
    x = C.rms_norm(x, model["final_norm"])
    return C.head_logits(x[:, 0], dense.head_block(cfg, model, emb), dense.vocab_axes(cfg)), dict(cache, len=cur + 1)
