"""Dense GQA transformer LM of the port: training (loss and gradients)
and serving (prefill, decode, hidden states).

Counterpart of ``repro.models.dense``. The model exists in two forms:

* **Training**: the JAX package's parameter tree itself, nested dicts with
  stacked ``(L, ...)`` layer leaves, held as master tensors in the
  config's ``param_dtype`` that require gradients (:func:`master_tree`).
  The forward pass casts every matmul weight and the embedding to bf16
  where it uses them, as the JAX package does, so AdamW updates float32
  masters and an update below a bf16 ulp is kept. :func:`loss_fn` is
  the loss; its attention is the differentiable
  :func:`~repro_torch.models.common.chunked_attention_train` on every
  device, and ``remat`` picks what the backward pass recomputes.
* **Serving**: a :class:`DenseLM` holds the weights, one
  :class:`DenseBlock` per layer in a ``ModuleList``, frozen. Matmul
  weights and the embedding are held in bf16, cast once at load, so the
  numbers are those of the JAX package's cast at every matmul and the
  weights take half the memory; norm weights stay in ``param_dtype``.
  Attention is the flash kernel on the card (``models.common``).
  :func:`serving_model` turns trained masters into one.

The KV cache ``{"k", "v": (L, B, S_max, Hkv, dh) bf16, "len": (B,) int32}``
is written in place: ``prefill`` fills a new cache, and ``decode_step``
writes each row's new key and value at position ``len[b]`` of the tensors
it was given, where the JAX package's ``.at[].set`` returns new arrays.
Positions at or past a row's ``len`` are never read, so decoding twice from
one cache still gives the JAX package's answers. Under a mesh the cache
holds this rank's rows and, when the ``seq`` axes split ``max_len``, its
block of positions (``"seq_blocks"`` says how many), every head: prefill
computes K and V and keeps the block, decode writes a position only on
the rank whose block holds it, and ``common.decode_attention_cp`` merges
the blocks' partial softmax.

Under a mesh every weight is this rank's block of its leaf (the JAX
spec, ``sharding.ctx``), and the residual stream between blocks is the
rank's rows and, wherever the ``seq`` axes divide the sequence, its block
of positions (``ctx.seq_split``; JAX's sequence-parallel layout). Where
the ``tensor`` axes split ``wq``, ``wk`` and ``wv``'s columns and
``wo``'s rows into whole heads (``n_heads`` and ``n_kv_heads`` dividing;
:func:`attn_axes`, the dense and moe families), attention is
tensor-parallel: the normed input is all-gathered along the sequence, the
rank projects its own heads, kernel F runs on them over every position,
and ``wo`` is row-parallel, its float32 partial sums reduce-scattered back
to the rank's positions (``common.row_parallel``); the same for the MLP's
FFN columns (:func:`ffn_axes`). Attention whose heads do not divide
gathers the normed input and its weights and keeps its positions of the
output. Prefill all-gathers K and V over the heads before keeping its
block of the cache, and decode (one token, whole on every rank) gathers
q, k and v, runs context-parallel attention over every head and keeps its
own heads for ``wo``. The embedding and the head are used in the rank's
block of the vocabulary wherever the ``tensor`` axes divide it
(:func:`vocab_axes`; only their ``fsdp`` dim is gathered): the lookup's
rows and the logits are put together over the vocabulary
(``common.embed_tokens``, ``common.head_logits``,
``common.chunked_softmax_xent``). Every other weight dim split over
``fsdp`` or ``tensor`` is gathered just before use (``common.whole``):
the weights where heads do not divide and the front ends' projections.
"""
from __future__ import annotations

import functools
import types
from typing import Any, Mapping

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import common as C
from repro_torch.models import params as PM
from repro_torch.models.params import PDef, stack
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain

F32 = torch.float32
BF16 = torch.bfloat16
# leaves a serving model holds in bf16 (the matmul operands)
_BF16_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed", "lm_head", "patch_proj", "frame_proj",
     "mask_embed"}
)
REMAT_POLICIES = ("none", "dots", "full")


# ------------------------------------------------------------ param defs
def layer_defs(cfg) -> dict:
    """One layer's leaves, float32 as the JAX package declares them
    (``build_model`` casts them to ``param_dtype``)."""
    d, hq, hkv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    defs = {
        "ln1": PDef((d,), "ones", logical=(None,)),
        "ln2": PDef((d,), "ones", logical=(None,)),
        "wq": PDef((d, hq * dh), logical=("fsdp", "tensor")),
        "wk": PDef((d, hkv * dh), logical=("fsdp", "tensor")),
        "wv": PDef((d, hkv * dh), logical=("fsdp", "tensor")),
        "wo": PDef((hq * dh, d), logical=("tensor", "fsdp")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = PDef((dh,), "ones", logical=(None,))
        defs["k_norm"] = PDef((dh,), "ones", logical=(None,))
    if cfg.mlp == "swiglu":
        defs["w_gate"] = PDef((d, f), logical=("fsdp", "tensor"))
    defs["w_up"] = PDef((d, f), logical=("fsdp", "tensor"))
    defs["w_down"] = PDef((f, d), logical=("tensor", "fsdp"))
    return defs


@functools.lru_cache(maxsize=64)
def _defs(cfg) -> Mapping[str, PDef]:
    """:func:`layer_defs`, built once a config and read-only (the layer
    code reads it for every layer of every pass)."""
    return types.MappingProxyType(layer_defs(cfg))


def embed_def(cfg) -> PDef:
    """The token embedding's declaration (every family's)."""
    return PDef((cfg.vocab, cfg.d_model), "embed", logical=("tensor", "fsdp"))


def head_def(cfg) -> PDef:
    """The untied output head's declaration (every family's)."""
    return PDef((cfg.d_model, cfg.vocab), logical=("fsdp", "tensor"))


def model_defs(cfg) -> dict:
    d = cfg.d_model
    defs: dict[str, Any] = {
        "embed": embed_def(cfg),
        "layers": stack(layer_defs(cfg), cfg.n_layers),
        "final_norm": PDef((d,), "ones", logical=(None,)),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = head_def(cfg)
    if cfg.frontend == "vision":
        defs["patch_proj"] = PDef((cfg.frontend_dim, d), logical=("fsdp", "tensor"))
    elif cfg.frontend == "audio":
        defs["frame_proj"] = PDef((cfg.frontend_dim, d), logical=("fsdp", "tensor"))
        defs["mask_embed"] = PDef((d,), "embed", logical=(None,))
    return defs


def storage_defs(defs: dict, bf16_leaves: frozenset = _BF16_LEAVES) -> dict:
    """``defs`` (the masters' dtypes) with the serving storage dtypes: bf16
    for the matmul weights and the embedding (``bf16_leaves``), the rest as
    they are."""
    return {
        k: storage_defs(p, bf16_leaves) if isinstance(p, dict)
        else p._replace(dtype=BF16) if k in bf16_leaves else p
        for k, p in defs.items()
    }


def _dtypes(defs: dict) -> Any:
    return {k: _dtypes(v) if isinstance(v, dict) else v.dtype for k, v in defs.items()}


def _serving_dtypes(cfg) -> dict:
    return _dtypes(storage_defs(PM.param_dtype_defs(model_defs(cfg), cfg.param_dtype)))


# ------------------------------------------------------------ modules
class _Weights(nn.Module):
    """Named, frozen parameters, readable as ``p["name"]`` like the JAX
    package's param dicts; a nested dict becomes a nested ``_Weights``."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, dict):
                self.add_module(name, _Weights(t))
            else:
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def frozen(tree: dict, dtypes: dict, copy: bool = False) -> _Weights:
    """The serving weights of the moe, ssm and hybrid families: ``tree``
    (the JAX package's layout, stacked ``(L, ...)`` layer leaves) as one
    frozen :class:`_Weights` tree, each leaf cast to its storage dtype in
    ``dtypes`` (the same nesting); with ``copy`` every leaf is a copy, so
    the tree does not follow later updates of ``tree`` (training masters)."""
    def cast(node, dt):
        if isinstance(node, dict):
            return {k: cast(t, dt[k]) for k, t in node.items()}
        return node.detach().to(dt, copy=copy)

    return _Weights(cast(tree, dtypes))


def layer_rows(stacked) -> list[dict]:
    """Row ``i`` of every stacked ``(L, ...)`` leaf of ``stacked`` (a dict
    or a :class:`_Weights`), for each layer ``i``: one ``unbind`` per leaf,
    so the rows are views."""
    leaves = dict(stacked.named_parameters(recurse=False)) if isinstance(stacked, nn.Module) else stacked
    rows = {k: t.unbind(0) for k, t in leaves.items()}
    n = len(next(iter(rows.values())))
    return [{k: r[i] for k, r in rows.items()} for i in range(n)]


class DenseBlock(_Weights):
    """One transformer layer's weights."""


class DenseLM(_Weights):
    """The dense LM's serving weights: ``layers`` (a ``ModuleList`` of
    :class:`DenseBlock`), ``embed``, ``final_norm`` and, when untied,
    ``lm_head`` (and the front end's projections).

    ``tree`` is the JAX package's parameter layout with stacked ``(L, ...)``
    layer leaves; each leaf is cast to its storage dtype (bf16 for matmul
    weights) and layer ``i`` holds views of row ``i``."""

    def __init__(self, cfg, tree: dict):
        dtypes = _serving_dtypes(cfg)
        super().__init__({k: t.to(dtypes[k]) for k, t in tree.items() if k != "layers"})
        self.cfg = cfg
        layers = {k: t.to(dtypes["layers"][k]) for k, t in tree["layers"].items()}
        self.layers = nn.ModuleList(
            DenseBlock({k: t[i] for k, t in layers.items()}) for i in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self["embed"].device


def master_tree(tree: dict) -> dict:
    """``tree`` (nested dicts of tensors in the JAX layout) as training
    masters: every leaf a tensor that requires gradients."""
    return {k: master_tree(t) if isinstance(t, dict) else t.detach().requires_grad_() for k, t in tree.items()}


def serving_model(cfg, params: dict) -> DenseLM:
    """A frozen serving :class:`DenseLM` from training masters, copied (it
    does not follow later updates of the masters)."""
    def copy(node, dtypes):
        if isinstance(node, dict):
            return {k: copy(t, dtypes[k]) for k, t in node.items()}
        return node.detach().to(dtypes, copy=True)

    return DenseLM(cfg, copy(params, _serving_dtypes(cfg)))


def _layers(params) -> list:
    """Per-layer parameter views: a :class:`DenseLM`'s blocks, or row ``i``
    of every stacked leaf of a master tree. The rows come from one
    ``unbind`` per leaf, whose backward stacks the layers' gradients once;
    indexing row by row would give each row's gradient a zero-filled
    copy of the whole stacked leaf, L of them added up per leaf."""
    if isinstance(params, DenseLM):
        return list(params.layers)
    return layer_rows(params["layers"])


# ------------------------------------------------------------ layer fwd
def _tensor_axes(pdef, dim: int) -> tuple:
    """The live mesh axes the spec of ``pdef``'s leaf splits dim ``dim``
    over along its ``tensor`` axis (() without a mesh, or whole)."""
    mesh = ctx.get_mesh()
    if mesh is None or pdef.axes[dim] != "tensor":
        return ()
    axes = ctx.logical_to_spec(mesh, ctx.get_rules(), pdef.axes, pdef.shape)[dim]
    return () if axes is None else ctx._live(mesh, axes)


def attn_axes(cfg) -> tuple:
    """The mesh axes of tensor-parallel attention (the dense and moe
    families): the live axes that split ``wq``, ``wk`` and ``wv``'s columns
    and ``wo``'s rows alike, into whole heads (``n_heads`` and
    ``n_kv_heads`` both dividing); () where there is no such split, and
    the weights are gathered whole. The hybrid family always gathers: its
    heads (hymba-1.5b's 25) do not split whole over a tensor axis of 2 or
    4, and its SSM branch, on the same input, runs whole anyway."""
    if cfg.family not in ("dense", "moe") or ctx.get_mesh() is None:
        return ()
    d = _defs(cfg)
    axes = _tensor_axes(d["wq"], 1)
    if not axes or not _tensor_axes(d["wk"], 1) == _tensor_axes(d["wv"], 1) == _tensor_axes(d["wo"], 0) == axes:
        return ()
    n = ctx.axis_size(ctx.get_mesh(), axes)
    return axes if cfg.n_heads % n == 0 and cfg.n_kv_heads % n == 0 else ()


def ffn_axes(cfg) -> tuple:
    """The mesh axes of the tensor-parallel MLP (the dense family): the live
    axes that split ``w_gate`` and ``w_up``'s FFN columns and ``w_down``'s
    rows alike; () where there are none, and for the hybrid family (see
    :func:`attn_axes`)."""
    if cfg.family != "dense" or ctx.get_mesh() is None:
        return ()
    d = _defs(cfg)
    axes = _tensor_axes(d["w_up"], 1)
    cols = _tensor_axes(d["w_gate"], 1) if "w_gate" in d else axes
    return axes if axes and cols == _tensor_axes(d["w_down"], 0) == axes else ()


def _names(axes: tuple) -> tuple:
    """The logical axes to gather a weight along: ``fsdp`` alone where a
    tensor-parallel matmul takes the ``tensor`` block as it is."""
    return ("fsdp",) if axes else ("fsdp", "tensor")


def _qkv(cfg, p, h, seq: tuple = ()):
    """q (B, S, Hq, dh), k and v (B, S, Hkv, dh) of every head, or of this
    rank's heads under tensor-parallel attention (:func:`attn_axes`), at
    every position: ``h`` is the rank's block of them where ``seq`` splits
    the sequence, gathered here."""
    d, axes = _defs(cfg), attn_axes(cfg)
    hc = C.col_input(h, axes, seq)
    b, s, _ = hc.shape

    def proj(name):
        return C.col_matmul(hc, C.whole(p[name], d[name], _names(axes))).reshape(b, s, -1, cfg.head_dim)

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    if cfg.qk_norm:
        q = C.rms_norm(q, p["q_norm"])
        k = C.rms_norm(k, p["k_norm"])
    return q, k, v


def attn_out(cfg, p, attn, dtype, seq: tuple = ()):
    """The output projection of attention's heads ``attn`` (B, S, H, dh),
    every head or, under tensor-parallel attention, this rank's (``wo``
    row-parallel) -> (B, S, D) in ``dtype``, or the rank's block of
    positions (B, S / n, D) where ``seq`` splits the sequence."""
    axes = attn_axes(cfg)
    wo = C.whole(p["wo"], _defs(cfg)["wo"], _names(axes))
    return C.row_parallel(attn.reshape(attn.shape[0], attn.shape[1], -1), wo, axes, dtype, seq)


def all_heads(cfg, *ts) -> list:
    """Each of ``ts`` (B, S, H_i', dh) with every head: under
    tensor-parallel attention this rank's heads of all of them
    all-gathered in one collective, each one's heads in rank order; else
    ``ts`` as they are."""
    axes = attn_axes(cfg)
    if not axes:
        return list(ts)
    n = ctx.axis_size(ctx.get_mesh(), axes)
    widths = [t.shape[2] for t in ts]
    g = ctx.all_gather_tiled(ctx.get_mesh(), axes, torch.cat(ts, dim=2), 2)
    g = g.reshape(g.shape[0], g.shape[1], n, sum(widths), g.shape[-1])
    parts = torch.split(g, widths, dim=3)
    return [p.reshape(p.shape[0], p.shape[1], n * w, p.shape[-1]) for p, w in zip(parts, widths)]


def own_heads(cfg, t):
    """This rank's heads of ``t`` (B, S, H, dh) under tensor-parallel
    attention, else ``t``."""
    axes = attn_axes(cfg)
    return ctx.block_along(ctx.get_mesh(), axes, t, 2) if axes else t


def mlp(cfg, p, x, seq: tuple = ()):
    """``common.mlp_apply`` on this rank's weights and positions of ``x``
    (its block where ``seq`` splits the sequence): tensor-parallel where
    :func:`ffn_axes` splits the FFN (``x`` gathered along the sequence, the
    output reduce-scattered back), else on the gathered weights and the
    rank's positions."""
    d, axes = _defs(cfg), ffn_axes(cfg)
    w = {k: C.whole(p[k], d[k], _names(axes)) for k in ("w_gate", "w_up", "w_down") if k in d}
    return C.mlp_apply(w, x, cfg.mlp, axes, seq if axes else ())


def _block(cfg, p, x, positions, attention=None):
    """Full-sequence block -> (x, k, v); k and v are the rotated keys and
    the values of every position, the cache's entries (this rank's heads
    under tensor-parallel attention). ``x`` in and out is the stream as a
    rank holds it: its block of the ``len(positions)`` positions where
    ``seq`` splits them, on which the norms and residual adds run.
    ``attention`` is the loss path's differentiable one; None is
    ``common.chunked_attention`` (kernel F on the card), looked up at each
    call."""
    attention = attention or C.chunked_attention
    seq = ctx.seq_split(positions.shape[0])
    C.note_stream(x)
    h = C.rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, seq)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    attn = attention(q, k, v, causal=cfg.causal, window=cfg.window, q_chunk=cfg.q_chunk)
    x = x + attn_out(cfg, p, attn, x.dtype, seq)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + mlp(cfg, p, h2, seq).to(x.dtype)
    return x, k, v


def block_train(cfg, p, x, positions):
    """Full-sequence block of the loss path (differentiable attention).
    x: (B, S, D)."""
    return _block(cfg, p, x, positions, C.chunked_attention_train)[0]


def decode_attention(cfg, p, h, k_cache, v_cache, cur_len, blocks: int = 1, block: int = 0):
    """One token's attention from the normed ``h`` (B, 1, D) over a cache
    (B, S_max, Hkv, dh), or this rank's block of one cut into ``blocks``
    along its positions, written in place at each row's ``cur_len`` ->
    the output projection (B, 1, D) in ``h``'s dtype. Under
    tensor-parallel attention q, k and v are gathered over the heads (the
    cache holds every head), and the rank keeps its heads of the output
    for the row-parallel ``wo``."""
    q, k, v = _qkv(cfg, p, h)
    pos = cur_len[:, None]  # (B, 1)
    q, k, v = all_heads(cfg, C.apply_rope(q, pos, cfg.rope_theta), C.apply_rope(k, pos, cfg.rope_theta), v)
    C.cache_write(k_cache, k[:, 0], cur_len, blocks, block)
    C.cache_write(v_cache, v[:, 0], cur_len, blocks, block)
    attn = own_heads(cfg, C.decode_attention_cp(q, k_cache, v_cache, cur_len + 1, blocks))
    return attn_out(cfg, p, attn, h.dtype)


def block_decode(cfg, p, x, k_cache, v_cache, cur_len, blocks: int = 1, block: int = 0):
    """One-token block. x: (B, 1, D); caches (B, S_max, Hkv, dh), or this
    rank's block of a cache cut into ``blocks`` along its positions,
    written in place at each row's ``cur_len``."""
    C.note_stream(x)
    h = C.rms_norm(x, p["ln1"])
    x = x + decode_attention(cfg, p, h, k_cache, v_cache, cur_len, blocks, block).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + mlp(cfg, p, h2).to(x.dtype)
    return x


# ------------------------------------------------------------- backbone
def _device(params) -> torch.device:
    return params["embed"].device


def vocab_axes(cfg) -> tuple:
    """The live mesh axes that split the vocabulary of the embedding and
    the head (their JAX spec's ``tensor`` axes; () without a mesh or where
    they do not divide ``vocab``, and then both are used whole)."""
    return _tensor_axes(embed_def(cfg), 0)


def embed_block(cfg, params) -> torch.Tensor:
    """The rank's block of the token embedding along the vocabulary (the
    whole table where :func:`vocab_axes` is ()), whole along the model dim
    (its ``fsdp`` blocks gathered), in its storage dtype: the lookup casts
    the rows it reads, as the JAX package does."""
    p = embed_def(cfg)
    return ctx.gather_dims(params["embed"], p.axes, p.shape, ("fsdp",))


def head_block(cfg, params, emb=None):
    """The output head (D, V) in the rank's block of the vocabulary (D, V /
    n) where :func:`vocab_axes` splits it: the embedding's block
    transposed when tied (``emb``, :func:`embed_block`'s, where the caller
    has it), else ``lm_head``'s ``fsdp`` blocks gathered in bf16."""
    if cfg.tie_embeddings:
        return (embed_block(cfg, params) if emb is None else emb).T
    return C.whole(params["lm_head"], head_def(cfg), ("fsdp",))


def embed_tokens(cfg, params, tokens, emb=None, seq: tuple = ()):
    """``common.embed_tokens`` on the rank's block of the vocabulary
    (``emb``, :func:`embed_block`'s, where the caller has it): the rows of
    ``tokens`` (B, S), this rank's positions of them where ``seq`` splits
    the sequence."""
    tokens = torch.as_tensor(tokens, device=_device(params))
    return C.embed_tokens(embed_block(cfg, params) if emb is None else emb, tokens, vocab_axes(cfg), seq)


def _embed_inputs(cfg, params, batch, emb=None):
    """Token (+ modality-prefix) embedding -> (x bf16, loss_mask): ``x`` the
    stream's first value as a rank holds it (its block of positions where
    the ``seq`` axes split the sequence), the mask whole; ``emb`` is
    :func:`embed_block`'s where the caller has it.

    Audio (hubert): the frames ``(B, S, frontend_dim)`` through
    ``frame_proj``, each frame of ``frame_mask`` replaced by ``mask_embed``;
    the loss mask is ``frame_mask``. Vision: ``patch_embeds`` ``(B, P,
    frontend_dim)`` through ``patch_proj`` replace the first P token
    positions, which the loss mask leaves out."""
    dev = _device(params)
    if cfg.frontend == "audio":
        frames = torch.as_tensor(batch["frames"], device=dev).to(BF16)
        x = frames @ C.whole(params["frame_proj"], model_defs(cfg)["frame_proj"])
        m = torch.as_tensor(batch["frame_mask"], device=dev).bool()
        # HuBERT masking: replace masked frames with the learned embedding
        x = torch.where(m[..., None], params["mask_embed"].to(BF16), x)
        return constrain(x, "batch", "seq", None), m  # loss only on masked frames
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    mask = torch.ones(tokens.shape, dtype=torch.bool, device=dev)
    if cfg.frontend != "vision":
        return embed_tokens(cfg, params, tokens, emb, ctx.seq_split(tokens.shape[1])), mask
    x = embed_tokens(cfg, params, tokens, emb)
    patches = torch.as_tensor(batch["patch_embeds"], device=dev).to(BF16)
    pre = patches @ C.whole(params["patch_proj"], model_defs(cfg)["patch_proj"])
    x = torch.cat([pre, x[:, pre.shape[1] :]], dim=1)
    mask[:, : pre.shape[1]] = False
    return constrain(x, "batch", "seq", None), mask


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the batch-free matmuls
    (activations times a weight), recompute the rest, as
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does;
    attention's einsums are batched (``bmm``) and recomputed."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_matmuls)


def remat_block(remat_policy: str, block, *args):
    """``block(*args)`` on the loss path, whatever it returns (dense's,
    mamba2's and hymba's ``x``, moe's ``(x, aux)``), with ``remat_policy``
    setting what its backward pass recomputes: ``"none"`` nothing, ``"dots"``
    all but the weight matmuls' outputs, ``"full"`` the whole block
    (``torch.utils.checkpoint``, non-reentrant; the JAX package's
    ``jax.checkpoint`` around the scan body). The policy changes memory,
    never numbers."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not one of {REMAT_POLICIES}")
    if remat_policy == "none":
        return block(*args)
    kw = dict(context_fn=_dots_context) if remat_policy == "dots" else {}
    return checkpoint(block, *args, use_reentrant=False, **kw)


def _run_layers(cfg, params, x, positions, remat_policy: str | None = None):
    """Every block, then the final norm: the hidden states (B, S, D).

    ``remat_policy=None`` is the inference pass: kernel F on the card, no
    checkpoints (the datastore, the hook's query and serving take it).
    ``"none"``, ``"dots"`` or ``"full"`` is the loss path's pass, with the
    differentiable attention, each block under :func:`remat_block`."""
    for p in _layers(params):
        if remat_policy is None:
            x = _block(cfg, p, x, positions)[0]
        else:
            x = remat_block(remat_policy, block_train, cfg, p, x, positions)
    return C.rms_norm(x, params["final_norm"])


def lm_loss(cfg, params, x, labels, mask, emb=None, seq: tuple = (), skip: int = 0) -> torch.Tensor:
    """``common.chunked_softmax_xent`` of the final hidden states ``x``
    (the rank's block of positions over ``seq``; the first ``skip`` have no
    label) on the rank's block of the head (:func:`head_block`)."""
    return C.chunked_softmax_xent(x, head_block(cfg, params, emb), labels, mask, cfg.loss_chunk, vocab_axes(cfg),
                                  seq, skip)


def loss_fn(cfg, params, batch, remat_policy: str = "dots") -> torch.Tensor:
    """Mean cross entropy of a master tree on ``batch``: hubert's masked
    prediction of ``targets`` on the masked frames when the batch has
    them, else the next-token objective (labels are the tokens shifted by
    one; the last position is left out)."""
    emb = None if cfg.frontend == "audio" else embed_block(cfg, params)
    x, mask = _embed_inputs(cfg, params, batch, emb)
    s = mask.shape[1]
    positions = torch.arange(s, device=x.device)
    x = _run_layers(cfg, params, x, positions, remat_policy)
    if "targets" in batch:  # masked-prediction objective (hubert)
        labels = torch.as_tensor(batch["targets"], device=x.device)
    else:  # next-token LM objective
        tokens = torch.as_tensor(batch["tokens"], device=x.device)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = mask & (positions < s - 1)[None, :]
    return lm_loss(cfg, params, x, labels, mask, emb, ctx.seq_split(s))


# ------------------------------------------------------------- public API
def init_cache(cfg, batch_size: int, max_len: int, dtype=BF16, device=None) -> dict:
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def cache_logical_axes(cfg) -> dict:
    return {
        "k": (None, "batch", "seq", None, None),
        "v": (None, "batch", "seq", None, None),
        "len": ("batch",),
    }


def attention_cache(cfg, b: int, s: int, max_len: int, device, layers, block_fn) -> tuple:
    """The prefill of the attention families: ``block_fn(p, x)`` over every
    layer ``p`` of ``layers`` -> (x, k, v), its keys and values (this
    rank's heads under tensor-parallel attention, gathered here) put in a
    new cache of ``max_len`` positions, or this rank's block of one under a
    mesh (``common.seq_cut``; the cache then carries ``"seq_blocks"``).
    Returns (x, cache) with ``len`` at ``s``."""
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    blocks, block = C.seq_cut(max_len)
    cache = init_cache(cfg, b, max_len // blocks, device=device)
    x = None
    for i, p in enumerate(layers):
        x, k, v = block_fn(p, x)
        k, v = all_heads(cfg, k, v)
        C.cache_fill(cache["k"][i], k, blocks, block)
        C.cache_fill(cache["v"][i], v, blocks, block)
    cache["len"].fill_(s)
    if ctx.get_mesh() is not None:
        cache["seq_blocks"] = blocks
    return x, cache


def cache_cut(cache: dict, key: str = "k") -> tuple[int, int, int]:
    """(blocks, this rank's block, the positions of the whole cache) of an
    attention cache, whose ``key`` leaf is (L, B, S_loc, Hkv, dh)."""
    blocks = cache.get("seq_blocks", 1)
    positions = cache[key].shape[2] * blocks
    return blocks, C.seq_cut(positions)[1] if blocks > 1 else 0, positions


def prefill(cfg, model, batch, max_len: int):
    """Encode a prompt -> (last-position logits (B, V) f32, filled cache)."""
    emb = embed_block(cfg, model)
    x0, mask = _embed_inputs(cfg, model, batch, emb)
    b, s = mask.shape
    positions = torch.arange(s, device=x0.device)
    x, cache = attention_cache(cfg, b, s, max_len, x0.device, _layers(model),
                               lambda p, x: _block(cfg, p, x0 if x is None else x, positions))
    x = C.rms_norm(x, model["final_norm"])
    logits = C.head_logits(C.last_position(x, ctx.seq_split(s)), head_block(cfg, model, emb), vocab_axes(cfg))
    return logits, cache


def decode_step(cfg, model, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, cache); the
    returned cache holds the same k and v tensors, written in place, and
    ``len + 1``. Raises when a row's cache is full (the JAX package drops
    that write)."""
    cur = cache["len"]
    blocks, block, positions = cache_cut(cache)
    C.cache_room(cur, positions)
    emb = embed_block(cfg, model)
    x = embed_tokens(cfg, model, tokens, emb)
    for i, p in enumerate(_layers(model)):
        x = block_decode(cfg, p, x, cache["k"][i], cache["v"][i], cur, blocks, block)
    x = C.rms_norm(x, model["final_norm"])
    return C.head_logits(x[:, 0], head_block(cfg, model, emb), vocab_axes(cfg)), dict(cache, len=cur + 1)
