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
block of positions (``"seq_blocks"`` says how many): prefill computes K
and V whole and keeps the block, decode writes a position only on the
rank whose block holds it, and ``common.decode_attention_cp`` merges the
blocks' partial softmax.
"""
from __future__ import annotations

from typing import Any

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


def model_defs(cfg) -> dict:
    d, v = cfg.d_model, cfg.vocab
    defs: dict[str, Any] = {
        "embed": PDef((v, d), "embed", logical=("tensor", "fsdp")),
        "layers": stack(layer_defs(cfg), cfg.n_layers),
        "final_norm": PDef((d,), "ones", logical=(None,)),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((d, v), logical=("fsdp", "tensor"))
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
def _qkv(cfg, p, h):
    b, s, _ = h.shape
    hc = h.to(BF16)
    q = (hc @ p["wq"].to(BF16)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (hc @ p["wk"].to(BF16)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (hc @ p["wv"].to(BF16)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = C.rms_norm(q, p["q_norm"])
        k = C.rms_norm(k, p["k_norm"])
    return q, k, v


def _block(cfg, p, x, positions, attention=None):
    """Full-sequence block -> (x, k, v); k and v are the rotated keys and
    the values, the cache's entries. ``attention`` is the loss path's
    differentiable one; None is ``common.chunked_attention`` (kernel F on
    the card), looked up at each call."""
    attention = attention or C.chunked_attention
    h = C.rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    attn = attention(q, k, v, causal=cfg.causal, window=cfg.window, q_chunk=cfg.q_chunk)
    attn = attn.reshape(x.shape[0], x.shape[1], -1)
    x = x + (attn.to(BF16) @ p["wo"].to(BF16)).to(x.dtype)
    x = constrain(x, "batch", "seq", None)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + C.mlp_apply(p, h2, cfg.mlp).to(x.dtype)
    return constrain(x, "batch", "seq", None), k, v


def block_train(cfg, p, x, positions):
    """Full-sequence block of the loss path (differentiable attention).
    x: (B, S, D)."""
    return _block(cfg, p, x, positions, C.chunked_attention_train)[0]


def block_decode(cfg, p, x, k_cache, v_cache, cur_len, blocks: int = 1, block: int = 0):
    """One-token block. x: (B, 1, D); caches (B, S_max, Hkv, dh), or this
    rank's block of a cache cut into ``blocks`` along its positions,
    written in place at each row's ``cur_len``."""
    b = x.shape[0]
    h = C.rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h)
    pos = cur_len[:, None]  # (B, 1)
    q = C.apply_rope(q, pos, cfg.rope_theta)
    k = C.apply_rope(k, pos, cfg.rope_theta)
    C.cache_write(k_cache, k[:, 0], cur_len, blocks, block)
    C.cache_write(v_cache, v[:, 0], cur_len, blocks, block)
    attn = C.decode_attention_cp(q, k_cache, v_cache, cur_len + 1, blocks)
    attn = attn.reshape(b, 1, -1)
    x = x + (attn.to(BF16) @ p["wo"].to(BF16)).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + C.mlp_apply(p, h2, cfg.mlp).to(x.dtype)
    return x


# ------------------------------------------------------------- backbone
def _device(params) -> torch.device:
    return params["embed"].device


def _embed_inputs(cfg, params, batch):
    """Token (+ modality-prefix) embedding -> (x bf16, loss_mask).

    Audio (hubert): the frames ``(B, S, frontend_dim)`` through
    ``frame_proj``, each frame of ``frame_mask`` replaced by ``mask_embed``;
    the loss mask is ``frame_mask``. Vision: ``patch_embeds`` ``(B, P,
    frontend_dim)`` through ``patch_proj`` replace the first P token
    positions, which the loss mask leaves out."""
    dev = _device(params)
    if cfg.frontend == "audio":
        frames = torch.as_tensor(batch["frames"], device=dev).to(BF16)
        x = frames @ params["frame_proj"].to(BF16)
        m = torch.as_tensor(batch["frame_mask"], device=dev).bool()
        # HuBERT masking: replace masked frames with the learned embedding
        x = torch.where(m[..., None], params["mask_embed"].to(BF16), x)
        return constrain(x, "batch", "seq", None), m  # loss only on masked frames
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = C.embed_tokens(params["embed"], tokens)
    mask = torch.ones(tokens.shape, dtype=torch.bool, device=dev)
    if cfg.frontend == "vision":
        patches = torch.as_tensor(batch["patch_embeds"], device=dev).to(BF16)
        pre = patches @ params["patch_proj"].to(BF16)
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


def _lm_head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def loss_fn(cfg, params, batch, remat_policy: str = "dots") -> torch.Tensor:
    """Mean cross entropy of a master tree on ``batch``: hubert's masked
    prediction of ``targets`` on the masked frames when the batch has
    them, else the next-token objective (labels are the tokens shifted by
    one; the last position is left out)."""
    x, mask = _embed_inputs(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    x = _run_layers(cfg, params, x, positions, remat_policy)
    if "targets" in batch:  # masked-prediction objective (hubert)
        labels = torch.as_tensor(batch["targets"], device=x.device)
    else:  # next-token LM objective
        tokens = torch.as_tensor(batch["tokens"], device=x.device)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = mask & (positions < s - 1)[None, :]
    return C.chunked_softmax_xent(x, _lm_head(cfg, params), labels, mask, cfg.loss_chunk)


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
    layer ``p`` of ``layers`` -> (x, k, v), its keys and values put in a
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
    x0, _ = _embed_inputs(cfg, model, batch)
    b, s, _ = x0.shape
    positions = torch.arange(s, device=x0.device)
    x, cache = attention_cache(cfg, b, s, max_len, x0.device, _layers(model),
                               lambda p, x: _block(cfg, p, x0 if x is None else x, positions))
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, -1].to(BF16) @ _lm_head(cfg, model).to(BF16)).to(F32)
    return logits, cache


def decode_step(cfg, model, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, cache); the
    returned cache holds the same k and v tensors, written in place, and
    ``len + 1``. Raises when a row's cache is full (the JAX package drops
    that write)."""
    tokens = torch.as_tensor(tokens, device=_device(model))
    cur = cache["len"]
    blocks, block, positions = cache_cut(cache)
    C.cache_room(cur, positions)
    x = C.embed_tokens(model["embed"], tokens)
    for i, p in enumerate(_layers(model)):
        x = block_decode(cfg, p, x, cache["k"][i], cache["v"][i], cur, blocks, block)
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, 0].to(BF16) @ _lm_head(cfg, model).to(BF16)).to(F32)
    return logits, dict(cache, len=cur + 1)
