"""Dense GQA transformer LM of the port (forward: prefill, decode, hidden
states).

Counterpart of ``repro.models.dense`` for token inputs. A
:class:`DenseLM` holds the weights, one :class:`DenseBlock` per layer in a
``ModuleList``. Matmul weights (and the embedding) are held in bf16, cast
once at load: the JAX package keeps float32 weights and casts them to bf16
at every matmul, so the numbers are the same and the weights take half the
memory. Norm weights stay float32 (the config's ``param_dtype`` when it is
narrower). Large products are ``torch.matmul``; attention is the flash
kernel on the card (``models.common``).

The KV cache ``{"k", "v": (L, B, S_max, Hkv, dh) bf16, "len": (B,) int32}``
is written in place: ``prefill`` fills a new cache, and ``decode_step``
writes each row's new key and value at position ``len[b]`` of the tensors
it was given, where the JAX package's ``.at[].set`` returns new arrays.
Positions at or past a row's ``len`` are never read, so decoding twice from
one cache still gives the JAX package's answers.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.models import common as C
from repro_torch.models.params import PDef, stack

F32 = torch.float32
BF16 = torch.bfloat16
_NOT_PORTED = "is not ported to PyTorch yet (see ROADMAP.md, Queue 1)"


# ------------------------------------------------------------ param defs
def _norm_dtype(cfg) -> torch.dtype:
    return BF16 if cfg.param_dtype == "bfloat16" else F32


def layer_defs(cfg) -> dict:
    d, hq, hkv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    nd = _norm_dtype(cfg)
    defs = {
        "ln1": PDef((d,), "ones", nd),
        "ln2": PDef((d,), "ones", nd),
        "wq": PDef((d, hq * dh), dtype=BF16),
        "wk": PDef((d, hkv * dh), dtype=BF16),
        "wv": PDef((d, hkv * dh), dtype=BF16),
        "wo": PDef((hq * dh, d), dtype=BF16),
    }
    if cfg.qk_norm:
        defs["q_norm"] = PDef((dh,), "ones", nd)
        defs["k_norm"] = PDef((dh,), "ones", nd)
    if cfg.mlp == "swiglu":
        defs["w_gate"] = PDef((d, f), dtype=BF16)
    defs["w_up"] = PDef((d, f), dtype=BF16)
    defs["w_down"] = PDef((f, d), dtype=BF16)
    return defs


def model_defs(cfg) -> dict:
    d, v = cfg.d_model, cfg.vocab
    nd = _norm_dtype(cfg)
    defs: dict[str, Any] = {
        "embed": PDef((v, d), "embed", BF16),
        "layers": stack(layer_defs(cfg), cfg.n_layers),
        "final_norm": PDef((d,), "ones", nd),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((d, v), dtype=BF16)
    if cfg.frontend == "vision":
        defs["patch_proj"] = PDef((cfg.frontend_dim, d), dtype=BF16)
    elif cfg.frontend == "audio":
        defs["frame_proj"] = PDef((cfg.frontend_dim, d), dtype=BF16)
        defs["mask_embed"] = PDef((d,), "embed", BF16)
    return defs


def _storage_dtype(p: PDef | dict) -> Any:
    return {k: _storage_dtype(v) for k, v in p.items()} if isinstance(p, dict) else p.dtype


# ------------------------------------------------------------ modules
class _Weights(nn.Module):
    """Named, frozen parameters, readable as ``p["name"]`` like the JAX
    package's param dicts."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class DenseBlock(_Weights):
    """One transformer layer's weights."""


class DenseLM(_Weights):
    """The dense LM's weights: ``layers`` (a ``ModuleList`` of
    :class:`DenseBlock`), ``embed``, ``final_norm`` and, when untied,
    ``lm_head``.

    ``tree`` is the JAX package's parameter layout with stacked ``(L, ...)``
    layer leaves; each leaf is cast to its storage dtype (bf16 for matmul
    weights) and layer ``i`` holds views of row ``i``."""

    def __init__(self, cfg, tree: dict):
        dtypes = _storage_dtype(model_defs(cfg))
        super().__init__({k: t.to(dtypes[k]) for k, t in tree.items() if k != "layers"})
        self.cfg = cfg
        layers = {k: t.to(dtypes["layers"][k]) for k, t in tree["layers"].items()}
        self.layers = nn.ModuleList(
            DenseBlock({k: t[i] for k, t in layers.items()}) for i in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self["embed"].device


# ------------------------------------------------------------ layer fwd
def _qkv(cfg, p, h):
    b, s, _ = h.shape
    hc = h.to(BF16)
    q = (hc @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (hc @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (hc @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = C.rms_norm(q, p["q_norm"])
        k = C.rms_norm(k, p["k_norm"])
    return q, k, v


def _block(cfg, p, x, positions):
    """Full-sequence block -> (x, k, v); k and v are the rotated keys and
    the values, the cache's entries."""
    h = C.rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    attn = C.chunked_attention(
        q, k, v, causal=cfg.causal, window=cfg.window, q_chunk=cfg.q_chunk
    )
    attn = attn.reshape(x.shape[0], x.shape[1], -1)
    x = x + (attn.to(BF16) @ p["wo"]).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + C.mlp_apply(p, h2, cfg.mlp).to(x.dtype)
    return x, k, v


def block_train(cfg, p, x, positions):
    """Full-sequence block (encoding; forward only). x: (B, S, D)."""
    return _block(cfg, p, x, positions)[0]


def block_decode(cfg, p, x, k_cache, v_cache, cur_len):
    """One-token block. x: (B, 1, D); caches (B, S_max, Hkv, dh), written in
    place at each row's ``cur_len``."""
    b = x.shape[0]
    h = C.rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h)
    pos = cur_len[:, None]  # (B, 1)
    q = C.apply_rope(q, pos, cfg.rope_theta)
    k = C.apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    k_cache[rows, cur_len.long()] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, cur_len.long()] = v[:, 0].to(v_cache.dtype)
    attn = C.decode_attention_cp(q, k_cache, v_cache, cur_len + 1)
    attn = attn.reshape(b, 1, -1)
    x = x + (attn.to(BF16) @ p["wo"]).to(x.dtype)
    h2 = C.rms_norm(x, p["ln2"])
    x = x + C.mlp_apply(p, h2, cfg.mlp).to(x.dtype)
    return x


# ------------------------------------------------------------- backbone
def _embed_inputs(cfg, model, batch):
    """Token embedding -> (x, loss_mask). The vision and audio front ends
    are not ported."""
    if cfg.frontend is not None:
        raise NotImplementedError(f"the {cfg.frontend} front end {_NOT_PORTED}")
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = C.embed_tokens(model["embed"], tokens)
    return x, torch.ones(tokens.shape, dtype=torch.bool, device=x.device)


def _run_layers(cfg, model, x, positions):
    """Every block, then the final norm: the hidden states (B, S, D)."""
    for p in model.layers:
        x = block_train(cfg, p, x, positions)
    return C.rms_norm(x, model["final_norm"])


def _lm_head(cfg, model):
    return model["embed"].T if cfg.tie_embeddings else model["lm_head"]


# ------------------------------------------------------------- public API
def init_cache(cfg, batch_size: int, max_len: int, dtype=BF16, device=None) -> dict:
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def prefill(cfg, model, batch, max_len: int):
    """Encode a prompt -> (last-position logits (B, V) f32, filled cache)."""
    x, _ = _embed_inputs(cfg, model, batch)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, p in enumerate(model.layers):
        x, k, v = _block(cfg, p, x, positions)
        cache["k"][i, :, :s] = k.to(BF16)
        cache["v"][i, :, :s] = v.to(BF16)
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, -1].to(BF16) @ _lm_head(cfg, model)).to(F32)
    cache["len"].fill_(s)
    return logits, cache


def decode_step(cfg, model, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, cache); the
    returned cache holds the same k and v tensors, written in place, and
    ``len + 1``. Raises when a row's cache is full (the JAX package drops
    that write)."""
    tokens = torch.as_tensor(tokens, device=model.device)
    cur = cache["len"]
    if int(cur.max()) >= cache["k"].shape[2]:
        raise ValueError(f"a row's cache is full ({cache['k'].shape[2]} positions)")
    x = C.embed_tokens(model["embed"], tokens)
    for i, p in enumerate(model.layers):
        x = block_decode(cfg, p, x, cache["k"][i], cache["v"][i], cur)
    x = C.rms_norm(x, model["final_norm"])
    logits = (x[:, 0].to(BF16) @ _lm_head(cfg, model)).to(F32)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cur + 1}
