"""Model configuration, registry and the (architecture x input-shape)
cell contract of the port.

Counterpart of ``repro.models.api``: the same :class:`ModelConfig` (same
fields and defaults), ``SHAPE_CELLS``, ``cell_skip_reason`` and
``build_model(cfg)``, which returns a handle with ``cfg``, ``defs`` (the
masters' declarations, float32 leaves cast to ``param_dtype`` as the JAX
package casts them), ``n_params``, ``init``, ``init_masters``,
``serving``, ``loss_fn``, ``prefill``, ``decode_step``, ``init_cache`` and
``input_defs``, and the JAX handle's sharding helpers: ``param_specs``,
``param_structs``, ``input_specs``, ``cache_structs`` and
``cache_logical_axes`` (structs are ``meta`` tensors with a ``sharding``
attribute, see ``models.params.struct``). All four families (``dense``,
``moe``, ``ssm``, ``hybrid``) serve and train, on one device or under an
ambient mesh (``sharding.ctx.use_mesh``), where every function takes and
returns this rank's blocks under the JAX spec, ``fsdp`` and ``tensor``
dims split too (``sharding.ctx``): ``init`` and ``init_masters`` draw each
leaf whole and keep the rank's block, so a rank holds the values the
one-process model holds there; ``param_structs``, ``input_specs`` and
``cache_structs`` carry those blocks' shardings.

The weights come in two forms, each drawn from a ``torch.Generator``
seeded with ``seed`` on ``device`` (the card unless told otherwise):

* ``init(seed, device=None)`` returns the frozen serving model (a
  ``torch.nn.Module``: ``dense.DenseLM``, or for the other families one
  ``dense.frozen`` tree in the JAX layout, see :func:`serving_weights`),
  which ``prefill(params, batch, max_len)`` and ``decode_step(params,
  cache, tokens)`` take as their ``params``, as the JAX handle takes its
  param tree.
* ``init_masters(seed, device=None)`` returns the training masters, the
  JAX package's tree in ``param_dtype``, requiring gradients;
  ``loss_fn(params, batch)`` takes them, with the config's ``remat``, and
  ``serving(params)`` turns them into a serving model.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from repro_torch import device as device_mod
from repro_torch.models import params as PM
from repro_torch.sharding import ctx

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    qk_norm: bool = False
    causal: bool = True  # False => encoder-only (no decode)
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    window: int | None = None
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    moe_impl: str = "gather"  # gather (psum-combine) | a2a (all-to-all dispatch)
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    conv_kernel: int = 4
    global_layers: tuple = ()
    meta_tokens: int = 0
    # modality frontends (stubs per assignment: precomputed embeddings)
    frontend: str | None = None  # vision | audio
    frontend_dim: int = 0
    frontend_len: int = 0  # patches for vision
    # perf knobs
    q_chunk: int = 512
    loss_chunk: int = 512
    remat: str = "dots"  # none | dots | full
    microbatches: int = 1  # gradient-accumulation splits of the global batch
    param_dtype: str = "float32"  # canonical parameter dtype (bfloat16 for XXL)
    opt_state_bits: int = 32  # 8 => blockwise-int8 Adam moments (XXL models)
    grad_accum_dtype: str = "float32"  # microbatch grad accumulator dtype
    # capability flags
    sub_quadratic: bool = False

    @property
    def supports_decode(self) -> bool:
        return self.causal


# Shape cells assigned to every LM arch (seq_len, global_batch, kind)
SHAPE_CELLS = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def cell_skip_reason(cfg: ModelConfig, cell: str) -> str | None:
    """None if the (arch, cell) pair runs; otherwise the documented skip."""
    c = SHAPE_CELLS[cell]
    if c["kind"] == "decode" and not cfg.supports_decode:
        return "encoder-only arch: no decode step"
    if cell == "long_500k" and not cfg.sub_quadratic:
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


def _family_module(cfg: ModelConfig):
    from repro_torch.models import dense, hymba, mamba2, moe

    return {"dense": dense, "moe": moe, "ssm": mamba2, "hybrid": hymba}[cfg.family]


def serving_weights(cfg: ModelConfig, tree: dict, copy: bool = False) -> torch.nn.Module:
    """The frozen serving model of ``cfg`` from ``tree`` (the JAX package's
    parameter layout, nested dicts with stacked ``(L, ...)`` layer leaves),
    each leaf cast to its storage dtype: bf16 for the matmul weights and
    the embeddings, ``param_dtype`` for the rest. With ``copy`` (training
    masters) the model holds copies, and does not follow later updates of
    ``tree``."""
    from repro_torch.models import dense

    mod = _family_module(cfg)
    if mod is dense:
        return dense.serving_model(cfg, tree) if copy else dense.DenseLM(cfg, tree)
    defs = mod.storage_defs(PM.param_dtype_defs(mod.model_defs(cfg), cfg.param_dtype))
    return dense.frozen(tree, dense._dtypes(defs), copy)


def build_model(cfg: ModelConfig) -> SimpleNamespace:
    from repro_torch.models import dense

    mod = _family_module(cfg)
    defs = PM.param_dtype_defs(mod.model_defs(cfg), cfg.param_dtype)

    def draw(seed: int, device, leaf_defs: dict) -> dict:
        mesh = ctx.get_mesh()
        keep = None if mesh is None else (lambda p, t: PM.sharding_of(p, mesh).block(t).clone())
        return PM.init_params(leaf_defs, torch.Generator(device_mod.resolve(device)).manual_seed(seed), keep)

    def init(seed: int, device: str | torch.device | None = None):
        return serving_weights(cfg, draw(seed, device, mod.storage_defs(defs)))

    def init_masters(seed: int, device: str | torch.device | None = None) -> dict:
        return dense.master_tree(draw(seed, device, defs))

    def input_defs(cell: str) -> dict:
        """Model inputs for a cell as ``name -> (shape, dtype)``."""
        c = SHAPE_CELLS[cell]
        s, b = c["seq"], c["batch"]
        if c["kind"] == "decode":
            return {"tokens": ((b, 1), torch.int32)}
        if cfg.frontend == "audio":
            return {
                "frames": ((b, s, cfg.frontend_dim), torch.float32),
                "frame_mask": ((b, s), torch.bool),
                "targets": ((b, s), torch.int32),
            }
        io = {"tokens": ((b, s), torch.int32)}
        if cfg.frontend == "vision":
            io["patch_embeds"] = ((b, cfg.frontend_len, cfg.frontend_dim), torch.float32)
        return io

    def input_logical(cell: str) -> dict:
        """Each input's logical axes: the batch on dim 0, the rest whole."""
        return {k: ("batch",) + (None,) * (len(shape) - 1) for k, (shape, _) in input_defs(cell).items()}

    def input_specs(cell: str, mesh=None) -> dict:
        """Each input of ``cell`` as a struct (``models.params.struct``),
        with its sharding on ``mesh`` (or the ambient one)."""
        mesh = mesh or ctx.get_mesh()
        logical = input_logical(cell)
        return {
            k: PM.struct(shape, dtype, None if mesh is None else ctx.sharding_for(mesh, logical[k], shape))
            for k, (shape, dtype) in input_defs(cell).items()
        }

    def cache_structs(cell: str, mesh=None) -> dict:
        """The decode cache of ``cell`` (global batch, ``seq`` positions) as
        structs, with each leaf's sharding on ``mesh`` (or the ambient one)."""
        c = SHAPE_CELLS[cell]
        cache = mod.init_cache(cfg, c["batch"], c["seq"], device="meta")
        mesh = mesh or ctx.get_mesh()

        def leafify(t, logical):
            if isinstance(t, dict):
                return {k: leafify(t[k], logical[k]) for k in t}
            return PM.struct(t.shape, t.dtype, None if mesh is None else ctx.sharding_for(mesh, logical, t.shape))

        return leafify(cache, mod.cache_logical_axes(cfg))

    return SimpleNamespace(
        cfg=cfg,
        defs=defs,
        param_specs=lambda: PM.param_specs(defs),
        param_structs=lambda mesh=None: PM.param_structs(defs, mesh),
        input_specs=input_specs,
        cache_structs=cache_structs,
        cache_logical_axes=lambda: mod.cache_logical_axes(cfg),
        init=init,
        init_masters=init_masters,
        serving=lambda params: serving_weights(cfg, params, copy=True),
        n_params=PM.count_params(defs),
        loss_fn=lambda params, batch: mod.loss_fn(cfg, params, batch, cfg.remat),
        input_defs=input_defs,
        prefill=lambda params, batch, max_len: mod.prefill(cfg, params, batch, max_len),
        decode_step=lambda params, cache, tokens: mod.decode_step(cfg, params, cache, tokens),
        init_cache=lambda b, s, device=None: mod.init_cache(cfg, b, s, device=device_mod.resolve(device)),
    )
