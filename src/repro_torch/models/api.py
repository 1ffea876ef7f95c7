"""Model configuration and registry of the port.

Counterpart of ``repro.models.api``: the same :class:`ModelConfig` (same
fields and defaults) and ``build_model(cfg)``, which returns a handle with
``cfg``, ``n_params``, ``init``, ``prefill``, ``decode_step`` and
``init_cache``. Only the dense family is ported; ``moe``, ``ssm`` and
``hybrid`` raise ``NotImplementedError``. The JAX package's sharding
helpers (param specs, structs, input specs, cache structs) have no
counterpart here.

``init(seed, device=None)`` draws the weights from a ``torch.Generator``
seeded with ``seed`` on ``device`` (the card unless told otherwise) and
returns the model (a ``torch.nn.Module``), which ``prefill(params, batch,
max_len)`` and ``decode_step(params, cache, tokens)`` take as their
``params``, as the JAX handle takes its param tree.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from repro_torch import device as device_mod
from repro_torch.models import params as PM

_NOT_PORTED = "is not ported to PyTorch yet (see ROADMAP.md, Queue 1)"


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


def _family_module(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family!r} model family {_NOT_PORTED}")
    from repro_torch.models import dense

    return dense


def build_model(cfg: ModelConfig) -> SimpleNamespace:
    mod = _family_module(cfg)
    defs = mod.model_defs(cfg)

    def init(seed: int, device: str | torch.device | None = None):
        gen = torch.Generator(device_mod.resolve(device)).manual_seed(seed)
        return mod.DenseLM(cfg, PM.init_params(defs, gen))

    return SimpleNamespace(
        cfg=cfg,
        init=init,
        n_params=PM.count_params(defs),
        prefill=lambda params, batch, max_len: mod.prefill(cfg, params, batch, max_len),
        decode_step=lambda params, cache, tokens: mod.decode_step(cfg, params, cache, tokens),
        init_cache=lambda b, s, device=None: mod.init_cache(cfg, b, s, device=device_mod.resolve(device)),
    )
