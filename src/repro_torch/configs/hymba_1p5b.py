"""hymba-1.5b [hybrid]: parallel attention + mamba heads, 128 meta tokens,
SWA(1024) everywhere except 3 global layers. [arXiv:2411.13676; hf]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, mlp="swiglu",
    ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    window=1024, global_layers=(0, 15, 31), meta_tokens=128,
    q_chunk=128, sub_quadratic=True,
    remat="full",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128, mlp="swiglu",
    ssm_state=8, ssm_expand=2, ssm_headdim=16, ssm_chunk=16,
    window=16, global_layers=(0, 2), meta_tokens=8,
    q_chunk=8, loss_chunk=16, sub_quadratic=True,
)
