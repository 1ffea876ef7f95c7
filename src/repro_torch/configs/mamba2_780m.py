"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    sub_quadratic=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=128,
    ssm_state=8, ssm_expand=2, ssm_headdim=16, ssm_chunk=16,
    loss_chunk=16, sub_quadratic=True,
)
