"""yi-34b [dense]: llama-arch GQA. [arXiv:2403.04652; hf]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, mlp="swiglu",
    remat="full",
    microbatches=4,
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128, mlp="swiglu", q_chunk=16, loss_chunk=16,
)
