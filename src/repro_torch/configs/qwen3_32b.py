"""qwen3-32b [dense]: qk-norm, GQA kv=8, head_dim=128. [hf:Qwen/Qwen3-8B]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, mlp="swiglu", qk_norm=True,
    remat="full",
    microbatches=4,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128, mlp="swiglu", qk_norm=True, q_chunk=16, loss_chunk=16,
)
