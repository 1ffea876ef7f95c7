"""granite-8b [dense]: llama-arch, code model. [arXiv:2405.04324; hf]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=49152, mlp="swiglu", tie_embeddings=True,
    remat="full",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128, mlp="swiglu", tie_embeddings=True,
    q_chunk=16, loss_chunk=16,
)
