"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064, mlp="swiglu", n_experts=16, top_k=2,
    remat="full",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=128, mlp="swiglu", n_experts=4, top_k=2,
    q_chunk=16, loss_chunk=16,
)
