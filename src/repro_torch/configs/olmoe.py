"""olmoe-1b-7b [moe]: 64 experts top-8, MHA kv=16. [arXiv:2409.02060; hf]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, mlp="swiglu", n_experts=64, top_k=8,
    moe_impl="a2a",  # all-to-all dispatch (EXPERIMENTS.md §Perf B2)
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab=128, mlp="swiglu", n_experts=8, top_k=2,
    q_chunk=16, loss_chunk=16,
)
