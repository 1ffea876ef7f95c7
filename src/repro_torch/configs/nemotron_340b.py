"""nemotron-4-340b [dense]: GQA kv=8, squared-ReLU MLP. [arXiv:2402.16819]."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000, mlp="relu2",
    remat="full",
    microbatches=8,
    # 340B on 256 chips only fits with bf16 canonical params + int8 Adam
    # moments (bitsandbytes-style); see EXPERIMENTS.md §Dry-run.
    param_dtype="bfloat16",
    opt_state_bits=8,
    grad_accum_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=128, mlp="relu2", q_chunk=16, loss_chunk=16,
)
