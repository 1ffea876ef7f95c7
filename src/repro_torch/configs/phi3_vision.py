"""phi-3-vision-4.2b [vlm]: phi3-mini text backbone + CLIP patch-embed stub.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]. The vision frontend is a STUB:
input_specs provides precomputed patch embeddings (CLIP-L/14 width 1024).
"""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, mlp="swiglu",
    frontend="vision", frontend_dim=1024, frontend_len=256,
    remat="full",
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=128, mlp="swiglu",
    frontend="vision", frontend_dim=32, frontend_len=8,
    q_chunk=16, loss_chunk=16,
)
