"""hubert-xlarge [audio]: encoder-only, masked-prediction objective.
[arXiv:2106.07447]. Audio frontend is a STUB: input_specs provides
precomputed frame embeddings (conv feature extractor width 512)."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge", family="dense",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, mlp="gelu", causal=False,
    frontend="audio", frontend_dim=512,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=32, mlp="gelu", causal=False,
    frontend="audio", frontend_dim=24, q_chunk=16, loss_chunk=16,
)
