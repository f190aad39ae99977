"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192,
vocab=128256, tied embeddings.  [hf:meta-llama/Llama-3.2-1B; unverified]

Copied from ``repro.configs.llama3_2_1b``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32, n_kv=8, head_dim=64,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    act="silu",
)

SMOKE = FULL.with_(
    name="llama3.2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat="none",
)
