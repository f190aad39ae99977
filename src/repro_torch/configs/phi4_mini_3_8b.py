"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192,
vocab=200064, RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]

Copied from ``repro.configs.phi4_mini_3_8b``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24, n_kv=8, head_dim=128,
    d_ff=8192,
    vocab=200064,
    rope_theta=10000.0,
    tie_embeddings=True,
    act="silu",
)

SMOKE = FULL.with_(
    name="phi4-mini-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat="none",
)
