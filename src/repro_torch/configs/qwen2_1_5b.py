"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960,
vocab=151936, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]

Copied from ``repro.configs.qwen2_1_5b``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12, n_kv=2, head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    act="silu",
)

SMOKE = FULL.with_(
    name="qwen2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat="none",
)
