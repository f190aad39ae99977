"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384,
vocab=92544.  [arXiv:2403.17297; hf]

Copied from ``repro.configs.internlm2_20b``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384,
    vocab=92544,
    rope_theta=1000000.0,
    tie_embeddings=False,
    act="silu",
)

SMOKE = FULL.with_(
    name="internlm2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat="none",
)
