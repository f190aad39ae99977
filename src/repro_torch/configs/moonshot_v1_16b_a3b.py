"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16), expert
d_ff=1408, vocab=163840, MoE 64e top-6 (+2 shared, first layer dense,
DeepSeek-V3-style).  [hf:moonshotai/Moonlight-16B-A3B; hf]

Copied from ``repro.configs.moonshot_v1_16b_a3b``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16, n_kv=16, head_dim=128,
    d_ff=1408,
    vocab=163840,
    n_experts=64, top_k=6, n_shared_experts=2, first_dense=1,
    rope_theta=50000.0,
    tie_embeddings=False,
    act="silu",
)

SMOKE = FULL.with_(
    name="moonshot-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16, d_ff=48,
    vocab=256, n_experts=8, top_k=2, n_shared_experts=1, first_dense=1,
    dtype="float32", remat="none",
)
