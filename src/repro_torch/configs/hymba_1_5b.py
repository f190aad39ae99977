"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
vocab=32001, ssm_state=16; parallel attn+mamba heads, SWA(1024) with
full-attention layers {first, middle, last}.  [arXiv:2411.13676; hf]

Simplifications: no meta tokens, no cross-layer
KV sharing; hybrid mix = mean of per-branch-normalized outputs.

Copied from ``repro.configs.hymba_1_5b``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25, n_kv=5, head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_expand=2,
    swa_window=1024,
    global_layers=(0, 15, 31),
    rope_theta=10000.0,
    tie_embeddings=True,
    act="silu",
)

SMOKE = FULL.with_(
    name="hymba-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=96,
    vocab=256, ssm_state=8, ssm_chunk=16, swa_window=8,
    global_layers=(0, 2), dtype="float32", remat="none",
)
