"""llava-next-mistral-7b [vlm] — mistral-7B backbone: 32L d_model=4096 32H
(GQA kv=8) d_ff=14336, vocab=32000; anyres patch frontend stubbed (576
base-resolution patch embeddings prepended, precomputed by input_specs).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Attribution over the patch embeddings is the paper's pixel heatmap at VLM
scale (which image regions drove the answer).

Copied from ``repro.configs.llava_next_mistral_7b``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336,
    vocab=32000,
    frontend="patches",
    n_patches=576,
    rope_theta=1000000.0,
    tie_embeddings=False,
    act="silu",
)

SMOKE = FULL.with_(
    name="llava-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, n_patches=8, dtype="float32", remat="none",
)
