"""seamless-m4t-medium [audio] — enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H (kv=16) d_ff=4096, vocab=256206, ReLU FFN + LayerNorm
(NLLB-style).  Modality frontend is a stub: input_specs feeds precomputed
frame embeddings.  [arXiv:2308.11596; hf]

The ReLU FFN means the paper's exact 1-bit mask residual applies to this
backbone.

Copied from ``repro.configs.seamless_m4t_medium``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,          # decoder depth
    enc_layers=12,        # encoder depth
    d_model=1024,
    n_heads=16, n_kv=16, head_dim=64,
    d_ff=4096,
    vocab=256206,
    act="relu",
    ffn_gated=False,
    norm="layernorm",
    frontend="frames",
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = FULL.with_(
    name="seamless-smoke",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=256, dtype="float32", remat="none",
)
