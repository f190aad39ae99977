"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free mamba1,
vocab=65024, ssm_state=16.  [arXiv:2410.05355]  Copied from
``repro.configs.falcon_mamba_7b``."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=32, n_kv=32,          # unused (attention-free); kept for shape API
    d_ff=0,                        # assignment: d_ff=0 (no FFN, pure mamba)
    vocab=65024,
    ssm_state=16,
    ssm_expand=2,                  # d_inner = 8192
    ssm_conv=4,
    tie_embeddings=False,
    act="silu",
)

SMOKE = FULL.with_(
    name="falcon-mamba-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, vocab=256,
    ssm_state=8, ssm_chunk=16, dtype="float32", remat="none",
)
