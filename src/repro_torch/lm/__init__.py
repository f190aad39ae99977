"""repro_torch.lm — token-level LM attribution (``repro.lm``): step-wise
generation with per-step runner-up tokens, and one attribution step that
explains every generated token (:mod:`.decode`); :class:`LMAdapter`, the
serve-protocol adapter (:mod:`.adapter`): LM requests flow through
admission -> batcher -> engine like CNN requests, bucketed by pow2
sequence length.

``plan_lm`` comes with ROADMAP A10.
"""
from repro_torch.lm.adapter import (MIN_BUCKET, PAD_ID, LMAdapter,
                                    bucket_len, pad_tokens)
from repro_torch.lm.decode import (TOKEN_MODES, DecodeResult, decode,
                                   explain_generated, make_token_explain)
from repro_torch.launch.steps import ssm_scan_tiles

__all__ = ["DecodeResult", "LMAdapter", "MIN_BUCKET", "PAD_ID",
           "TOKEN_MODES", "bucket_len", "decode", "explain_generated",
           "make_token_explain", "pad_tokens", "ssm_scan_tiles"]
