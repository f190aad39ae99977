"""repro_torch.lm — token-level LM attribution (``repro.lm``): step-wise
generation with per-step runner-up tokens, and one attribution step that
explains every generated token (:mod:`.decode`).

``LMAdapter`` (serving) comes with ROADMAP A7, ``plan_lm`` with A10.
"""
from repro_torch.lm.decode import (TOKEN_MODES, DecodeResult, decode,
                                   explain_generated, make_token_explain)
from repro_torch.launch.steps import ssm_scan_tiles

__all__ = ["DecodeResult", "TOKEN_MODES", "decode", "explain_generated",
           "make_token_explain", "ssm_scan_tiles"]
