"""repro_torch.lm — token-level LM attribution (``repro.lm``): step-wise
generation with per-step runner-up tokens, and one attribution step that
explains every generated token (:mod:`.decode`); :class:`LMAdapter`, the
serve-protocol adapter (:mod:`.adapter`): LM requests flow through
admission -> batcher -> engine like CNN requests, bucketed by pow2
sequence length; and the planning surface of the scan's launch knobs
(:mod:`.plan`: ``plan_lm``, ``lm_plan_footprints``, ``ssm_scan_tiles``).
"""
from repro_torch.lm.adapter import (MIN_BUCKET, PAD_ID, LMAdapter,
                                    bucket_len, pad_tokens)
from repro_torch.lm.decode import (TOKEN_MODES, DecodeResult, decode,
                                   explain_generated, make_token_explain)
from repro_torch.lm.plan import (LM_PLAN_SEQ, InfeasiblePlanError,
                                  ScanTile, lm_kernel_shapes,
                                  lm_plan_footprints, plan_lm,
                                  ssm_scan_tiles)

__all__ = ["DecodeResult", "InfeasiblePlanError", "LMAdapter",
           "LM_PLAN_SEQ", "MIN_BUCKET", "PAD_ID", "ScanTile", "TOKEN_MODES",
           "bucket_len", "decode", "explain_generated", "lm_kernel_shapes",
           "lm_plan_footprints", "make_token_explain", "pad_tokens",
           "plan_lm", "ssm_scan_tiles"]
