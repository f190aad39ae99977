"""The dense LM configs of the zoo against the JAX package (CPU):
llama3.2-1b, phi4-mini-3.8b and internlm2-20b SMOKE in f32 (qwen2-1.5b:
``tests/test_torch_lm_zoo_qwen2.py``).

The same parameters (``repro``'s ``transformer.init``, copied by
``params_from_jax``) and the same NumPy tokens go through both packages:
the parameter tree, the forward logits, ``prefill`` then ``decode_step``
(caches included), greedy ``decode``, the method x mode grid of
``make_attribute_step``, ``explain_generated`` with exact causal zeros,
and ``Engine.explain_tokens``.  Tolerances, relative to the reference's
max |value|: logits 1e-5, scores 1e-4.
"""
import pytest

from _torch_zoo import (  # noqa: F401
    Zoo, jax_grid, test_attribute_step_matches, test_engine_explain_tokens,
    test_explain_generated_causal_zeros, test_forward_logits_match,
    test_greedy_decode_tokens_match, test_params_from_jax_and_init,
    test_prefill_and_decode_step_match)

CASES = [("llama3.2-1b", "float32"), ("phi4-mini-3.8b", "float32"),
         ("internlm2-20b", "float32")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def zoo(request):
    return Zoo(*request.param)


@pytest.fixture(scope="module")
def grid(zoo):
    return jax_grid(zoo)
