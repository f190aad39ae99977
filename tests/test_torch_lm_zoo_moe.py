"""The MoE LM configs of the zoo against the JAX package (CPU):
llama4-scout-17b-a16e SMOKE (16 experts top-1 + a shared expert, cut to 4)
and moonshot-v1-16b-a3b SMOKE (a dense first layer, then top-2 of 8
experts + a shared one), in f32 (bf16: ``tests/test_torch_lm_zoo_moe_bf16
.py``).

The zoo tests of ``tests/_torch_zoo.py``: the parameter tree (router and
stacked experts), the forward logits and the load-balancing loss,
``prefill`` / ``decode_step``, greedy ``decode``, the method x mode grid,
``explain_generated`` with exact causal zeros (capacity couples tokens
only through discrete routing, so no gradient crosses positions), and
``Engine.explain_tokens``.  At SMOKE's capacity factor 1.25 experts
overflow on these prompts, so the reference is ``repro``'s transformer on
``first_c_moe_ffn`` (its MoE with the capacity fault of ROADMAP C
corrected); ``tests/test_torch_moe.py`` holds the overflow rule itself.
Tolerances: logits 1e-5, scores 1e-4 of the reference's max.
"""
import pytest

from _torch_zoo import (  # noqa: F401
    Zoo, jax_grid, test_attribute_step_matches, test_engine_explain_tokens,
    test_explain_generated_causal_zeros, test_forward_logits_match,
    test_greedy_decode_tokens_match, test_params_from_jax_and_init,
    test_prefill_and_decode_step_match)

CASES = [("llama4-scout-17b-a16e", "float32"),
         ("moonshot-v1-16b-a3b", "float32")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def zoo(request):
    return Zoo(*request.param)


@pytest.fixture(scope="module")
def grid(zoo):
    return jax_grid(zoo)
