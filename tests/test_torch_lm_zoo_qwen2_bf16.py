"""qwen2-1.5b SMOKE in bf16 against the JAX package (CPU): the zoo tests
of ``tests/_torch_zoo.py`` (f32: ``tests/test_torch_lm_zoo_qwen2.py``).
Tolerances, relative to the reference's max |value|: logits 1e-2, scores
5e-2, against ``repro`` run one primitive at a time.
"""
import pytest

from _torch_zoo import (  # noqa: F401
    Zoo, jax_grid, test_attribute_step_matches, test_engine_explain_tokens,
    test_explain_generated_causal_zeros, test_forward_logits_match,
    test_greedy_decode_tokens_match, test_params_from_jax_and_init,
    test_prefill_and_decode_step_match)

ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def zoo():
    return Zoo(ARCH, "bfloat16")


@pytest.fixture(scope="module")
def grid(zoo):
    return jax_grid(zoo)
