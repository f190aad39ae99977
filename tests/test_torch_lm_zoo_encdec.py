"""The encoder-decoder and vlm configs of the zoo against the JAX package
(CPU), in f32: seamless-m4t-medium SMOKE (a bidirectional encoder over
frame embeddings, cross-attention in every decoder layer, LayerNorm, the
ReLU FFN whose residual is the paper's 1-bit mask) and
llava-next-mistral-7b SMOKE (patch embeddings before the tokens).

The zoo tests of ``tests/_torch_zoo.py`` with the frames or patches in
every batch: the forward, ``prefill`` (the frames fill the cross ``ck`` /
``cv`` caches) then ``decode_step`` on them, the method x mode grid (the
vlm's scores cover the patches), ``explain_generated`` (frames on the
explain, tokens only in the decode), ``Engine.explain_tokens`` moving the
frames / patches with the tokens.  Tolerances: logits 1e-5, scores 1e-4
of the reference's max.
"""
import pytest

from _torch_zoo import (  # noqa: F401
    Zoo, jax_grid, test_attribute_step_matches, test_engine_explain_tokens,
    test_explain_generated_causal_zeros, test_forward_logits_match,
    test_greedy_decode_tokens_match, test_params_from_jax_and_init,
    test_prefill_and_decode_step_match)

CASES = [("seamless-m4t-medium", "float32"),
         ("llava-next-mistral-7b", "float32")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def zoo(request):
    return Zoo(*request.param)


@pytest.fixture(scope="module")
def grid(zoo):
    return jax_grid(zoo)


def test_frames_and_patches_change_the_result(zoo, grid):
    """The modality inputs are used: without them the logits differ (the
    decoder then runs without cross-attention, the vlm on tokens only)."""
    import torch
    from repro_torch.models import transformer as tf
    with_extra = tf.forward(zoo.p, zoo.cfg, zoo.batch())[0][:, -1]
    bare = tf.forward(zoo.p, zoo.cfg,
                      {"tokens": torch.from_numpy(zoo.toks)})[0][:, -1]
    assert not torch.allclose(with_extra, bare)
