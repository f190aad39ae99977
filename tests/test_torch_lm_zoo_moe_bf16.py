"""moonshot-v1-16b-a3b SMOKE in bf16 against the JAX package (CPU): the zoo
tests of ``tests/_torch_zoo.py`` on ``repro``'s transformer with its MoE
capacity fault corrected (``first_c_moe_ffn``; f32 and scout:
``tests/test_torch_lm_zoo_moe.py``).  Tolerances, relative to the
reference's max |value|: logits 1e-2, scores 5e-2 (ixg and contrastive:
of max Σ_d |rel·e|, as ``tests/_torch_zoo.py`` sets out), against
``repro`` run one primitive at a time.  The embedding gradient those
scores sum, well conditioned where they cancel, is held to 1e-2 of
max |rel| (``test_embedding_gradient_matches``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_zoo import (  # noqa: F401
    METHODS, Zoo, close, jax_grid, test_attribute_step_matches, test_engine_explain_tokens,
    test_explain_generated_causal_zeros, test_forward_logits_match,
    test_greedy_decode_tokens_match, test_params_from_jax_and_init,
    test_prefill_and_decode_step_match)

ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture(scope="module")
def zoo():
    return Zoo(ARCH, "bfloat16", terms_scale=True)


@pytest.fixture(scope="module")
def grid(zoo):
    return jax_grid(zoo)


@pytest.mark.parametrize("method", METHODS)
def test_embedding_gradient_matches(zoo, method):
    """The gradient of the argmax logit at the last position with respect
    to the embeddings (bf16, what the ixg scores sum over d) against
    ``jax.vjp`` of ``repro``'s forward, within 1e-2 of max |rel|."""
    import torch

    from repro.models import transformer as jtf
    from repro_torch.models import transformer as tf
    with zoo.reference():
        h = jtf.embed_inputs(zoo.jp, zoo.jcfg, zoo.jbatch())
        logits, vjp_fn = jax.vjp(lambda e: jtf.forward_from_embeddings(
            zoo.jp, zoo.jcfg, e, method=method, remat=False)[0], h)
        top = np.asarray(jnp.argmax(logits[:, -1].astype(jnp.float32), -1))
        seed = jnp.zeros_like(logits).at[:, -1, :].set(
            jax.nn.one_hot(jnp.asarray(top), logits.shape[-1],
                           dtype=logits.dtype))
        (want,) = vjp_fn(seed)
    e = tf.embed_inputs(zoo.p, zoo.cfg, zoo.batch()).detach()
    e.requires_grad_()
    got_logits = tf.forward_from_embeddings(zoo.p, zoo.cfg, e,
                                            method=method)[0]
    tseed = torch.zeros_like(got_logits)
    tseed[torch.arange(len(top)), -1, torch.as_tensor(top.copy())] = 1
    (got,) = torch.autograd.grad(got_logits, e, tseed)
    assert got.dtype == torch.bfloat16
    close(got, want, zoo.tol["logits"])
