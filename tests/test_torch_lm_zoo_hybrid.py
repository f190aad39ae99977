"""hymba-1.5b SMOKE (the hybrid stack: attention || mamba in every layer,
sliding-window attention with full layers 0 and 2, the mean of the
per-branch-normalized outputs) against the JAX package (CPU), in f32
(bf16: ``tests/test_torch_lm_zoo_hybrid_bf16.py``).

The zoo tests of ``tests/_torch_zoo.py`` (the port's attribution runs the
hybrid segments' scans through B13 and its backward, their plain versions
here; the reference its chunked scan, the same function), then the B13
route of both packages (``scan_tiles``: ``repro``'s Pallas scan in
interpret mode) and the layer plan's windows.  Tolerances: logits 1e-5,
scores 1e-4 of the reference's max.
"""
import jax
import pytest

from _torch_zoo import (  # noqa: F401
    Zoo, close, jax_grid, test_attribute_step_matches,
    test_engine_explain_tokens, test_explain_generated_causal_zeros,
    test_forward_logits_match, test_greedy_decode_tokens_match,
    test_params_from_jax_and_init, test_prefill_and_decode_step_match)
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.launch import steps
from repro_torch.models import transformer as tf

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def zoo():
    return Zoo(ARCH, "float32")


@pytest.fixture(scope="module")
def grid(zoo):
    return jax_grid(zoo)


def test_layer_plan_and_scan_tiles(zoo):
    """Three segments (global, window 8, global), each a hybrid segment
    with a scan tile, in both packages."""
    assert zoo.cfg.layer_plan() == zoo.jcfg.layer_plan() == (
        ("hybrid", 1, 0), ("hybrid", 1, 8), ("hybrid", 1, 0))
    assert steps.ssm_scan_tiles(zoo.cfg) == jsteps.ssm_scan_tiles(zoo.jcfg)


def test_b13_route_logits_match(zoo, monkeypatch):
    """The forward with ``scan_tiles`` (B13 in both packages) against
    ``repro``'s, and one B13 launch counted a hybrid layer on the way
    (the wrapper's launch stubbed: on the CPU it runs the plain
    version)."""
    tiles = steps.ssm_scan_tiles(zoo.cfg)
    jh = jtf.embed_inputs(zoo.jp, zoo.jcfg, zoo.jbatch())
    want = jax.jit(lambda p, h: jtf.forward_from_embeddings(
        p, zoo.jcfg, h, scan_tiles=tiles)[0])(zoo.jp, jh)
    calls = []
    real = ssm_scan.on_card

    def counting(*ts):
        calls.append(1)
        return real(*ts)

    monkeypatch.setattr(ssm_scan, "on_card", counting)
    reset_launches()
    h = tf.embed_inputs(zoo.p, zoo.cfg, zoo.batch())
    got = tf.forward_from_embeddings(zoo.p, zoo.cfg, h, scan_tiles=tiles)[0]
    close(got, want, zoo.tol["logits"])
    assert len(calls) == zoo.cfg.n_layers and LAUNCHES["selective_scan"] == 0
    chunked = tf.forward_from_embeddings(zoo.p, zoo.cfg, h)[0]
    close(got, chunked, zoo.tol["logits"])
