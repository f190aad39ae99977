"""The paper's own accounting in repro_torch against repro: the heatmap
rank metrics (``core/fidelity``), the §V residual ledger
(``core/residuals``) and the Table III configs (``configs/paper_cnn``),
plus the bits the port's residual dicts actually hold.

The metrics get the same NumPy arrays on both sides, ties included (tied
ranks are averaged, a top-k cut through a tie takes ``np.argpartition``'s
pick); the ledgers and configs are compared field for field.  The packed
residuals of ``cnn.forward_with_residuals`` on the CPU hold exactly the
ledger's analytic bits per example: 24,704 a saliency explain on
``TABLE_III_LITERAL``, the paper's 24.7 Kb.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import paper_cnn as jpaper_cnn
from repro.core import fidelity as jfidelity
from repro.core import residuals as jresiduals
from repro_torch import configs
from repro_torch.configs import paper_cnn
from repro_torch.core import fidelity, residuals
from repro_torch.models import cnn

METHODS = ("saliency", "deconvnet", "guided")


def _arrays(kind):
    """Pairs of same-shape arrays: random, tied, constant, signed zeros."""
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.standard_normal((3, 8, 8)), rng.standard_normal((3, 8, 8))
    if kind == "ties":             # a few distinct values, many ties
        return (rng.integers(-2, 3, (4, 16)).astype(np.float32),
                rng.integers(-2, 3, (4, 16)).astype(np.float32))
    if kind == "constant":         # every rank tied: zero spread
        return np.ones((5, 5)), np.ones((5, 5))
    if kind == "constant_vs_random":
        return np.zeros(40), rng.standard_normal(40)
    if kind == "zeros_and_signs":
        a = np.array([0.0, -0.0, 1.0, -1.0, 0.0, 2.0, -3.0, 0.0])
        return a, a[::-1].copy()
    if kind == "bf16_grid":        # values on a coarse grid, as bf16 maps
        a = np.round(rng.standard_normal(200) * 8) / 8
        return a, np.round((a + rng.standard_normal(200) * 0.05) * 8) / 8
    raise ValueError(kind)


KINDS = ("random", "ties", "constant", "constant_vs_random",
         "zeros_and_signs", "bf16_grid")


@pytest.mark.parametrize("kind", KINDS)
def test_rankdata_equals_repro(kind):
    for a in _arrays(kind):
        flat = np.asarray(a, np.float64).reshape(-1)
        np.testing.assert_array_equal(fidelity.rankdata(flat),
                                      jfidelity.rankdata(flat))


@pytest.mark.parametrize("kind", KINDS)
def test_metrics_equal_repro(kind):
    a, b = _arrays(kind)
    assert fidelity.spearman(a, b) == jfidelity.spearman(a, b)
    assert fidelity.sign_agreement(a, b) == jfidelity.sign_agreement(a, b)
    for k in (1, 3, min(8, a.size)):
        assert fidelity.topk_overlap(a, b, k) == jfidelity.topk_overlap(
            a, b, k)
    assert fidelity.compare(a, b, k=4) == jfidelity.compare(a, b, k=4)


def test_metrics_take_tensors_of_any_float_type():
    a, b = _arrays("bf16_grid")
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    want = jfidelity.compare(ta.float().numpy(), tb.float().numpy(), k=16)
    assert fidelity.compare(ta, tb, k=16) == want


def test_paper_ledger_equals_repro_and_the_paper():
    led, jled = residuals.paper_cnn_ledger(), jresiduals.paper_cnn_ledger()
    assert dataclasses.asdict(led) == dataclasses.asdict(jled)
    for bits in (32, 16, 8):
        assert led.autodiff_bits(bits) == jled.autodiff_bits(bits)
    for method in METHODS:
        assert led.analytic_bits(method) == jled.analytic_bits(method)
        assert led.reduction(method) == jled.reduction(method)
    # §V: 3.4 Mb of fp32 autodiff caching against 24.7 Kb, 137x
    assert residuals.mb(led.autodiff_bits(32)) == pytest.approx(3.543, abs=5e-4)
    assert [residuals.kb(led.analytic_bits(m)) for m in METHODS] == [
        24.704, 24.576, 24.704]
    assert led.reduction("saliency") > 137
    assert residuals.kb(1000) == jresiduals.kb(1000) == 1.0
    assert residuals.mb(10 ** 6) == jresiduals.mb(10 ** 6) == 1.0


def test_ledger_methods_equal_repro_on_smooth_sites():
    led, jled = residuals.Ledger(), jresiduals.Ledger()
    for x in (led, jled):
        x.activations = [(1024,), (7, 3)]
        x.relu_sites = [(5, 2)]
        x.pool_sites = [(4, 4)]
        x.smooth_sites = [(1024,)]
    for method in METHODS:
        for srb in (8, 4):
            assert led.analytic_bits(method, srb) == jled.analytic_bits(
                method, srb)
        assert led.reduction(method, 16) == jled.reduction(method, 16)
    for x in (led, jled):
        with pytest.raises(ValueError):
            x.analytic_bits("lime")


@pytest.mark.parametrize("name", ["FULL", "TABLE_III_LITERAL", "SMOKE"])
def test_paper_cnn_configs_equal_repro(name):
    got, want = getattr(paper_cnn, name), getattr(jpaper_cnn, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert configs.cnn(name) is got
    assert got.param_count() == want.param_count()


def test_cnn_registry_rejects_unknown_names():
    with pytest.raises(ValueError, match="paper_cnn"):
        configs.cnn("TINY")


def test_cnn_ledger_of_the_literal_config_is_the_paper_ledger():
    assert dataclasses.asdict(residuals.cnn_ledger(
        paper_cnn.TABLE_III_LITERAL)) == dataclasses.asdict(
            residuals.paper_cnn_ledger())


@pytest.mark.parametrize("precision", ["f32", "bf16", "fxp16"])
@pytest.mark.parametrize("name", ["TABLE_III_LITERAL", "FULL"])
@pytest.mark.parametrize("method", METHODS)
def test_residual_dict_holds_the_ledgers_analytic_bits(name, method,
                                                       precision):
    """The packed masks and crumbs of one forward, per example, are the
    ledger's analytic bits (8 channels a mask byte, 4 a crumb byte: every
    Table III channel count fills its bytes)."""
    cfg = getattr(paper_cnn, name)
    p = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    _, res = cnn.forward_with_residuals(p, x, cfg, method, precision)
    assert residuals.residual_bits(res) == 2 * residuals.cnn_ledger(
        cfg).analytic_bits(method)
    if name == "TABLE_III_LITERAL":
        assert residuals.residual_bits(res) // 2 == (
            24_576 if method == "deconvnet" else 24_704)
