"""``cnn.apply(..., precision="bf16")`` of repro_torch against the JAX
package's on every branch (CPU): the fused blocks, the standalone kernel
ops (``fused=False``) and the plain reference ops (``use_pallas=False``),
each under the three rule sets and, on the two unfused branches, the
``"autodiff"`` derivative of training.

On the golden tiny config and ``configs.paper_cnn.SMOKE`` the same NumPy
inputs and params go through both packages (the JAX package's Pallas
kernels in interpret mode), and the gradients of a cross-entropy loss
(taken in f32 on the bf16 logits) are held to ``jax.grad``:

* logits bf16, within ``TOL = 2^-6 * max|ref|`` (four layers of one-step
  bf16 roundings, ``tests/test_torch_cnn_bf16.py``'s bound);
* the input gradient f32 (bf16 values widened through the cast), within
  ``TOL`` on the examples whose residual bits agree (a rounding step can
  move a pre-activation across 0: those examples take another route);
* every parameter's gradient f32, within ``TOL * max|g|``, on a batch of
  those agreeing examples.

A bias gradient is a sum over the batch and the pixels: the port takes it
in f32 and rounds once to bf16 (PyTorch's reduction of a bf16 tensor, and
the fused blocks' own ``db``), as the JAX package's fused blocks do
(``jnp.sum`` upcasts bf16).  On its unfused branches the JAX package
differentiates ``y + b`` itself, and that transposes to a ``reduce_sum``
in bf16, a sum rounded at every step (about 10 % off on SMOKE's first
layer).  There the reference bias gradient is taken in f32 from JAX's own
per-position cotangents: its biases are passed broadcast to the layer
outputs' shapes (the same values, so the same forward), and the gradient
of each is summed in f32 and rounded once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro_torch.configs import paper_cnn
from repro_torch.models import cnn

METHODS = ("saliency", "deconvnet", "guided")
SIZES = {
    # tests/golden/generate.py CFG
    "tiny": dict(in_hw=(8, 8), in_ch=3, channels=(4, 4), kernel=3,
                 fc=(16,), num_classes=4),
    "smoke": {f.name: getattr(paper_cnn.SMOKE, f.name) for f in
              paper_cnn.SMOKE.__dataclass_fields__.values()},
}
BRANCHES = {"fused": dict(use_pallas=True), "ops": dict(use_pallas=True,
                                                        fused=False),
            "reference": dict(use_pallas=False)}
CASES = ([(s, b, m) for s in SIZES for b in BRANCHES for m in METHODS]
         + [(s, b, "autodiff") for s in SIZES for b in ("ops", "reference")])
BATCH = 3
TOL = 2.0 ** -6


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * ref, (what, err, ref)


def _flipped_examples(jres, tres):
    """Examples (batch rows) whose stored bits differ between the two."""
    rows = set()
    pairs = [(a, b) for (ja, jb), (ta, tb) in zip(jres["conv"], tres["conv"])
             for a, b in ((ja, ta), (jb, tb))]
    pairs += list(zip(jres["fc"], tres["fc"]))
    for j, t in pairs:
        if j is None:
            continue
        d = np.asarray(j) != t.numpy()
        rows |= set(np.nonzero(d.reshape(d.shape[0], -1).any(-1))[0])
    return sorted(int(r) for r in rows)


class _Size:
    """One config's params, batch, labels and the examples whose bf16
    residual bits agree between the two packages."""

    def __init__(self, size):
        kw = SIZES[size]
        self.jcfg, self.cfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
        self.jparams = jcnn.init(jax.random.PRNGKey(0), self.jcfg)
        self.params = cnn.params_from_jax(
            jax.tree.map(np.asarray, self.jparams))
        h, w = self.cfg.in_hw
        rs = np.random.RandomState(1)
        self.x = rs.randn(BATCH, h, w, self.cfg.in_ch).astype(np.float32)
        self.y = rs.randint(0, self.cfg.num_classes, size=BATCH)
        _, jres = jcnn.forward_with_residuals(
            self.jparams, jnp.asarray(self.x), self.jcfg, "saliency",
            precision="bf16")
        _, tres = cnn.forward_with_residuals(
            self.params, torch.from_numpy(self.x), self.cfg, "saliency",
            "bf16")
        flipped = _flipped_examples(jres, tres)
        if size == "tiny":
            assert flipped == []
        self.keep = [b for b in range(BATCH) if b not in flipped]
        assert self.keep


_SIZES = {}


@pytest.fixture(scope="module")
def sizes():
    def get(size):
        if size not in _SIZES:
            _SIZES[size] = _Size(size)
        return _SIZES[size]

    yield get
    _SIZES.clear()


def _output_shapes(cfg, n):
    """Each layer's output shape before its ReLU, where its bias adds."""
    h, w = cfg.in_hw
    convs = [(n, h >> (i // cfg.pool_every), w >> (i // cfg.pool_every), c)
             for i, c in enumerate(cfg.channels)]
    return convs, [(n, f) for f in cfg.fc + (cfg.num_classes,)]


def _per_position_biases(jparams, cfg, n):
    """The params with every bias broadcast to its layer's output shape."""
    convs, fcs = _output_shapes(cfg, n)
    return {k: [dict(q, b=jnp.broadcast_to(q["b"], shape))
                for q, shape in zip(jparams[k], shapes)]
            for k, shapes in (("conv", convs), ("fc", fcs))}


def _bias_sum(g):
    """Per-position bias gradients summed in f32, rounded once to bf16."""
    g = np.asarray(g, np.float32)
    return (g.reshape(-1, g.shape[-1]).sum(axis=0).astype(jnp.bfloat16)
            .astype(np.float32))


def _both(s, x, y, method, branch):
    """Logits and the loss gradients (params, then x) in each package."""
    kw = dict(BRANCHES[branch], method=method, precision="bf16")

    def jloss(p, v):
        logits = jcnn.apply(p, v, s.jcfg, **kw)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(lp[jnp.arange(len(y)), y]), logits

    unfused = branch != "fused"
    jparams = (_per_position_biases(s.jparams, s.jcfg, len(x)) if unfused
               else s.jparams)
    (_, jl), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))
    if unfused:
        jgp = {k: [dict(q, b=_bias_sum(q["b"])) for q in v]
               for k, v in jgp.items()}
    p = {k: [{n: t.clone().requires_grad_() for n, t in q.items()}
             for q in v] for k, v in s.params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    logits = cnn.apply(p, tx, s.cfg, **kw)
    loss = torch.nn.functional.cross_entropy(logits.float(),
                                             torch.from_numpy(y))
    leaves = [t for k in ("conv", "fc") for q in p[k] for t in q.values()]
    grads = torch.autograd.grad(loss, leaves + [tx])
    jleaves = [jgp[k][i][n] for k in ("conv", "fc")
               for i in range(len(jgp[k])) for n in ("w", "b")]
    return (jl, jleaves, jgx), (logits, list(grads[:-1]), grads[-1])


@pytest.mark.parametrize("size,branch,method", CASES)
def test_apply_bf16_logits_and_grads_vs_jax(sizes, size, branch, method):
    s = sizes(size)
    (jl, jgp, jgx), (tl, tgp, tgx) = _both(s, s.x, s.y, method, branch)
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    _close(tl, jl, "logits")
    assert tgx.dtype == torch.float32 and jgx.dtype == jnp.float32
    _close(tgx[s.keep], np.asarray(jgx)[s.keep], "input gradient")
    if len(s.keep) < BATCH:          # the parameters see every example
        (_, jgp, _), (_, tgp, _) = _both(s, s.x[s.keep], s.y[s.keep],
                                         method, branch)
    assert len(tgp) == len(jgp)
    for i, (t, j) in enumerate(zip(tgp, jgp)):
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        if np.abs(np.asarray(j)).max() == 0:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t, j, f"parameter gradient {i}")


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_apply_bf16_no_branch_falls_back_to_the_pair(sizes, branch,
                                                     monkeypatch):
    """Every bf16 branch runs under autograd: the seed-batched pair is
    never called, and the input gradient reaches an f32 ``x``."""
    s = sizes("tiny")
    monkeypatch.setattr(cnn, "forward_with_residuals",
                        lambda *a, **k: pytest.fail("the pair ran"))
    tx = torch.from_numpy(s.x).requires_grad_()
    logits = cnn.apply(s.params, tx, s.cfg, method="guided",
                       precision="bf16", **BRANCHES[branch])
    assert logits.dtype == torch.bfloat16 and logits.requires_grad
    (g,) = torch.autograd.grad(logits[:, 0].sum(), tx)
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
