"""The port's bf16 train step against ``repro.launch.steps`` on a dense
SMOKE config (CPU; the reference op by op, as ``tests/_torch_zoo.py``
runs bf16): f32 master, one bf16 compute tree a step.

Tolerances, 2^-6 as the bf16 paths of the port, after each of two steps:
the metrics relative, mu within 2^-6 of each leaf's max, and √nu within
2^-6 of each leaf's max √nu.  √nu is what the update divides by, and it
is |g| scaled, so this holds the gradient as mu does; nu itself is g²
scaled, where a relative error in g doubles (2.3e-2 of max measured
against mu's 1.1e-2).  The params follow each package's own update rule
at 1e-5 (``tests/_torch_train.py`` ``check_update``: the master update
is f32 in both)."""
import pytest

from _torch_train import check_metrics, check_moments, check_update, flat, \
    run_both

BF16_TOL = 2.0 ** -6


@pytest.mark.parametrize("arch", ["llama3.2-1b"])
def test_bf16_train_steps_match(arch):
    init_np, out = run_both(arch, 2, 1, "bfloat16")
    prev_j = prev_t = init_np.params
    for js, jm, ts, tm in out:
        check_metrics(jm, tm, BF16_TOL)
        check_moments(js, ts, BF16_TOL, nu_root=True)
        check_update(prev_j, js, jm["lr"])
        check_update(prev_t, ts, tm["lr"])
        prev_j, prev_t = js.params, ts.params
    assert out[-1][1]["lr"] > 0          # the second step moved the params
    for k, t in flat(out[-1][2].opt.mu).items():
        assert str(t.dtype) == "torch.float32", k
