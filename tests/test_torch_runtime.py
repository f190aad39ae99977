"""repro_torch.runtime against repro.runtime (CPU): twins of
``tests/test_runtime.py``'s four fault tests on the port, and
``plan_remesh`` equal to the JAX package's over a grid of host losses,
host sizes and model-parallel widths.  The compressed all-reduce is held
in ``tests/test_torch_compression.py``."""
import numpy as np
import pytest

from repro import runtime as jruntime
from repro_torch import runtime
from repro_torch.runtime import HealthMonitor, plan_remesh


def test_straggler_detection():
    mon = HealthMonitor(window=8, straggler_factor=2.0)
    for _ in range(8):
        for h in range(4):
            mon.record_step(h, 1.0 if h != 2 else 3.5)
    assert mon.stragglers() == [2]


def test_dead_host_detection():
    mon = HealthMonitor(heartbeat_timeout_s=10.0)
    mon.record_step(0, 1.0, now=100.0)
    mon.record_step(1, 1.0, now=100.0)
    mon.record_step(0, 1.0, now=200.0)
    assert mon.dead_hosts(now=205.0) == [1]


def test_remesh_drops_pod():
    plan = plan_remesh(128, list(range(0, 100)), chips_per_host=4,
                       model_parallel=16)
    assert int(np.prod(plan.mesh_shape)) <= 100 * 4
    assert plan.mesh_shape[-1] == 16
    assert len(plan.dropped_hosts) == 28


def test_remesh_healthy_keeps_two_pods():
    plan = plan_remesh(128, list(range(128)), 4, 16)
    assert plan.mesh_shape == (2, 16, 16)
    assert plan.axis_names == ("pod", "data", "model")


@pytest.mark.parametrize("chips_per_host,model_parallel",
                         [(4, 16), (8, 8), (1, 4)])
def test_plan_remesh_equals_reference(chips_per_host, model_parallel):
    rs = np.random.RandomState(chips_per_host * 100 + model_parallel)
    for total in (1, 8, 64, 128):
        for lost in sorted({0, 1, total // 4, total // 2, total - 1}):
            for draw in range(2):
                healthy = (list(range(total - lost)) if draw == 0 else
                           sorted(rs.choice(total, total - lost,
                                            replace=False).tolist()))
                got = plan_remesh(total, healthy, chips_per_host,
                                  model_parallel)
                want = jruntime.plan_remesh(total, healthy, chips_per_host,
                                            model_parallel)
                assert got == runtime.ElasticPlan(*want.__dict__.values())


def test_monitor_equals_reference():
    """The same step times and beats give the same medians, stragglers and
    dead hosts."""
    rs = np.random.RandomState(0)
    mine = HealthMonitor(window=5, straggler_factor=1.5,
                         heartbeat_timeout_s=3.0)
    ref = jruntime.HealthMonitor(window=5, straggler_factor=1.5,
                                 heartbeat_timeout_s=3.0)
    for t in range(40):
        for h in range(6):
            if h == 5 and t > 20:
                continue
            s = float(rs.gamma(2.0, 0.5)) * (3.0 if h == 1 else 1.0)
            mine.record_step(h, s, now=float(t))
            ref.record_step(h, s, now=float(t))
        assert mine.stragglers() == ref.stragglers()
        assert mine.dead_hosts(now=t + 0.5) == ref.dead_hosts(now=t + 0.5)
        for h in range(6):
            assert mine.median_step(h) == ref.median_step(h)
    assert mine.dead_hosts(now=40.0) == [5]
