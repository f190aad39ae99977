"""Fault-tolerance runtime (``repro.runtime``): the health monitor and the
elastic remesh plan.  The compressed all-reduce is ROADMAP A12c."""
from repro_torch.runtime.fault import ElasticPlan, HealthMonitor, plan_remesh

__all__ = ["ElasticPlan", "HealthMonitor", "plan_remesh"]
