"""Fault-tolerance runtime (``repro.runtime``): the health monitor, the
elastic remesh plan and the int8 error-feedback compressed all-reduce."""
from repro_torch.runtime.fault import ElasticPlan, HealthMonitor, plan_remesh
from repro_torch.runtime.compression import (ErrorFeedbackState,
                                             compress_int8,
                                             compressed_all_reduce,
                                             decompress_int8,
                                             ef_compress_update)

__all__ = ["ElasticPlan", "HealthMonitor", "plan_remesh", "compress_int8",
           "decompress_int8", "ErrorFeedbackState", "compressed_all_reduce",
           "ef_compress_update", "ef_init"]
