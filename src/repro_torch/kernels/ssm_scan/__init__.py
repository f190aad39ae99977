from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.kernels.ssm_scan.ops import selective_scan

__all__ = ["ops", "ref", "selective_scan"]
