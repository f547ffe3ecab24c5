"""Device milliseconds a profiled job in the descriptor matcher's top-2
kernel (top2_kernel, csrc/match_kernels.cu via ops/matching_kernels.py),
from torch.profiler's trace of the window's first jobs."""

from sfm_bench.layer_metrics._read import device_ms


def read(records):
    return device_ms(records, "top2_kernel")
