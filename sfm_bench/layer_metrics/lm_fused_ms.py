"""Device milliseconds a profiled job in the whole-solve BA kernel
(lm_fused_kernel, csrc/ba_kernels.cu via solvers/ba_kernels.py), from
torch.profiler's trace of the window's first jobs."""

from sfm_bench.layer_metrics._read import device_ms


def read(records):
    return device_ms(records, "lm_fused_kernel")
