"""Device milliseconds a profiled job in the outlier filter's
nearest-neighbour kernel (outlier_nn_kernel, csrc/outlier_kernels.cu via
ops/outlier_kernels.py), from torch.profiler's trace of the window's first
jobs."""

from sfm_bench.layer_metrics._read import device_ms


def read(records):
    return device_ms(records, "outlier_nn_kernel")
