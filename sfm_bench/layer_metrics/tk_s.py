"""Seconds a job in the Tomasi-Kanade initialization (solvers/tomasi_kanade.py,
solvers/tk_kernels.py): the pose/tk stage a job."""

from sfm_bench.layer_metrics._read import mean_of


def read(records):
    return mean_of(records, lambda k: k == "pose/tk")
