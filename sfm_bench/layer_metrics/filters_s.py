"""Seconds a job in the outlier filters (ops/outliers.py, ops/triangulate.py):
the pose/filters stage a job."""

from sfm_bench.layer_metrics._read import mean_of


def read(records):
    return mean_of(records, lambda k: k == "pose/filters")
