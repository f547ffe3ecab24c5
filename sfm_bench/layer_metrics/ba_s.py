"""Seconds a job in bundle adjustment (solvers/ba.py): the pose/local_ba and
pose/global_ba stages a job."""

from sfm_bench.layer_metrics._read import mean_of


def read(records):
    return mean_of(records, lambda k: k in ("pose/local_ba", "pose/global_ba"))
