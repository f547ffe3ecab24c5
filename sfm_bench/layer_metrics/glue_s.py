"""Seconds a job in the incremental driver's host glue
(pipeline/incremental.py, pipeline/grouping.py): the pose/grouping and
pose/merge stages a job."""

from sfm_bench.layer_metrics._read import mean_of


def read(records):
    return mean_of(records, lambda k: k in ("pose/grouping", "pose/merge"))
