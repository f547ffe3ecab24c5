"""Seconds a job in triangulation (ops/triangulate.py): the pose/triangulate
stages a job, which lie inside pose/merge, pose/local_ba and pose/filters
(so inside glue_s, ba_s and filters_s)."""

from sfm_bench.layer_metrics._read import mean_of


def read(records):
    return mean_of(records, lambda k: k == "pose/triangulate")
