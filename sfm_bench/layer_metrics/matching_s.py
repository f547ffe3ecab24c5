"""Seconds a job in pair matching, verification and tracks (ops/matching.py,
ops/ransac_f.py, pipeline/tracks_build.py): the match/* and tracks/* stages
a job."""

from sfm_bench.layer_metrics._read import mean_of


def read(records):
    return mean_of(records, lambda k: k.startswith(("match/", "tracks/")))
