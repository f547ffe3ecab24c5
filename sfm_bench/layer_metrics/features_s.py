"""Seconds a job in features (ops/sift.py, ops/surf.py via
pipeline/matching.py): the top-level extract/* stages a job; the nested
sift/* stages are inside extract/sift and are not added again."""

from sfm_bench.layer_metrics._read import mean_of


def read(records):
    return mean_of(records, lambda k: k.startswith("extract/"))
