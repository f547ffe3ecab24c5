"""The grid-route lm_fused launches' share of their roofline: over the
profiled jobs' fused BAs whose camera solve is K3's grid route, the sum of
each call's floor (sfm_bench/roofline.py: the problem's own work at its
views, tracks, observations, sum of squared views a track and LM
iterations, at the H100's f32 peak and HBM bandwidth) over the sum of those
launches' device time, in %. None where lm_fused_grid_ms reads nothing."""

from sfm_bench import roofline
from sfm_bench.layer_metrics.lm_fused_grid_ms import grid_launches


def read(records):
    got = grid_launches(records)
    if got is None:
        return None
    pairs = got[0]
    floor = sum(roofline.floor_s(*roofline.solve_work(
        c["views"], c["tracks"], c["observations"], c["sum_views_sq"], c["iterations"]))
        for c, _ in pairs)
    return 100.0 * floor / sum(dt for _, dt in pairs)
