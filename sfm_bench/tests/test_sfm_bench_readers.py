"""The metric readers' arithmetic on recorded fixtures."""

import importlib.util
import math
import os

import pytest

from helpers import ROOT

from sfm_bench import trace


def read(kind, name, records):
    path = os.path.join(ROOT, "sfm_bench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"fixture_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(records)


def jobs(walls, error_at=()):
    t, out = 0.0, []
    for i, w in enumerate(walls):
        out.append({"input": i, "wall_s": w, "t0": t, "t1": t + w,
                    "error": "RuntimeError: x" if i in error_at else None})
        t += w
    return out


def test_recon_s_is_the_window_over_completed_jobs():
    rec = {"window_s": 12.0, "jobs": jobs([1.0] * 10, error_at=(3, 7))}
    assert read("end_to_end", "recon_s", rec) == pytest.approx(12.0 / 8)
    assert read("end_to_end", "recon_s", {"window_s": 1.0, "jobs": jobs([1.0], (0,))}) is None


@pytest.mark.parametrize("n", [99, 100, 137])
def test_recon_p90_is_the_nearest_rank_over_every_job(n):
    walls = [0.001 * (i + 1) for i in range(n)][::-1]
    got = read("end_to_end", "recon_p90_s", {"jobs": jobs(walls)})
    if n < 100:
        assert got is None
    else:
        k = math.ceil(0.9 * n)
        assert got == pytest.approx(0.001 * k) and n - k >= 10


def test_setup_and_peak():
    assert read("end_to_end", "setup_s", {"setup_s": 7.5}) == 7.5
    assert read("end_to_end", "peak_device_gb", {"peak_bytes": 2_500_000_000}) == 2.5
    assert read("end_to_end", "peak_device_gb", {"peak_bytes": None}) is None


STAGES = [
    {"extract/prepare_gray": 0.1, "extract/sift": 0.5, "sift/pyramid_detect": 0.4,
     "sift/ori_desc": 0.08, "extract/surf": 0.3, "match/full_sift": 0.01,
     "match/verify_ransac": 0.02, "tracks/union_find": 0.03, "pose/grouping": 0.004,
     "pose/tk": 0.07, "pose/filters": 0.06, "pose/local_ba": 0.05, "pose/merge": 0.07,
     "pose/global_ba": 0.01},
    {"extract/prepare_gray": 0.3, "extract/sift": 0.7, "sift/pyramid_detect": 0.6,
     "extract/surf": 0.5, "match/full_sift": 0.03, "tracks/union_find": 0.05,
     "pose/grouping": 0.006, "pose/tk": 0.09, "pose/filters": 0.08, "pose/local_ba": 0.07,
     "pose/merge": 0.09, "pose/global_ba": 0.03},
]


@pytest.mark.parametrize("name,expected", [
    ("features_s", ((0.1 + 0.5 + 0.3) + (0.3 + 0.7 + 0.5)) / 2),  # sift/* not added again
    ("matching_s", ((0.01 + 0.02 + 0.03) + (0.03 + 0.05)) / 2),
    ("glue_s", ((0.004 + 0.07) + (0.006 + 0.09)) / 2),
    ("tk_s", (0.07 + 0.09) / 2),
    ("filters_s", (0.06 + 0.08) / 2),
    ("ba_s", ((0.05 + 0.01) + (0.07 + 0.03)) / 2),
])
def test_stage_sums_a_job(name, expected):
    rec = {"jobs": [dict(j, stages=s) for j, s in zip(jobs([1.0, 1.0]), STAGES)]}
    assert read("layer_metrics", name, rec) == pytest.approx(expected)


def test_stage_readers_read_nothing_without_their_stages():
    rec = {"jobs": [dict(j, stages={"pose/tk": 0.1}) for j in jobs([1.0])]}
    assert read("layer_metrics", "features_s", rec) is None
    assert read("layer_metrics", "load_s", rec) is None


def test_load_s_and_ba_iterations():
    rec = {"jobs": [dict(j, timing={"initialization": 0.6 + 0.1 * i}, ba_iterations=40 + i)
                    for i, j in enumerate(jobs([1.0, 1.0, 1.0]))]}
    assert read("layer_metrics", "load_s", rec) == pytest.approx(0.7)
    assert read("layer_metrics", "ba_iterations", rec) == pytest.approx(41)


def device_record():
    ops = [("void (anonymous namespace)::lm_fused_kernel<false>(FusedArgs)", 0.10, 0.30),
           ("void top2_kernel(Args)", 0.25, 0.40),  # overlaps the first
           ("Memcpy DtoH (Device -> Pageable)", 0.90, 1.00),
           ("void (anonymous namespace)::lm_fused_kernel<true>(FusedArgs)", 1.50, 1.60),
           ("void late(int)", 2.50, 2.60)]  # outside the window
    return {"ops": ops, "start": 0.0, "end": 2.0}


def test_device_time_idle_share_and_breakdown():
    dev = device_record()
    rec = {"device": dev, "jobs": jobs([1.0, 1.0])}
    assert trace.busy_seconds(dev) == pytest.approx(0.30 + 0.10 + 0.10)
    assert read("layer_metrics", "device_idle_pct", rec) == pytest.approx(75.0)
    assert read("layer_metrics", "lm_fused_ms", rec) == pytest.approx((200 + 100) / 2)
    assert read("layer_metrics", "top2_ms", rec) == pytest.approx(150 / 2)
    js = [dict(j) for j in rec["jobs"]]
    js[0]["spans"] = [("pose/tk", 0.0, 0.5), ("pose/filters", 0.5, 0.95)]
    js[1]["spans"] = [("pose/global_ba", 1.05, 1.8)]
    bd = trace.breakdown(dev, js)
    assert bd["device_ops"][0] == ["lm_fused_kernel", pytest.approx(0.3)]
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    assert gaps["pose/tk"] == pytest.approx(0.1)  # 0.0-0.1
    assert gaps["pose/filters"] == pytest.approx(0.5)  # 0.4-0.9
    assert gaps["pose/global_ba"] == pytest.approx(0.5 + 0.4)  # 1.0-1.5, 1.6-2.0
    assert sum(gaps.values()) == pytest.approx(2.0 - 0.5)


def test_gaps_outside_stages_and_between_jobs():
    dev = {"ops": [("k", 0.5, 0.6), ("k", 1.0, 1.1)], "start": 0.0, "end": 2.0}
    js = [{"t0": 0.0, "t1": 1.5,
           "spans": [("extract/prepare_gray", 0.6, 0.7), ("pose/tk", 0.7, 1.2)]}]
    gaps = dict((k, v) for k, v in trace.breakdown(dev, js)["idle_gaps"])
    assert gaps == {"job, outside stages": pytest.approx(0.5), "pose/tk": pytest.approx(0.4),
                    "between jobs": pytest.approx(0.9)}


def test_device_readers_read_nothing_without_a_trace():
    rec = {"device": None, "jobs": jobs([1.0])}
    for name in ("lm_fused_ms", "top2_ms", "device_idle_pct"):
        assert read("layer_metrics", name, rec) is None
    dev = dict(device_record(), ops=[("void other(int)", 0.1, 0.2)])
    assert read("layer_metrics", "top2_ms", {"device": dev, "jobs": jobs([1.0])}) is None
