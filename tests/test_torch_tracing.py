"""The port's tracing of its pose path (orthosfm_torch/utils/profiling.py):
span records with parents and group indices, the host-sync counter by span
and call site, the BA and TK call records and the read-out a collector keeps
as it closes (profiling.traces()), and the benchmark's readers of them
(sfm_bench/layer_metrics/host_syncs.py, triangulate_s.py,
lm_fused_obs_it_per_us.py, outlier_nn_ms.py).

On the CPU: outside a collector nothing is recorded, no clock is read and
the sync debug mode is left alone; a small run_pose_estimation nests its
spans as its loop does; the sync counter's bookkeeping with torch's sync
warnings stood in for (the mode itself needs a card); the readers on
hand-made records; the benchmark's dry run.

On the card (marked `cuda`, skipped without one): what the counter counts
and where it puts each sync, the mode restored, and a kernel's device
interval inside the span that launched it on the benchmark's shared clock.
This file imports neither jax nor the JAX package, so on a machine with a
card and no JAX run it as

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import dataclasses
import gc
import importlib.util
import inspect
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings
import weakref

import numpy as np
import pytest
import torch

from orthosfm_torch.config import BundleAdjustConfig, RansacConfig, ReconstructionConfig
from orthosfm_torch.config import SolverType
from orthosfm_torch.data import synthetic
from orthosfm_torch.pipeline import incremental
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import tomasi_kanade as tk
from orthosfm_torch.testbench.problems import make_problem
from orthosfm_torch.utils import profiling

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = pathlib.Path(__file__).resolve().parents[1]
SYNC_RE = profiling.SYNC_WARNING
OLD_STAGES = {"pose/grouping", "pose/tk", "pose/filters", "pose/local_ba", "pose/merge",
              "pose/global_ba"}


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read outside a collector")


def _raise(*args, **kwargs):
    raise AssertionError("the sync debug mode was touched outside a collector")


def _toy_run(device, tracks=120, views=6, max_iterations=10):
    """run_pose_estimation on a small blob under a collector and a BA
    recorder: (stage sums, the collector's read-out, number of groups)."""
    ds = synthetic.generate_dataset(synthetic.blob_cloud(tracks), num_views=views, seed=0,
                                    device=device)
    cfg = ReconstructionConfig(solver=SolverType.ORTHO_QUATERNION,
                               ba=BundleAdjustConfig(max_iterations=max_iterations))
    out, rec = {}, profiling.BARecorder()
    wh = np.full(views, 2048.0)
    with profiling.collect_stages(out, device), rec.recording():
        res = incremental.run_pose_estimation(ds.tracks, wh, wh, cfg, verbose=False)
    assert res.present.all()
    got = profiling.traces()[-1]
    assert got["ba_calls"] == rec.records()
    return out, got, views - 2


def test_outside_a_collector_nothing_is_recorded_and_no_clock_is_read(monkeypatch):
    """stage, record_tk and ba.run outside a collector and a recorder read
    no clock, touch no sync debug mode and keep nothing."""
    problem = make_problem("quat", "cpu", 3, 100)
    mask = problem[3].clone()
    monkeypatch.setattr(profiling, "time", _NoClock())
    monkeypatch.setattr(ba, "time", _NoClock())
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", _raise)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    with profiling.stage("pose/tk", group=0):
        with profiling.stage("pose/triangulate"):
            profiling.record_tk([0, 1, 2], 100, RansacConfig(), False, "eager")
        res = ba.run(*problem[:3], mask, True, BundleAdjustConfig(max_iterations=3))
    assert int(res.iterations) > 0
    assert profiling._STAGES.get() is None and profiling.ba_recorder() is None
    kept = weakref.ref(mask)
    del mask, res
    gc.collect()
    assert kept() is None


def test_pose_estimation_spans_nest_by_group():
    """Each span has its parent's index (a span that encloses it), the
    loop's spans carry their group index 0..G-1, and pose/triangulate sits
    under pose/merge, pose/local_ba and pose/filters; the stage sums are the
    old keys and pose/triangulate, each the sum of its spans."""
    out, got, n_groups = _toy_run("cpu")
    spans = got["spans"]
    assert set(out) == OLD_STAGES | {"pose/triangulate"}
    for name, total in out.items():
        assert total == pytest.approx(sum(s["t1"] - s["t0"] for s in spans if s["name"] == name))
    for i, s in enumerate(spans):
        assert s["t0"] <= s["t1"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert s["parent"] < i and p["t0"] <= s["t0"] and s["t1"] <= p["t1"]
            assert s["group"] == p["group"]
    assert {s["group"] for s in spans if s["name"] == "pose/tk"} == set(range(n_groups))
    assert {spans[s["parent"]]["name"] for s in spans if s["name"] == "pose/triangulate"} == {
        "pose/merge", "pose/local_ba", "pose/filters"}
    assert all(s["parent"] is not None for s in spans if s["name"] == "pose/triangulate")
    assert all(s["parent"] is None for s in spans if s["name"] in OLD_STAGES)
    # the grouping and the final global BA lie outside the loop
    assert {s["group"] for s in spans if s["name"] == "pose/grouping"} == {None}
    assert spans[-1]["name"] == "pose/global_ba" and spans[-1]["group"] is None
    # the CPU counts no syncs
    assert got["host_syncs"] is None and got["syncs_by_site"] is None
    assert all(s["syncs"] is None and s["self_syncs"] is None for s in spans)
    # one group schedule, its tracks collapsed to their support patterns
    (sched,) = got["grouping_calls"]
    assert (sched["views"], sched["groups"]) == (6, n_groups)
    assert 1 <= sched["patterns"] <= sched["tracks"]
    # a TK call a group, from inside its pose/tk span
    assert [c["group"] for c in got["tk_calls"]] == list(range(n_groups))
    for c in got["tk_calls"]:
        assert len(c["views"]) == 3 and c["hypotheses"] == RansacConfig().max_iterations == 241
        assert 25 <= c["tracks"] <= 120 and c["fallback"] is False
        assert c["route"] == "eager"  # CPU tensors: no CUDA graph
    assert got["tk_captures"] == 0
    # the BA calls: a local BA a group, a global one every third and a final one
    calls = got["ba_calls"]
    assert [spans[c["parent"]]["name"] for c in calls] == [
        "pose/local_ba"] * 3 + ["pose/global_ba", "pose/local_ba", "pose/global_ba"]
    assert [c["group"] for c in calls] == [0, 1, 2, 2, 3, None]
    for c in calls:
        assert c["route"] == "torch" and 0 < c["iterations"] <= c["max_iterations"] == 10
        assert 0 < c["observations"] <= c["tracks"] * c["views"]
        assert spans[c["parent"]]["t0"] <= c["t0"] <= c["t1"] <= spans[c["parent"]]["t1"]


def test_ba_call_records_keep_size_and_final_state():
    """A BA call record's observation count is its mask's sum, its track and
    view counts the problem's, its final state the result's; the group and
    span are the enclosing collector's, the collector's read-out holds the
    calls of the recorder opened inside it, and summary() keeps its keys."""
    cams, points, obs, mask = make_problem("quat", "cpu", 4, 150)
    mask = mask.clone()
    mask[::7, 1] = False
    fewer = mask.clone()
    fewer[::3, 3] = False
    out, rec = {}, profiling.BARecorder()
    cfg = BundleAdjustConfig(max_iterations=6)
    with profiling.collect_stages(out, "cpu"), rec.recording():
        r0 = ba.run(cams, points, obs, mask, True, cfg)
        with profiling.stage("pose/local_ba", group=5):
            r1 = ba.run(cams, points, obs, fewer, True, cfg)
    got = rec.records()
    assert [c["observations"] for c in got] == [int(mask.sum()), int(fewer.sum())]
    assert int(mask.sum()) > int(fewer.sum())
    assert [(c["tracks"], c["views"]) for c in got] == [(150, 4), (150, 4)]
    for c, r in zip(got, (r0, r1)):
        assert c["iterations"] == int(r.iterations) and c["max_iterations"] == 6
        assert c["cost"] == float(r.cost) and c["initial_cost"] == float(r.initial_cost)
        assert c["lam"] > 0 and isinstance(c["done"], bool) and c["t0"] <= c["t1"]
    assert (got[0]["group"], got[0]["parent"]) == (None, None)
    assert (got[1]["group"], got[1]["parent"]) == (5, 0)
    assert profiling.traces()[-1]["ba_calls"] == got
    s = rec.summary()
    assert set(s) == {"ba_calls", "iterations_launched", "iterations_worked",
                      "enqueue_ms_per_it", "by_views", "by_route", "by_solve_route"}
    assert s["iterations_worked"] == int(r0.iterations) + int(r1.iterations)
    assert s["by_route"]["torch"]["host_ms"] == pytest.approx(
        sum(c["t1"] - c["t0"] for c in got) * 1e3)


class _FakeCudaMode:
    """torch.cuda's sync debug mode, stood in for on the CPU: the calls that
    set it, and a barrier that itself warns as a sync would."""

    def __init__(self, monkeypatch, previous):
        self.mode, self.set_calls = previous, []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: _sync())

    def set(self, mode):
        self.set_calls.append(mode)
        self.mode = mode


def _sync():
    warnings.warn(profiling.SYNC_WARNING + " (Triggered internally at x.cpp:1.)", UserWarning)


def test_sync_counter_attributes_each_warning_to_its_span_and_site(monkeypatch):
    """Each sync warning inside a collector counts once, against the
    innermost open span and the call site (here this file's line: no frame
    of the program's package is on the stack); the collector's own barriers
    count nothing; other warnings pass through; the mode goes to "warn" as
    the outermost collector opens and back to the previous one as it
    closes; an inner collector shares the outer one's trace."""
    fake = _FakeCudaMode(monkeypatch, previous=2)
    out, lines = {}, []
    msg = profiling.SYNC_WARNING + " (Triggered internally at x.cpp:1.)"
    with pytest.warns(UserWarning, match="an ordinary warning") as seen:
        with profiling.collect_stages(out, "cuda"):
            warnings.warn(msg, UserWarning)
            lines.append((None, inspect.currentframe().f_lineno - 1))
            with profiling.stage("pose/merge", group=3):
                warnings.warn(msg, UserWarning)
                lines.append(("pose/merge", inspect.currentframe().f_lineno - 1))
                with profiling.stage("pose/triangulate"):
                    assert fake.mode == "warn"
                    with profiling.collect_stages({}, "cuda"):  # inner: no second hook
                        pass
                    for _ in range(2):
                        warnings.warn(msg, UserWarning)
                    lines.append(("pose/triangulate", inspect.currentframe().f_lineno - 1))
                    warnings.warn("an ordinary warning", UserWarning)
    assert fake.set_calls == ["warn", 2]
    assert [str(w.message) for w in seen] == ["an ordinary warning"]
    got = profiling.traces()[-1]
    assert got["host_syncs"] == 4
    merge, tri = got["spans"]
    assert (merge["syncs"], merge["self_syncs"], merge["group"]) == (3, 1, 3)
    assert (tri["syncs"], tri["self_syncs"], tri["group"], tri["parent"]) == (2, 2, 3, 0)
    assert {(s["stage"], s["site"]): s["syncs"] for s in got["syncs_by_site"]} == {
        (name, f"{__file__}:{line}"): 2 if name == "pose/triangulate" else 1
        for name, line in lines}
    assert sum(s["syncs"] for s in got["syncs_by_site"]) == got["host_syncs"]
    assert set(out) == {"pose/merge", "pose/triangulate"}


def test_a_collector_without_a_trace_keeps_the_stage_sums_alone(monkeypatch):
    """With trace=False a collector adds the stage sums, with their
    barriers, and nothing else: the sync debug mode is not touched, a sync
    warning is neither counted nor swallowed, the BA and TK records carry
    no span, and no read-out is kept."""
    fake = _FakeCudaMode(monkeypatch, previous=0)
    msg = profiling.SYNC_WARNING + " (Triggered internally at x.cpp:1.)"
    problem = make_problem("quat", "cpu", 3, 100)
    out, rec = {}, profiling.BARecorder()
    kept = profiling.traces()
    with pytest.warns(UserWarning, match=SYNC_RE) as seen:
        with profiling.collect_stages(out, "cuda", trace=False), rec.recording():
            with profiling.stage("pose/local_ba", group=4):
                with profiling.stage("pose/triangulate"):
                    warnings.warn(msg, UserWarning)
                profiling.record_tk([0, 1, 2], 100, RansacConfig(), False, "eager")
                ba.run(*problem, True, BundleAdjustConfig(max_iterations=3))
    assert fake.set_calls == [] and fake.mode == 0
    # the warning itself and the two stages' barriers, each shown as a sync
    assert len([w for w in seen if str(w.message).startswith(profiling.SYNC_WARNING)]) == 3
    assert set(out) == {"pose/local_ba", "pose/triangulate"}
    assert out["pose/local_ba"] >= out["pose/triangulate"] > 0.0
    (call,) = rec.records()
    assert (call["group"], call["parent"]) == (None, None)
    assert profiling.traces() == kept


def test_a_collector_keeps_its_read_out_as_it_closes_cleanly():
    """The outermost collector's read-out goes to traces() as it closes,
    stamped with its open and close around its spans; a nested collector
    adds none of its own, a region that raises keeps none, and only the
    last TRACES_KEPT are kept."""
    before = len(profiling.traces())
    t0 = time.monotonic()
    with profiling.collect_stages({}, "cpu"):
        with profiling.stage("pose/merge", group=1):
            with profiling.collect_stages({}, "cpu"):
                with profiling.stage("pose/triangulate"):
                    pass
    t1 = time.monotonic()
    got = profiling.traces()[-1]
    assert len(profiling.traces()) == min(before + 1, profiling.TRACES_KEPT)
    assert t0 <= got["t0"] <= got["spans"][0]["t0"] <= got["spans"][0]["t1"] <= got["t1"] <= t1
    assert [(s["name"], s["parent"], s["group"]) for s in got["spans"]] == [
        ("pose/merge", None, 1), ("pose/triangulate", 0, 1)]
    with pytest.raises(ValueError):
        with profiling.collect_stages({}, "cpu"):
            with profiling.stage("pose/merge"):
                raise ValueError("a failed job")
    assert profiling.traces()[-1] is got or profiling.traces()[-1] == got
    for _ in range(profiling.TRACES_KEPT + 1):
        with profiling.collect_stages({}, "cpu"):
            pass
    assert len(profiling.traces()) == profiling.TRACES_KEPT
    assert all(t["spans"] == [] for t in profiling.traces())


def test_the_pose_trace_script_reads_every_record():
    """scripts/torch_pose_trace.py's summary reads the spans' own and
    child syncs, the call sites, the groups' time with their TK and local BA
    sizes, the BA calls by the span that made them with how they ended, the
    final BA by noise level, the group schedules' sizes, and the TK calls'
    routes and captures."""
    spec = importlib.util.spec_from_file_location(
        "torch_pose_trace", ROOT / "scripts" / "torch_pose_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def span(name, t0, t1, parent, group, syncs, own):
        return {"name": name, "t0": t0, "t1": t1, "parent": parent, "group": group,
                "syncs": syncs, "self_syncs": own}

    def call(parent, group, obs, its, done, lam, cost, solve_route="warp"):
        return {"views": 3, "tracks": 100, "observations": obs, "sum_views_sq": 3 * obs,
                "route": "fused", "solve_route": solve_route, "max_iterations": 10,
                "iterations": its, "lam": lam, "cost": cost, "initial_cost": 2 * cost,
                "done": done, "group": group, "parent": parent, "t0": 0.0, "t1": 0.001}

    def job(i, slow):
        spans = [span("pose/tk", 0.0, 0.1, None, 0, 3, 3),
                 span("pose/merge", 0.1, 0.2 + slow, None, 0, 9, 4),
                 span("pose/triangulate", 0.15, 0.2, 1, 0, 5, 5),
                 span("pose/local_ba", 0.3, 0.4, None, 0, 1, 1),
                 span("pose/global_ba", 0.4, 0.5, None, None, 0, 0),
                 span("pose/grouping", 0.5, 0.55 + slow, None, None, 0, 0)]
        sites = [{"stage": "pose/triangulate", "site": "a.py:1", "syncs": 5},
                 {"stage": "pose/merge", "site": "b.py:2", "syncs": 4},
                 {"stage": "pose/tk", "site": "a.py:1", "syncs": 3},
                 {"stage": "pose/local_ba", "site": "c.py:3", "syncs": 1},
                 {"stage": None, "site": "d.py:4", "syncs": 2}]
        calls = [call(3, 0, 300 + i, 8, True, 1e-3, 1.0),
                 call(4, None, 900, 10, i == 0, 1e2, 4.0, "grid" if i == 0 else None)]
        tks = [{"group": 0, "views": [0, 1, 2], "tracks": 50 + i, "hypotheses": 241,
                "fallback": i == 1, "route": "capture" if i == 0 else "replay"}]
        return ({"input": i, "error": None, "wall_s": 0.5 + slow},
                {"host_syncs": 15, "spans": spans, "syncs_by_site": sites,
                 "ba_calls": calls, "tk_calls": tks, "tk_captures": 1 - i,
                 "grouping_calls": [{"tracks": 4000, "views": 16, "patterns": 1 + 3 * i,
                                     "groups": 14}]})

    got = mod.summarize([job(0, 0.0), job(1, 1.0)], {0: 1.0, 1: 40.0}.get)
    assert got["jobs"] == 2 and got["each_job_host_syncs_is_its_sites_sum"]
    assert got["syncs_by_stage"]["pose/merge"] == {"with_children": 9, "own": 4, "children": 5}
    assert got["syncs_outside_stages"] == 2
    assert got["top_sites"][0] == {"stage": "pose/triangulate", "site": "a.py:1",
                                   "syncs_a_job": 5}
    slow = got["slowest_groups"][0]
    assert (slow["input"], slow["group"], slow["views"], slow["syncs"]) == (1, 0, [0, 1, 2], 13)
    assert (slow["tk_tracks"], slow["tk_fallback"], slow["local_ba_observations"]) == (51, True,
                                                                                       301)
    local, glob = got["ba"]["pose/local_ba"], got["ba"]["pose/global_ba"]
    assert local["observations_mean"] == 300.5 and local["done_share"] == 1
    assert local["sum_views_sq_mean"] == 901.5 and local["solve_routes"] == {"warp": 1}
    assert glob["solve_routes"] == {"None": 0.5, "grid": 0.5}
    assert glob["at_max_iterations"] == 2 and glob["done_share"] == 0.5
    assert glob["lam_median"] == 1e2 and glob["cost_over_initial_mean"] == 0.5
    assert got["tk"]["fallbacks"] == 1
    assert got["tk"]["route_shares"] == {"capture": 0.5, "replay": 0.5}
    assert got["tk"]["captures_a_job"] == 0.5
    assert got["grouping"] == {"calls_a_job": 1, "seconds_a_job": pytest.approx(0.55),
                               "tracks_mean": 4000, "views": [16], "patterns_mean": 2.5,
                               "patterns_over_tracks_mean": pytest.approx(2.5 / 4000),
                               "groups_mean": 14}
    noisy = got["by_noise_px"]["40.0"]
    assert noisy["tk_fallback_share"] == 1 and noisy["final_ba"]["done_share"] == 0


def test_sync_call_site_is_the_innermost_frame_of_the_program(monkeypatch):
    """A sync made inside the program's package is put at the program's own
    line, not at torch's or at its caller's: group_full_size_counts reads
    its counts back once, at its .cpu()."""
    _FakeCudaMode(monkeypatch, previous=0)
    src, first = inspect.getsourcelines(incremental.group_full_size_counts)
    line = first + next(i for i, ln in enumerate(src) if ".cpu()" in ln)
    real_cpu = torch.Tensor.cpu

    def cpu(self, *args, **kwargs):
        _sync()
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    ds = synthetic.generate_dataset(synthetic.blob_cloud(60), num_views=4, seed=0, device="cpu")
    with profiling.collect_stages({}, "cuda"):
        with profiling.stage("pose/grouping"):
            incremental.group_full_size_counts(ds.tracks, torch.tensor([[0, 1, 2]]))
    sites = profiling.traces()[-1]["syncs_by_site"]
    assert [(s["stage"], s["site"], s["syncs"]) for s in sites] == [
        ("pose/grouping", f"orthosfm_torch/pipeline/incremental.py:{line}", 1)]


def _read(name, records):
    path = ROOT / "sfm_bench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"trace_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(records)


def _job(t0, t1, stages, error=None):
    return {"input": 0, "t0": t0, "t1": t1, "wall_s": t1 - t0, "error": error,
            "stages": stages, "spans": []}


def _readout(t0, t1, syncs, calls):
    return {"t0": t0, "t1": t1, "host_syncs": syncs, "ba_calls": calls, "spans": [],
            "syncs_by_site": [], "tk_calls": []}


def _ba(route, observations, iterations):
    return {"route": route, "observations": observations, "iterations": iterations}


def test_the_readers_on_hand_made_records(monkeypatch):
    """The readers find each job's read-out in profiling.traces() by time (a
    read-out from outside every job, and a failed job's, are not read)."""
    jobs = [_job(0.0, 1.0, {"pose/triangulate": 0.2}),
            _job(1.0, 2.0, {"pose/triangulate": 0.1, "pose/merge": 0.5}),
            _job(2.0, 3.5, {"pose/triangulate": 9.0}, error="RuntimeError: x"),
            _job(3.5, 4.0, {"pose/merge": 0.3})]
    outs = [_readout(-1.0, -0.5, 7777, [_ba("fused", 5, 5)]),
            _readout(0.01, 0.99, 300, [_ba("fused", 1000, 20), _ba("fused", 500, 10),
                                       _ba("kernel", 7000, 100)]),
            _readout(1.01, 1.99, 100, [_ba("fused", 2000, 5)]),
            _readout(2.01, 3.49, 999, [_ba("fused", 9999, 9)]),
            _readout(3.51, 3.99, 200, [_ba("fused", 1, 1)])]
    monkeypatch.setattr(profiling, "traces", lambda: outs)
    ops = [("void lm_fused_kernel<false>(float*)", 0.1, 0.1002),
           ("void lm_fused_kernel<true>(float*)", 1.5, 1.5003),
           ("at::native::elementwise_kernel", 0.2, 0.9)]
    records = {"jobs": jobs, "device": {"ops": ops, "start": 0.0, "end": 2.0}}
    assert _read("host_syncs", records) == pytest.approx((300 + 100 + 200) / 3)
    assert _read("triangulate_s", records) == pytest.approx((0.2 + 0.1 + 0.0) / 3)
    # jobs 0 and 1 lie in the profiled part: fused work over 500 us of lm_fused
    assert _read("lm_fused_obs_it_per_us", records) == pytest.approx(
        (1000 * 20 + 500 * 10 + 2000 * 5) / 500.0)
    assert _read("lm_fused_obs_it_per_us", {"jobs": jobs, "device": None}) is None
    # a profiled job without its read-out: no rate
    monkeypatch.setattr(profiling, "traces", lambda: outs[2:])
    assert _read("lm_fused_obs_it_per_us", records) is None
    # the CPU counts no syncs
    monkeypatch.setattr(profiling, "traces", lambda: [dict(t, host_syncs=None) for t in outs])
    assert _read("host_syncs", records) is None
    # a program without the read-outs (nor pose/triangulate) gives nothing
    monkeypatch.delattr(profiling, "traces")
    for j in jobs:
        j["stages"].pop("pose/triangulate", None)
    assert _read("host_syncs", records) is None
    assert _read("triangulate_s", records) is None
    assert _read("lm_fused_obs_it_per_us", records) is None


def test_outlier_nn_ms_reads_the_kernels_device_time():
    """outlier_nn_ms: device ms a profiled job in outlier_nn_kernel (the
    name as torch.profiler gives it), over the jobs inside the profiled
    part; None where the trace holds no such kernel (the parent's program)
    or no trace was taken."""
    jobs = [_job(0.0, 1.0, {}), _job(1.0, 2.0, {}), _job(2.0, 3.0, {})]
    name = ("(anonymous namespace)::outlier_nn_kernel(int, int, float const*, "
            "unsigned char const*, float, unsigned int*, float*)")
    ops = [(name, 0.1, 0.1007), (name, 1.2, 1.2009), ("lm_fused_kernel", 0.3, 0.4),
           ("at::native::elementwise_kernel", 0.5, 0.6)]
    records = {"jobs": jobs, "device": {"ops": ops, "start": 0.0, "end": 2.0}}
    assert _read("outlier_nn_ms", records) == pytest.approx((0.7 + 0.9) / 2)
    records["device"]["ops"] = ops[2:]
    assert _read("outlier_nn_ms", records) is None
    assert _read("outlier_nn_ms", {"jobs": jobs, "device": None}) is None


def _fused(t0, views, tracks, observations, sum_views_sq, iterations, solve_route):
    return {"route": "fused", "views": views, "tracks": tracks, "observations": observations,
            "sum_views_sq": sum_views_sq, "iterations": iterations,
            "solve_route": solve_route, "t0": t0}


def test_the_grid_readers_on_hand_made_records(monkeypatch):
    """lm_fused_grid_ms and lm_fused_grid_roofline_pct pair the profiled
    jobs' fused calls with the trace's lm_fused launches in order and read
    the grid-route ones; a launch's template argument, where the trace keeps
    it, must agree with its call's route. None for records without
    solve_route (a program that does not record it), a launch count that
    disagrees, instantiations that disagree, no grid call, or no trace."""
    from sfm_bench import roofline as broof

    jobs = [_job(0.0, 1.0, {}), _job(1.0, 2.0, {}), _job(2.5, 3.0, {})]
    grid_a = _fused(0.5, 192, 4096, 500_000, 80_000_000, 4, "grid")
    grid_b = _fused(1.5, 192, 4096, 786_432, 150_994_944, 6, "grid")
    outs = [_readout(0.01, 0.99, None, [_fused(0.2, 3, 4096, 12_000, 36_000, 9, "warp"),
                                        grid_a, _ba("kernel", 10, 3)]),
            _readout(1.01, 1.99, None, [_fused(1.2, 40, 4096, 90_000, 500_000, 7, "cluster"),
                                        grid_b]),
            _readout(2.51, 2.99, None, [_fused(2.7, 192, 4096, 786_432, 150_994_944, 5,
                                               "grid")])]
    monkeypatch.setattr(profiling, "traces", lambda: outs)

    def op(arg, t0, dt):
        tmpl = "" if arg is None else f"<{arg}>"
        return (f"void (anonymous namespace)::lm_fused_kernel{tmpl}((anonymous namespace)::"
                f"FusedArgs)", t0, t0 + dt)

    def ops(args):
        return [op(args[0], 0.2, 1e-4), op(args[1], 0.5, 0.010), op(args[2], 1.2, 2e-3),
                op(args[3], 1.5, 0.014), ("void other_kernel(int)", 0.3, 0.4)]

    named = ["false", "true", "false", "true"]
    records = {"jobs": jobs, "device": {"ops": ops(named), "start": 0.0, "end": 2.0}}
    # jobs 0 and 1 lie in the profiled part; the grid launches took 10 and 14 ms
    assert _read("lm_fused_grid_ms", records) == pytest.approx((10 + 14) / 2)
    floors = [broof.floor_s(*broof.solve_work(c["views"], c["tracks"], c["observations"],
                                              c["sum_views_sq"], c["iterations"]))
              for c in (grid_a, grid_b)]
    pct = _read("lm_fused_grid_roofline_pct", records)
    assert pct == pytest.approx(100 * sum(floors) / 0.024) and 0 < pct < 100
    # grid_b's floor by hand: operations bound at 192 views
    n = 6 * 192
    fma = 18 * 786_432 + 6 * (54 * 150_994_944 + 9 * 786_432 + 360 * 786_432
                              + n ** 3 / 6 + n * n)
    assert floors[1] == pytest.approx(2 * fma / 67e12)
    # no template argument in the names: the same, by pairing alone
    records["device"]["ops"] = ops([None] * 4)
    assert _read("lm_fused_grid_ms", records) == pytest.approx(12.0)
    # instantiations that disagree with the routes, or one launch too many
    records["device"]["ops"] = ops(["true", "false", "false", "true"])
    assert _read("lm_fused_grid_ms", records) is None
    records["device"]["ops"] = ops(named) + [op("false", 1.8, 1e-4)]
    for name in ("lm_fused_grid_ms", "lm_fused_grid_roofline_pct"):
        assert _read(name, records) is None
    # records without the new fields (the parent's program)
    records["device"]["ops"] = ops(named)
    old = [dict(t, ba_calls=[{k: v for k, v in c.items()
                              if k not in ("solve_route", "sum_views_sq")}
                             for c in t["ba_calls"]]) for t in outs]
    monkeypatch.setattr(profiling, "traces", lambda: old)
    for name in ("lm_fused_grid_ms", "lm_fused_grid_roofline_pct"):
        assert _read(name, records) is None
    # no grid call, and no trace
    small = [dict(t, ba_calls=[c for c in t["ba_calls"] if c.get("solve_route") != "grid"])
             for t in outs]
    monkeypatch.setattr(profiling, "traces", lambda: small)
    records["device"]["ops"] = [o for o in ops(named) if "<true>" not in o[0]]
    assert _read("lm_fused_grid_ms", records) is None
    monkeypatch.setattr(profiling, "traces", lambda: outs)
    for name in ("lm_fused_grid_ms", "lm_fused_grid_roofline_pct"):
        assert _read(name, {"jobs": jobs, "device": None}) is None


def test_ba_call_records_count_squared_views_a_track():
    """A BA call record's sum_views_sq is the sum over its tracks of the
    square of the views its mask holds for each (hand-counted here), read
    with the observation count; solve_route is None on the CPU's routes,
    and summary()'s by_solve_route counts none."""
    cams, points, obs, mask = make_problem("quat", "cpu", 4, 150)
    mask = torch.zeros_like(mask)
    mask[:50] = True  # 50 tracks in 4 views
    mask[50:100, :2] = True  # 50 in 2
    mask[100:, :3] = True  # 50 in 3
    rec = profiling.BARecorder()
    cfg = BundleAdjustConfig(max_iterations=3)
    with rec.recording():
        ba.run(cams, points, obs, mask, True, cfg)
        ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="fused"))
    got = rec.records()
    assert [(c["route"], c["solve_route"]) for c in got] == [("torch", None), ("fused", None)]
    for c in got:
        assert c["observations"] == 50 * 4 + 50 * 2 + 50 * 3
        assert c["sum_views_sq"] == 50 * 16 + 50 * 4 + 50 * 9
    assert rec.summary()["by_solve_route"] == {}


def test_ba_call_records_name_lm_fuseds_camera_solve_route(monkeypatch):
    """ba.run records the route of lm_fused's camera solve that
    ba_kernels.fused_solve_route names (K3's rule, from the kernels'
    library on the card) for its fused calls, None for the others; the
    summary counts the fused calls by it, with their host time."""
    from orthosfm_torch.solvers import ba_kernels as bk

    class Lib:
        def osfm_camera_solve_route(self, V, route):
            assert route == -1
            return 3 if V >= 120 else 1

    assert bk.fused_solve_route(192, "cpu") is None
    assert bk.fused_solve_route(192, "cuda", Lib()) == "grid"
    assert bk.fused_solve_route(40, torch.device("cuda"), Lib()) == "cta"
    monkeypatch.setattr(bk, "fused_solve_route",
                        lambda V, device, lib=None: "grid" if V >= 4 else "warp")
    rec = profiling.BARecorder()
    cfg = BundleAdjustConfig(max_iterations=3)
    with rec.recording():
        for v, impl in ((4, "fused"), (3, "fused"), (4, "torch")):
            ba.run(*make_problem("quat", "cpu", v, 60), True,
                   dataclasses.replace(cfg, impl=impl))
    got = rec.records()
    assert [c["solve_route"] for c in got] == ["grid", "warp", None]
    s = rec.summary()
    assert set(s["by_solve_route"]) == {"grid", "warp"}
    for c, route in zip(got[:2], ("grid", "warp")):
        row = s["by_solve_route"][route]
        assert row["ba_calls"] == 1 and row["iterations_worked"] == c["iterations"]
        assert row["host_ms"] == pytest.approx((c["t1"] - c["t0"]) * 1e3)


def test_benchmark_dry_run_of_ring192_reports_neither_grid_metric():
    """The 192-view cell's traced dry run on the CPU (its toy size) ends
    correct; the grid route's metrics read nothing there (no device trace,
    no lm_fused)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "sfm_bench/run.py", "--workload", "from_tracks.ring192", "--seed",
         "2147483901", "--seconds", "1", "--trace", "1", "--dry-run"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and line["metrics"] == {}
    assert set(line["checks"]) == {"cost_gap_px2", "pose_gap_deg", "point_rms_px",
                                   "gt_bar_share"}
    assert "cpu_lm_fused_grid_ms" not in line["dry_run"]
    assert "cpu_lm_fused_grid_roofline_pct" not in line["dry_run"]


def test_benchmark_dry_run_reports_the_new_metrics():
    """The benchmark's traced dry run on the CPU reports triangulate_s under
    dry_run; host_syncs (no sync on the CPU) and lm_fused_obs_it_per_us (no
    device trace) read nothing there."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "sfm_bench/run.py", "--workload", "from_tracks.sweep16", "--seed", "3",
         "--seconds", "1", "--trace", "1", "--dry-run"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"] == {}
    assert line["dry_run"]["cpu_triangulate_s"] > 0.0
    assert 0.0 < line["dry_run"]["cpu_triangulate_s"] < line["dry_run"]["cpu_ba_s"] + \
        line["dry_run"]["cpu_glue_s"] + line["dry_run"]["cpu_filters_s"]
    assert "cpu_host_syncs" not in line["dry_run"]
    assert "cpu_lm_fused_obs_it_per_us" not in line["dry_run"]


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tk_group(dev, n_tracks=4096):
    ds = synthetic.generate_dataset(synthetic.blob_cloud(n_tracks, seed=0), num_views=6, seed=0,
                                    device="cpu")
    obs = ds.tracks.obs[:, :3].contiguous()
    valid = ds.tracks.obs_mask[:, :3].all(1) & ds.tracks.alive
    return obs.to(dev), valid.to(dev)


@pytest.mark.cuda
def test_the_counter_counts_each_kind_of_sync_on_the_card(dev):
    """1 for .item(), 1 for a host array copied to the card, at least 1 for
    boolean-mask indexing, none for a pinned non_blocking copy, for the
    collector's own barriers, or for a whole TK call; host_syncs is the sum
    of the per-site counts."""
    x = torch.arange(-8.0, 8.0, device=dev)
    pinned = torch.ones(1024).pin_memory()
    obs, valid = _tk_group(dev)
    w = torch.full((3,), 2048.0, device=dev)
    cfg = RansacConfig()
    tk.robust_factorization(obs, valid, w, w, cfg, generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    with profiling.collect_stages({}, dev):
        with profiling.stage("item"):
            x.sum().item()
        with profiling.stage("h2d"):
            torch.as_tensor(np.ones(16, np.float32), device=dev)
        with profiling.stage("mask"):
            x[x > 0]
        with profiling.stage("pinned"):
            pinned.to(dev, non_blocking=True)
        with profiling.stage("barrier"):
            with profiling.stage("inner"):
                pass
        with profiling.stage("tk"):
            tk.robust_factorization(obs, valid, w, w, cfg,
                                    generator=torch.Generator(dev).manual_seed(1))
    got = profiling.traces()[-1]
    by = {s["name"]: s["syncs"] for s in got["spans"]}
    assert by["item"] == 1 and by["h2d"] == 1 and by["mask"] >= 1
    assert by["pinned"] == 0 and by["barrier"] == by["inner"] == 0 and by["tk"] == 0
    assert got["host_syncs"] == sum(s["syncs"] for s in got["syncs_by_site"]) == sum(
        by[k] for k in ("item", "h2d", "mask"))
    here = str(pathlib.Path(__file__).resolve())
    assert all(s["site"].startswith(here + ":") for s in got["syncs_by_site"])
    assert {s["stage"] for s in got["syncs_by_site"]} == {"item", "h2d", "mask"}


@pytest.mark.cuda
@pytest.mark.parametrize("previous", [0, 2])
def test_the_previous_sync_debug_mode_is_restored(dev, previous):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(previous)
    try:
        with profiling.collect_stages({}, dev):
            assert torch.cuda.get_sync_debug_mode() == 1
            with profiling.collect_stages({}, dev):
                assert torch.cuda.get_sync_debug_mode() == 1
            assert torch.cuda.get_sync_debug_mode() == 1
        assert torch.cuda.get_sync_debug_mode() == previous
        with profiling.collect_stages({}, dev, trace=False):  # the mode is left alone
            assert torch.cuda.get_sync_debug_mode() == previous
        assert torch.cuda.get_sync_debug_mode() == previous
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_pose_estimation_syncs_add_up_by_span_and_site_on_the_card(dev):
    """On the card every sync of a pose estimation is counted once: the
    per-site counts sum to host_syncs, each span's count is its own plus its
    children's, and each site lies in the program's package."""
    _toy_run(dev, tracks=2000, views=8, max_iterations=100)  # builds the kernels
    out, got, n_groups = _toy_run(dev, tracks=2000, views=8, max_iterations=100)
    spans = got["spans"]
    assert got["host_syncs"] > 0
    assert got["host_syncs"] == sum(s["syncs"] for s in got["syncs_by_site"])
    outside = sum(s["syncs"] for s in got["syncs_by_site"] if s["stage"] is None)
    assert sum(s["self_syncs"] for s in spans) + outside == got["host_syncs"]
    for i, s in enumerate(spans):
        kids = sum(c["syncs"] for c in spans if c["parent"] == i)
        assert s["syncs"] == s["self_syncs"] + kids
    assert all(s["site"].startswith("orthosfm_torch/") for s in got["syncs_by_site"])
    assert {s["group"] for s in spans if s["name"] == "pose/tk"} == set(range(n_groups))
    assert all(c["route"] == "fused" for c in got["ba_calls"])


@pytest.mark.cuda
def test_the_group_loop_copies_no_index_to_the_card(dev):
    """In a traced pose estimation of the 16-view blob on the card no sync
    lies in data/tracks.py, nor in cameras.py's index rule (as_index, which
    makes the cameras' view ids) or the helpers that take indices or sizes
    (take, _vec): the group loop indexes only with its schedule's device
    tensors."""
    from orthosfm_torch.core import cameras as cam_mod

    _toy_run(dev, tracks=2400, views=16)  # builds the kernels
    _, got, _ = _toy_run(dev, tracks=2400, views=16)
    banned = set()
    for fn in (cam_mod.as_index, cam_mod.take, cam_mod._vec):
        src, first = inspect.getsourcelines(fn)
        banned |= {f"orthosfm_torch/core/cameras.py:{first + i}" for i in range(len(src))}
    sites = [s["site"] for s in got["syncs_by_site"]]
    assert got["host_syncs"] > 0
    assert not [s for s in sites if s.startswith("orthosfm_torch/data/tracks.py:")], sites
    assert not [s for s in sites if s in banned], sites


@pytest.mark.cuda
def test_a_kernel_lies_inside_the_span_that_launched_it_on_the_shared_clock(dev):
    """sfm_bench.trace.Trace maps the device trace onto time.monotonic, the
    clock of the program's spans: every kernel launched inside a span lies
    inside it, within 100 us."""
    sys.path.insert(0, str(ROOT))
    from sfm_bench import trace as trace_mod

    a = torch.randn(2048, 2048, device=dev)
    (a @ a).sum()
    torch.cuda.synchronize()
    tracer = trace_mod.Trace()
    tracer.begin()
    tracer.open_window()
    with profiling.collect_stages({}, dev):
        with profiling.stage("idle"):
            time.sleep(0.05)
        for _ in range(3):
            with profiling.stage("work"):
                for _ in range(20):
                    a = torch.tanh(a @ a * 1e-3)
            with profiling.stage("idle"):
                time.sleep(0.02)
    tracer.stop()
    work = [(s["t0"], s["t1"]) for s in profiling.traces()[-1]["spans"] if s["name"] == "work"]
    kernels = [(a0, b0) for name, a0, b0 in tracer.ops if "gemm" in name or "tanh" in name
               or "elementwise" in name]
    assert len(kernels) >= 3 * 20 * 2
    for a0, b0 in kernels:
        assert any(t0 - 1e-4 <= a0 and b0 <= t1 + 1e-4 for t0, t1 in work), (a0, b0, work)
