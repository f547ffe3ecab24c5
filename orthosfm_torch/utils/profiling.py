"""Profiling utilities: phase wall timers, stage attribution, device traces
and a recorder of bundle adjustments. Port of orthosfm_tpu/utils/profiling.py.

The reference's observability is coarse phase timers persisted to
time_measurements.txt (src/util/timing.cpp) plus per-stage prints. This module
keeps that surface (PhaseTimer), attributes wall time to named stages of the
pipeline (collect_stages / stage) with a span record a stage and the host
syncs made inside it (StageTrace, read out as a collector closes: traces()),
wraps a region in a torch.profiler trace
(device_trace) and records the bundle adjustments a region runs
(BARecorder).

Where it departs from the JAX module: that module swallows any exception of
its device barrier and of the profiler's start and stop, so that profiling
never breaks a run. Here nothing is caught: a failed torch.cuda.synchronize()
is a fault of the device (an earlier kernel's error surfaces there), and it
surfaces from the stage that ran into it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import os
import sys
import time
import warnings
from typing import Dict, List, Optional, Tuple

import torch


class PhaseTimer:
    """Named phase wall-clock timing (steady-clock analog of
    reference timing.h:19-31)."""

    def __init__(self):
        self._phases: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._phases.append((name, time.monotonic() - t0))

    def elapsed(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self._phases:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        return "\n".join(f"{name}: {dt:.3f} s" for name, dt in self.elapsed().items())


# ---------------------------------------------------------------------------
# Stage attribution (opt-in). Inside collect_stages(out, device), stage(name)
# regions add their wall time in seconds to out[name], with a device barrier
# on exit so asynchronous device work is attributed to the stage that
# enqueued it. A traced collector (the default) also keeps a span record a
# stage, and on a CUDA device counts every host sync the program makes by
# span and by call site; as it closes, its read-out goes to traces(). Outside
# a collector, stage is free: no clock, no barrier, no record; the pipeline
# keeps its asynchronous dispatch.

_STAGES: contextvars.ContextVar = contextvars.ContextVar("orthosfm_torch_stages", default=None)

#: the message of torch's warning for a synchronizing CUDA operation
#: (torch.cuda.set_sync_debug_mode("warn"))
SYNC_WARNING = "called a synchronizing CUDA operation"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PACKAGE)
_THIS = os.path.abspath(__file__)
_OUTSIDE = (os.path.dirname(os.path.abspath(torch.__file__)),
            os.path.splitext(os.path.abspath(warnings.__file__))[0])

# a span record: [name, t0, t1, parent, group, syncs, self_syncs]
NAME, T0, T1, PARENT, GROUP, SYNCS, SELF_SYNCS = range(7)

#: how many traced collectors' read-outs traces() keeps, the newest
TRACES_KEPT = 512
_TRACES: collections.deque = collections.deque(maxlen=TRACES_KEPT)


def traces() -> List[dict]:
    """The read-outs of the last TRACES_KEPT traced outermost collectors
    that closed without an error, oldest first: StageTrace.read()'s dict,
    with the collector's open and close on time.monotonic as "t0" and
    "t1"."""
    return list(_TRACES)


class StageTrace:
    """What a collector records beside its stage sums: a span a stage (name,
    start and end on time.monotonic, the index of its parent span, the
    group index of run_pose_estimation's loop, the host syncs inside it with
    and without its child spans), the host syncs by stage and call site, a
    record a group schedule and a Tomasi-Kanade call (with its route; read()
    counts the CUDA graphs captured), and the BARecorders opened inside the
    collector. host_syncs is None where the device is not a CUDA device
    (nothing counts syncs there)."""

    def __init__(self):
        self.spans: List[list] = []
        self.host_syncs: Optional[int] = None
        self.sites: Dict[tuple, int] = {}  # (stage, (file, line)): syncs
        self.grouping_calls: List[dict] = []
        self.tk_calls: List[dict] = []
        self.recorders: List[BARecorder] = []

    def read(self) -> dict:
        """The records as plain Python data, with the bundle adjustments of
        its recorders (BARecorder.records: one read of the device each)."""
        counted = self.host_syncs is not None
        spans = [{"name": s[NAME], "t0": s[T0], "t1": s[T1], "parent": s[PARENT],
                  "group": s[GROUP], "syncs": s[SYNCS] if counted else None,
                  "self_syncs": s[SELF_SYNCS] if counted else None} for s in self.spans]
        sites = ([{"stage": st, "site": f"{site[0]}:{site[1]}" if site else "unknown",
                   "syncs": n}
                  for (st, site), n in sorted(self.sites.items(), key=lambda kv: -kv[1])]
                 if counted else None)
        return {"spans": spans, "host_syncs": self.host_syncs, "syncs_by_site": sites,
                "ba_calls": [c for r in self.recorders for c in r.records()],
                "grouping_calls": [dict(c) for c in self.grouping_calls],
                "tk_calls": [dict(c) for c in self.tk_calls],
                "tk_captures": sum(c["route"] == "capture" for c in self.tk_calls)}


class _Collector:
    """The active collector: the stage sums, the device, the trace (None:
    the stage sums alone), the open spans (innermost last; a nested
    collector shares its enclosing one's), and whether counting is paused
    (its own barriers and reads)."""

    __slots__ = ("out", "device", "trace", "open", "muted")

    def __init__(self, out, device, trace, open_spans: List[int]):
        self.out, self.device, self.trace, self.open = out, device, trace, open_spans
        self.muted = False

    def span(self) -> Tuple[Optional[int], Optional[int]]:
        """The innermost open span's index and group index (None, None
        without one, or without a trace)."""
        if not self.open:
            return None, None
        return self.open[-1], self.trace.spans[self.open[-1]][GROUP]


def _device_barrier(device: torch.device) -> None:
    """Wait for every kernel enqueued on `device` (nothing to wait for on the
    CPU). A device fault raises here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _uncounted():
    """Host syncs of the enclosed region are not counted (the collector's
    own barriers and read-outs)."""
    c = _STAGES.get()
    if c is None or c.muted:
        yield
        return
    c.muted = True
    try:
        yield
    finally:
        c.muted = False


@functools.lru_cache(maxsize=None)
def _site_file(name: str):
    """A frame's file for call sites: its path relative to the repository
    where it lies in the program's package, "" where it lies elsewhere
    outside torch and the warnings module, None where it is skipped."""
    if name == _THIS or name.startswith(_OUTSIDE):
        return None
    if name.startswith(_PACKAGE + os.sep):
        return os.path.relpath(name, _ROOT)
    return ""


def _count_sync(c: "_Collector", f) -> None:
    """Counts one host sync against collector `c`: its innermost open span,
    and its call site, the innermost frame from `f` out that lies in the
    program's package (else the innermost outside torch and the warnings
    module)."""
    tr = c.trace
    tr.host_syncs += 1
    site = None
    while f is not None:
        code = f.f_code
        rel = _site_file(code.co_filename)
        if rel:
            site = (rel, f.f_lineno)
            break
        if rel is not None and site is None:
            site = (code.co_filename, f.f_lineno)
        f = f.f_back
    if c.open:
        span = tr.spans[c.open[-1]]
        span[SELF_SYNCS] += 1
        key = (span[NAME], site)
    else:
        key = (None, site)
    tr.sites[key] = tr.sites.get(key, 0) + 1


@contextlib.contextmanager
def _counting_syncs():
    """torch's sync debug mode at "warn" for the enclosed region, its sync
    warnings counted (_count_sync) and not shown; every other warning passes
    to the warnings module's showwarning as before. The previous mode is
    restored on exit."""
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            c = _STAGES.get()
            if (category is not UserWarning or c is None
                    or not str(message).startswith(SYNC_WARNING)):
                shown(message, category, filename, lineno, file, line)
            elif c.trace is not None and c.trace.host_syncs is not None and not c.muted:
                _count_sync(c, sys._getframe(1))

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(previous)


@contextlib.contextmanager
def collect_stages(out: Dict[str, float], device="cuda", trace: bool = True):
    """Activate stage collection into `out` for the enclosed region; each
    stage's barrier synchronizes `device` (the device of the pipeline's
    tensors). An outermost collector with `trace` also keeps a StageTrace:
    span records, TK calls and the BA calls of each BARecorder opened
    inside it, and on a CUDA device it sets torch's sync debug mode to
    "warn" and counts each sync warning in place of showing it. As it
    closes without an error it waits for the device and reads the trace
    out (one read of the device a recorder, not counted) for traces().
    With trace=False it keeps the stage sums alone, and leaves the mode. A
    nested collector adds to its own `out` and shares the enclosing
    collector's trace, or its lack of one."""
    device = torch.device(device)
    outer = _STAGES.get()
    hook = False
    if outer is not None:
        tr = outer.trace
    elif trace:
        tr = StageTrace()
        hook = device.type == "cuda" and torch.cuda.is_available()
        if hook:
            tr.host_syncs = 0
        t_open = time.monotonic()
    else:
        tr = None
    c = _Collector(out, device, tr, [] if outer is None else outer.open)
    token = _STAGES.set(c)
    try:
        with _counting_syncs() if hook else contextlib.nullcontext():
            yield out
            if outer is None and tr is not None:
                c.muted = True  # the barrier and the read-out are not the program's syncs
                _device_barrier(device)
                _TRACES.append({"t0": t_open, "t1": time.monotonic(), **tr.read()})
    finally:
        _STAGES.reset(token)


@contextlib.contextmanager
def stage(name: str, group: Optional[int] = None):
    """Attribute the enclosed region (with the device work it enqueued) to
    `name` when a collector is active; free otherwise. `group`: the group
    index of run_pose_estimation's loop, which nested spans inherit (kept
    in the collector's trace, where it has one)."""
    c = _STAGES.get()
    if c is None:
        yield
        return
    tr = c.trace
    if tr is None:
        t0 = time.monotonic()
        try:
            yield
        finally:
            _device_barrier(c.device)
            c.out[name] = c.out.get(name, 0.0) + (time.monotonic() - t0)
        return
    parent, inherited = c.span()
    idx = len(tr.spans)
    syncs0 = tr.host_syncs
    t0 = time.monotonic()
    tr.spans.append([name, t0, None, parent, inherited if group is None else group, None, 0])
    c.open.append(idx)
    try:
        yield
    finally:
        c.open.pop()
        muted, c.muted = c.muted, True  # the barrier is not the program's sync
        try:
            _device_barrier(c.device)
        finally:
            c.muted = muted
        t1 = time.monotonic()
        c.out[name] = c.out.get(name, 0.0) + (t1 - t0)
        rec = tr.spans[idx]
        rec[T1] = t1
        if syncs0 is not None:
            rec[SYNCS] = tr.host_syncs - syncs0


def record_grouping(tracks: int, views: int, patterns: Optional[int], groups: int) -> None:
    """Record a group schedule (pipeline.grouping.build_groups) in the
    active collector's trace (free without one): the incidence's tracks and
    views, the distinct support patterns the tracks collapsed to (None for
    group sizes other than 3, which do not collapse them) and the groups
    made."""
    c = _STAGES.get()
    if c is None or c.trace is None:
        return
    c.trace.grouping_calls.append({"tracks": int(tracks), "views": int(views),
                                   "patterns": None if patterns is None else int(patterns),
                                   "groups": int(groups)})


def record_tk(views, tracks: int, ransac, fallback: bool, route: str) -> None:
    """Record a Tomasi-Kanade initialization in the active collector's trace
    (free without one): its group index, its views, the full-size tracks
    it used, the hypotheses drawn (`ransac`'s max_iterations), whether it
    took the unfiltered fallback tracks, and its route (pipeline.tk_graphs:
    "replay", a CUDA graph's; "capture", the eager run and capture of a
    shape's first call; "eager", the eager code alone)."""
    c = _STAGES.get()
    if c is None or c.trace is None:
        return
    c.trace.tk_calls.append({"group": c.span()[1], "views": [int(v) for v in views],
                             "tracks": int(tracks), "hypotheses": int(ransac.max_iterations),
                             "fallback": bool(fallback), "route": route})


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """A torch.profiler trace of the enclosed region, written to `logdir` as a
    Chrome trace (*.pt.trace.json) that TensorBoard's profiler plugin and
    Perfetto read. CUDA kernels are traced when `device` is a CUDA device
    (the default; without one this raises, naming device="cpu"), host
    operators always. Yields the profiler (key_averages() and the like)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from orthosfm_torch.pipeline.matching import checked_device

    activities = [ProfilerActivity.CPU]
    if checked_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def kernel_runs(names: Dict[str, str]):
    """Over the enclosed block, the kernels that ran on the card, by
    torch.profiler's (CUPTI's) kernel records: yields a dict of ``names``'
    keys, filled in as the block ends with the records whose kernel name
    holds that key's value. A kernel a CUDA graph replays counts as one
    launched from the host does; a capture runs none."""
    from torch.profiler import ProfilerActivity, profile

    out = dict.fromkeys(names, 0)
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        yield out
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            for key, name in names.items():
                out[key] += name in e.name()


# ---------------------------------------------------------------------------
# Bundle adjustments of a region

_BA_RECORDER: contextvars.ContextVar = contextvars.ContextVar("orthosfm_torch_ba", default=None)


class BARecorder:
    """Records every solvers.ba.run call made inside `recording()`: its
    camera and track counts, its route ("fused", "kernel" or "torch"), the
    route of lm_fused's camera solve (`solve_route`: "warp", "cta",
    "cluster" or "grid", ba_kernels.fused_solve_route; None on the other
    routes and on the CPU), max_iterations, its observation count (the
    mask's sum, on the device) and the sum over its tracks of the square of
    the views that observe each (`sum_views_sq`, on the device: the Schur
    term's work), its final LM state (ba_kernels.STATE_SIZE floats on the
    device, which ba.run allocates anew each call and does not write once
    it returns), the group index and span of the active collector (None
    without one), and its start and end on time.monotonic: the host time
    until it returned (its enqueue time on the card, where ba.run does not
    wait for the device). The device values are read once, by the first of
    summary() and records() after the last call. A recorder opened inside a
    traced collector also gives its calls to the collector's read-out."""

    def __init__(self):
        self.calls: List[tuple] = []
        self._host: List[list] = []

    @contextlib.contextmanager
    def recording(self):
        c = _STAGES.get()
        if c is not None and c.trace is not None and self not in c.trace.recorders:
            c.trace.recorders.append(self)
        token = _BA_RECORDER.set(self)
        try:
            yield self
        finally:
            _BA_RECORDER.reset(token)

    def add(self, views: int, tracks: int, route: str, solve_route: Optional[str],
            max_iterations: int, mask: torch.Tensor, state: torch.Tensor, t0: float,
            t1: float):
        c = _STAGES.get()
        parent, group = c.span() if c is not None else (None, None)
        per_track = torch.sum(mask, dim=1)
        counts = torch.stack([torch.sum(per_track), torch.sum(per_track * per_track)])
        self.calls.append((views, tracks, route, solve_route, max_iterations, counts, state,
                           group, parent, t0, t1))

    def _read(self) -> List[list]:
        """Each call's observation count, its sum of squared views a track
        and its final state, in one read of the device (not counted as a
        host sync of a collector)."""
        if len(self._host) != len(self.calls):
            with _uncounted():
                counts = torch.stack([c[5] for c in self.calls]).to(torch.float64)
                state = torch.stack([c[6] for c in self.calls]).to(torch.float64)
                self._host = torch.cat([counts, state], dim=1).cpu().tolist()
        return self._host

    def records(self) -> List[dict]:
        """A dict a call: views, tracks, observations, sum_views_sq, route,
        solve_route, max_iterations, iterations (that worked), lam, cost,
        initial_cost, done, group, parent, t0, t1."""
        from orthosfm_torch.solvers import ba_kernels as bk

        out = []
        for (views, tracks, route, solve_route, max_it, _, _, group, parent, t0, t1), row in zip(
                self.calls, self._read()):
            s = row[2:]
            out.append({"views": views, "tracks": tracks, "observations": int(row[0]),
                        "sum_views_sq": int(row[1]), "route": route,
                        "solve_route": solve_route, "max_iterations": max_it,
                        "iterations": int(s[bk.ITERS]), "lam": s[bk.LAM], "cost": s[bk.COST],
                        "initial_cost": s[bk.INIT_COST], "done": bool(s[bk.DONE]),
                        "group": group, "parent": parent, "t0": t0, "t1": t1})
        return out

    def summary(self) -> dict:
        """Calls, LM iterations launched and those that did work, and the
        same counts by the calls' camera count (`by_views`), by route
        (`by_route`, with each route's host time) and, for lm_fused's calls
        on the card, by the route of its camera solve (`by_solve_route`,
        with host time too). The per-iteration routes launch max_iterations
        iterations a call, converged or not; the fused route (one launch a
        call) runs the iterations that work and stops, so there the two
        counts are the same. enqueue_ms_per_it: the host's time per launched
        iteration of the per-iteration routes (0 without one)."""
        by_views: Dict[int, dict] = {}
        by_route: Dict[str, dict] = {}
        by_solve_route: Dict[str, dict] = {}
        calls = self.records()
        for c in calls:
            w = c["iterations"]
            launched = w if c["route"] == "fused" else c["max_iterations"]
            keyed = [(c["views"], by_views), (c["route"], by_route)]
            if c["solve_route"] is not None:
                keyed.append((c["solve_route"], by_solve_route))
            for key, table in keyed:
                row = table.setdefault(key, {"ba_calls": 0, "iterations_launched": 0,
                                             "iterations_worked": 0})
                row["ba_calls"] += 1
                row["iterations_launched"] += launched
                row["iterations_worked"] += w
                if table is not by_views:
                    row["host_ms"] = row.get("host_ms", 0.0) + (c["t1"] - c["t0"]) * 1e3
        per_it = [r for k, r in by_route.items() if k != "fused"]
        per_it_launched = sum(r["iterations_launched"] for r in per_it)
        return {"ba_calls": len(calls),
                "iterations_launched": sum(r["iterations_launched"] for r in by_route.values()),
                "iterations_worked": sum(c["iterations"] for c in calls),
                "enqueue_ms_per_it": (sum(r["host_ms"] for r in per_it) / per_it_launched
                                      if per_it_launched else 0.0),
                "by_views": by_views, "by_route": by_route, "by_solve_route": by_solve_route}


def ba_recorder():
    """The active BARecorder, or None."""
    return _BA_RECORDER.get()
