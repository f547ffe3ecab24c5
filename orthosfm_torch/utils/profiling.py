"""Profiling utilities: phase wall timers, stage attribution, device traces
and a recorder of bundle adjustments. Port of orthosfm_tpu/utils/profiling.py.

The reference's observability is coarse phase timers persisted to
time_measurements.txt (src/util/timing.cpp) plus per-stage prints. This module
keeps that surface (PhaseTimer), attributes wall time to named stages of the
pipeline (collect_stages / stage), wraps a region in a torch.profiler trace
(device_trace) and records the bundle adjustments a region runs
(BARecorder).

Where it departs from the JAX module: that module swallows any exception of
its device barrier and of the profiler's start and stop, so that profiling
never breaks a run. Here nothing is caught: a failed torch.cuda.synchronize()
is a fault of the device (an earlier kernel's error surfaces there), and it
surfaces from the stage that ran into it.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, Tuple

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
# enqueued it. Outside a collector, stage is free and inserts no barrier: the
# pipeline keeps its asynchronous dispatch.

_STAGES: contextvars.ContextVar = contextvars.ContextVar("orthosfm_torch_stages", default=None)


def _device_barrier(device: torch.device) -> None:
    """Wait for every kernel enqueued on `device` (nothing to wait for on the
    CPU). A device fault raises here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def collect_stages(out: Dict[str, float], device="cuda"):
    """Activate stage collection into `out` for the enclosed region; each
    stage's barrier synchronizes `device` (the device of the pipeline's
    tensors)."""
    token = _STAGES.set((out, torch.device(device)))
    try:
        yield out
    finally:
        _STAGES.reset(token)


@contextlib.contextmanager
def stage(name: str):
    """Attribute the enclosed region (with the device work it enqueued) to
    `name` when a collector is active; free otherwise."""
    active = _STAGES.get()
    if active is None:
        yield
        return
    out, device = active
    t0 = time.monotonic()
    try:
        yield
    finally:
        _device_barrier(device)
        out[name] = out.get(name, 0.0) + (time.monotonic() - t0)


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


# ---------------------------------------------------------------------------
# Bundle adjustments of a region

_BA_RECORDER: contextvars.ContextVar = contextvars.ContextVar("orthosfm_torch_ba", default=None)


class BARecorder:
    """Records every solvers.ba.run call made inside `recording()`: its
    camera count, its route ("fused", "kernel" or "torch"), max_iterations,
    its BAResult.iterations tensor (read once, in summary()) and the host
    time until it returned (its enqueue time on the card, where ba.run does
    not wait for the device)."""

    def __init__(self):
        self.calls: List[Tuple[int, str, int, torch.Tensor, float]] = []

    @contextlib.contextmanager
    def recording(self):
        token = _BA_RECORDER.set(self)
        try:
            yield self
        finally:
            _BA_RECORDER.reset(token)

    def add(self, views: int, route: str, max_iterations: int, iterations: torch.Tensor,
            host_s: float):
        self.calls.append((views, route, max_iterations, iterations, host_s))

    def summary(self) -> dict:
        """Calls, LM iterations launched and those that did work, and the
        same counts by the calls' camera count (`by_views`) and by route
        (`by_route`, with each route's host time). The per-iteration routes
        launch max_iterations iterations a call, converged or not; the fused
        route (one launch a call) runs the iterations that work and stops,
        so there the two counts are the same. enqueue_ms_per_it: the host's
        time per launched iteration of the per-iteration routes (0 without
        one)."""
        worked = ([int(x) for x in torch.stack([c[3] for c in self.calls]).cpu()]
                  if self.calls else [])
        by_views: Dict[int, dict] = {}
        by_route: Dict[str, dict] = {}
        for (views, route, max_it, _, host_s), w in zip(self.calls, worked):
            launched = w if route == "fused" else max_it
            for key, table in ((views, by_views), (route, by_route)):
                row = table.setdefault(key, {"ba_calls": 0, "iterations_launched": 0,
                                             "iterations_worked": 0})
                row["ba_calls"] += 1
                row["iterations_launched"] += launched
                row["iterations_worked"] += w
            by_route[route]["host_ms"] = by_route[route].get("host_ms", 0.0) + host_s * 1e3
        per_it = [r for k, r in by_route.items() if k != "fused"]
        per_it_launched = sum(r["iterations_launched"] for r in per_it)
        return {"ba_calls": len(self.calls),
                "iterations_launched": sum(r["iterations_launched"] for r in by_route.values()),
                "iterations_worked": sum(worked),
                "enqueue_ms_per_it": (sum(r["host_ms"] for r in per_it) / per_it_launched
                                      if per_it_launched else 0.0),
                "by_views": by_views, "by_route": by_route}


def ba_recorder():
    """The active BARecorder, or None."""
    return _BA_RECORDER.get()
