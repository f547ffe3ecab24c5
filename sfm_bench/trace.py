"""The device trace of a traced run: torch.profiler (CUPTI) over the first
part of the window, reduced to the device's operations, its busy time and
its idle gaps.

Kineto stamps events on the realtime clock in nanoseconds; the host's stage
spans are on time.monotonic. `Trace` keeps the offset between the two,
read when the profiler starts.
"""

from __future__ import annotations

import re
import time
from typing import List, Tuple

import numpy as np

#: device operations in the breakdown, and idle gaps by label
TOP = 10


class Trace:
    """A torch.profiler session over CUDA activity, started and stopped by the
    window; after `stop`, `ops` holds every device operation as (name,
    start, end) in seconds on the host's monotonic clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: List[Tuple[str, float, float]] = []
        self.start = self.end = 0.0

    def begin(self):
        self._prof.__enter__()
        self._offset = time.time_ns() * 1e-9 - time.monotonic()

    def open_window(self):
        self.start = time.monotonic()

    def stop(self):
        self.end = time.monotonic()
        self._prof.__exit__(None, None, None)
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            t0 = e.start_ns() * 1e-9 - self._offset
            self.ops.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
        self._prof = None

    def record(self) -> dict:
        return {"ops": self.ops, "start": self.start, "end": self.end}


def busy_intervals(ops, start: float, end: float):
    """The union of the operations' intervals, clipped to [start, end]."""
    out = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(dev: dict) -> float:
    return sum(b - a for a, b in busy_intervals(dev["ops"], dev["start"], dev["end"]))


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^(void|std::enable_if<[^ ]*>::type) ", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:120] or name[:120]


def breakdown(dev: dict, jobs: list) -> dict:
    """The device operations that took most time, and the longest idle gaps
    summed by what the host was in: the innermost stage span that holds the
    gap's middle, else "job, outside stages" or "between jobs"."""
    by_op = {}
    for name, a, b in dev["ops"]:
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + (b - a)
    busy = busy_intervals(dev["ops"], dev["start"], dev["end"])
    edges = np.asarray([dev["start"]] + [x for iv in busy for x in iv] + [dev["end"]])
    a, b = edges[0::2], edges[1::2]
    keep = b > a
    a, b = a[keep], b[keep]
    mid = 0.5 * (a + b)
    spans = [s for j in jobs for s in j.get("spans", [])
             if s[2] >= dev["start"] and s[1] <= dev["end"]]
    names = [s[0] for s in spans] + ["job, outside stages"] * len(jobs)
    s0 = np.asarray([s[1] for s in spans] + [j["t0"] for j in jobs])
    s1 = np.asarray([s[2] for s in spans] + [j["t1"] for j in jobs])
    # a job's own span counts as the widest, so it labels a gap only outside every stage
    width = np.where(np.arange(len(s0)) < len(spans), s1 - s0, 1e300)
    label = np.full(len(mid), -1)
    for lo in range(0, len(mid), 2048):
        m = mid[lo:lo + 2048, None]
        inside = (s0[None, :] <= m) & (m <= s1[None, :])
        best = np.argmin(np.where(inside, width[None, :], np.inf), axis=1)
        label[lo:lo + 2048] = np.where(inside.any(1), best, -1)
    by_gap = {}
    for i, dt in zip(label, b - a):
        k = names[i] if i >= 0 else "between jobs"
        by_gap[k] = by_gap.get(k, 0.0) + float(dt)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
