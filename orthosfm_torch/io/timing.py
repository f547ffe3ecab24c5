"""Phase timing measurements (reference: src/util/timing.cpp:14-52).

time_measurements.txt format::

    Initialization Time [s] = <v>
    Track Building Time [s] = <v>
    Pose Estimation Time [s] = <v>
    Total Time [s] = <v>
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TimeMeasurements:
    init_time: float = 0.0
    track_building_time: float = 0.0
    pose_estimation_time: float = 0.0
    total_time: float = 0.0


def save_runtimes(path: str, init: float, track: float, pose: float, total: float) -> None:
    with open(path, "w") as f:
        f.write(f"Initialization Time [s] = {init:g}\n")
        f.write(f"Track Building Time [s] = {track:g}\n")
        f.write(f"Pose Estimation Time [s] = {pose:g}\n")
        f.write(f"Total Time [s] = {total:g}\n")


def load_runtimes(path: str) -> TimeMeasurements:
    m = TimeMeasurements()
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    fields = ["init_time", "track_building_time", "pose_estimation_time", "total_time"]
    for i, line in enumerate(lines[:4]):
        setattr(m, fields[i], float(line.split("=")[1]))
    return m
