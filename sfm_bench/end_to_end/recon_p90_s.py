"""The 90th percentile (nearest rank) of the wall times of every job in the
window. It needs 100 jobs or more, so that ten lie beyond it; with fewer it
reads nothing."""

import math


def read(records):
    walls = sorted(j["wall_s"] for j in records["jobs"])
    if len(walls) < 100:
        return None
    return walls[math.ceil(0.9 * len(walls)) - 1]
