"""The share of the profiled part of the window in which no operation ran on
the device (the complement of the union of its kernels', copies' and sets'
intervals), under the stage barriers of a traced run."""

from sfm_bench import trace


def read(records):
    dev = records.get("device")
    if not dev or not dev["ops"]:
        return None
    window = dev["end"] - dev["start"]
    return 100.0 * (1.0 - trace.busy_seconds(dev) / window)
