"""What the per-layer readers share: per-job means of the program's stage
sums (its stage collector: each stage's seconds up to its device barrier)
and device time by kernel name from the trace."""


def mean_of(records, keep):
    """The mean over the traced jobs of the seconds in the stages whose
    names `keep` accepts; None where no job ran such a stage."""
    jobs = [j for j in records["jobs"] if "stages" in j and j["error"] is None]
    sums = [sum(v for k, v in j["stages"].items() if keep(k)) for j in jobs]
    if not any(k for j in jobs for k in j["stages"] if keep(k)):
        return None
    return sum(sums) / len(sums)


def device_ms(records, part):
    """Device milliseconds a profiled job in the kernels whose names hold
    `part`; None where the trace holds none."""
    dev = records.get("device")
    if not dev:
        return None
    ms = sum(b - a for name, a, b in dev["ops"] if part in name) * 1e3
    jobs = [j for j in records["jobs"] if j["t0"] >= dev["start"] and j["t1"] <= dev["end"]]
    if ms == 0.0 or not jobs:
        return None
    return ms / len(jobs)
