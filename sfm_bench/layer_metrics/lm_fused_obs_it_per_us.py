"""The whole-solve BA kernel's work rate: over the jobs inside the profiled
part of the window, the sum over their fused bundle adjustments of
observations times LM iterations worked (the program's BA call records),
over lm_fused_kernel's device microseconds in torch.profiler's trace; None
unless every such job has its records."""

from sfm_bench.layer_metrics._program import by_job


def read(records):
    dev = records.get("device")
    if not dev:
        return None
    us = sum(b - a for name, a, b in dev["ops"] if "lm_fused_kernel" in name) * 1e6
    jobs = [j for j in records["jobs"] if j["t0"] >= dev["start"] and j["t1"] <= dev["end"]]
    traced = {id(j): t for j, t in by_job(records)}
    if us == 0.0 or not jobs or any(id(j) not in traced for j in jobs):
        return None
    work = sum(c["observations"] * c["iterations"] for j in jobs
               for c in traced[id(j)]["ba_calls"] if c["route"] == "fused")
    return work / us if work else None
