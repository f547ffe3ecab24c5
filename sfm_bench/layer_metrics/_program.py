"""The program's own record of each traced job: the read-out that its
outermost stage collector keeps as it closes (utils.profiling.traces(), its
open and close on time.monotonic, the harness's clock), matched to the job
whose [t0, t1] holds it. Nothing where the program keeps no read-outs."""


def by_job(records) -> list:
    """(job, read-out) for each traced job that completed and has one."""
    from orthosfm_torch.utils import profiling

    kept = getattr(profiling, "traces", None)
    if kept is None:
        return []
    outs = kept()
    pairs = []
    for j in records["jobs"]:
        if j["error"] is None:
            t = next((t for t in outs if j["t0"] <= t["t0"] and t["t1"] <= j["t1"]), None)
            if t is not None:
                pairs.append((j, t))
    return pairs
