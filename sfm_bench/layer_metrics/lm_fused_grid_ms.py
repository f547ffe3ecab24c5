"""Device milliseconds a profiled job in the whole-solve BA kernel's
launches whose camera solve is K3's grid route (lm_fused_kernel<true>, from
120 views; csrc/ba_kernels.cu via solvers/ba_kernels.py), from
torch.profiler's trace of the window's first jobs and the program's BA call
records (`solve_route`).

The trace's lm_fused launches are paired in order with the profiled jobs'
fused call records, one launch a call; where the trace keeps the kernel's
template argument, each launch's instantiation must agree with its call's
route. None where the counts or the instantiations disagree, where a
profiled job lacks its records, where the records lack `solve_route` (a
program that does not record it), or where no call took the grid route."""

from sfm_bench.layer_metrics._program import by_job

KERNEL = "lm_fused_kernel"
_GRID_ARG = {"true": True, "(bool)1": True, "1": True,
             "false": False, "(bool)0": False, "0": False}


def _grid_instantiation(name: str):
    """True or False for the <true> or <false> instantiation, None where the
    name holds no template argument."""
    rest = name[name.find(KERNEL) + len(KERNEL):]
    if not rest.startswith("<") or ">" not in rest:
        return None
    return _GRID_ARG.get(rest[1:rest.find(">")].strip())


def grid_launches(records):
    """([(call record, device seconds) of each profiled lm_fused launch
    whose camera solve is the grid route], the profiled jobs), or None (see
    the module)."""
    dev = records.get("device")
    if not dev:
        return None
    jobs = [j for j in records["jobs"] if j["t0"] >= dev["start"] and j["t1"] <= dev["end"]]
    traced = {id(j): t for j, t in by_job(records)}
    if not jobs or any(id(j) not in traced for j in jobs):
        return None
    calls = sorted((c for j in jobs for c in traced[id(j)]["ba_calls"] if c["route"] == "fused"),
                   key=lambda c: c["t0"])
    if any("solve_route" not in c or "sum_views_sq" not in c for c in calls):
        return None
    launches = sorted((op for op in dev["ops"] if KERNEL in op[0]), key=lambda op: op[1])
    if len(launches) != len(calls):
        return None
    grid = [c["solve_route"] == "grid" for c in calls]
    named = [_grid_instantiation(op[0]) for op in launches]
    if None not in named and named != grid:
        return None
    pairs = [(c, b - a) for c, g, (_, a, b) in zip(calls, grid, launches) if g]
    return (pairs, len(jobs)) if pairs else None


def read(records):
    got = grid_launches(records)
    if got is None:
        return None
    pairs, jobs = got
    return sum(dt for _, dt in pairs) * 1e3 / jobs
