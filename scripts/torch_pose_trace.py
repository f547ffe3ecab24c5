"""Where the port's pose path spends its host syncs and its groups' time:
runs one cell of the benchmark (sfm_bench) traced, with the benchmark's own
command line, and prints, from the program's own records (utils.profiling's
read-out of each traced job, traces()), per-job means of:

- the host syncs by stage (each stage's own against its child stages') and
  by call site;
- the spans' time by stage and group, and the slowest groups with their
  TK call and local BA sizes;
- the BA calls by kind (local or global: the span that made them) with
  their sizes (with the sum over their tracks of the squared views that
  observe each, the Schur term's work), iterations, final damping and
  cost, and the route of lm_fused's camera solve;
- by the input's noise level, the TK fallbacks, the local BAs' sizes and
  the final BA's iterations, damping and convergence;
- the TK calls' sizes, the share of each route (a CUDA graph's replay, a
  shape's capture, the eager code) and the graphs captured a job.

    python3 scripts/torch_pose_trace.py --workload from_tracks.sweep16 --seed 7 --seconds 51

It takes the arguments of `sfm_bench/run.py` and runs its traced window
whatever --trace says (no --control). --dry-run walks the cell at its toy
size on the CPU (no sync is counted there). Needs the card otherwise.
"""

import json
import os
import statistics
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sfm_bench import harness  # noqa: E402
from sfm_bench.layer_metrics._program import by_job  # noqa: E402

TOP = 10
SLOWEST = 5


def _by(rows, key):
    out = {}
    for r in rows:
        out.setdefault(key(r), []).append(r)
    return out


def _mean(xs):
    xs = list(xs)
    return statistics.mean(xs) if xs else None


def _ba_row(calls, n):
    """A group of BA calls: calls a job, sizes, iterations, how they ended
    (final damping, cost over initial cost, convergence), and calls a job by
    the route of lm_fused's camera solve ("None": not lm_fused)."""
    return {"calls_a_job": len(calls) / n,
            "views": sorted({c["views"] for c in calls}),
            "tracks_mean": _mean(c["tracks"] for c in calls),
            "observations_mean": _mean(c["observations"] for c in calls),
            "sum_views_sq_mean": _mean(c["sum_views_sq"] for c in calls),
            "iterations_mean": _mean(c["iterations"] for c in calls),
            "at_max_iterations": sum(c["iterations"] >= c["max_iterations"] for c in calls),
            "done_share": _mean(c["done"] for c in calls),
            "lam_median": statistics.median(c["lam"] for c in calls),
            "cost_over_initial_mean": _mean(c["cost"] / c["initial_cost"] for c in calls
                                            if c["initial_cost"] > 0),
            "host_ms_mean": _mean((c["t1"] - c["t0"]) * 1e3 for c in calls),
            "routes": sorted({c["route"] for c in calls}),
            "solve_routes": {str(r): sum(c["solve_route"] == r for c in calls) / n
                             for r in sorted({c["solve_route"] for c in calls}, key=str)}}


def _kind(trace, call):
    """A BA call's kind: the name of the span that made it."""
    return trace["spans"][call["parent"]]["name"] if call["parent"] is not None else None


def summarize(pairs: list, noise_of) -> dict:
    """Per-job means over the traced jobs that completed, given as (job,
    the program's read-out) pairs; `noise_of` maps a job's input index to
    its noise level in pixels."""
    done = [j for j, _ in pairs]
    traced = [t for _, t in pairs]
    n = len(traced)
    out = {"jobs": n, "job_wall_s": _mean(j["wall_s"] for j in done)}
    syncs = [t["host_syncs"] for t in traced]
    if syncs and syncs[0] is not None:
        out["host_syncs"] = {"mean": statistics.mean(syncs), "min": min(syncs),
                             "max": max(syncs)}
        out["each_job_host_syncs_is_its_sites_sum"] = all(
            t["host_syncs"] == sum(s["syncs"] for s in t["syncs_by_site"]) for t in traced)
        # each stage's syncs a job, with its child stages' and its own
        stages = {}
        for t in traced:
            for s in t["spans"]:
                row = stages.setdefault(s["name"], [0, 0])
                row[0] += s["syncs"]
                row[1] += s["self_syncs"]
        out["syncs_by_stage"] = {
            name: {"with_children": w / n, "own": o / n, "children": (w - o) / n}
            for name, (w, o) in sorted(stages.items(), key=lambda kv: -kv[1][1])}
        out["syncs_outside_stages"] = sum(
            s["syncs"] for t in traced for s in t["syncs_by_site"] if s["stage"] is None) / n
        sites = {}
        for t in traced:
            for s in t["syncs_by_site"]:
                key = (s["stage"], s["site"])
                sites[key] = sites.get(key, 0) + s["syncs"]
        out["top_sites"] = [{"stage": k[0], "site": k[1], "syncs_a_job": v / n}
                            for k, v in sorted(sites.items(), key=lambda kv: -kv[1])[:TOP]]
    # time by stage and group: each stage's seconds a group, over the jobs
    by_stage, groups = {}, []
    for j, t in zip(done, traced):
        per = {}
        for s in t["spans"]:
            if s["group"] is not None:
                key = (s["name"], s["group"])
                per[key] = per.get(key, 0.0) + s["t1"] - s["t0"]
        for (name, g), dt in per.items():
            by_stage.setdefault(name, {}).setdefault(g, []).append(dt)
        tks = {c["group"]: c for c in t["tk_calls"]}
        local = {c["group"]: c for c in t["ba_calls"] if _kind(t, c) == "pose/local_ba"}
        for g in sorted(tks):
            top = [s for s in t["spans"] if s["group"] == g and s["parent"] is None]
            tk, ba = tks[g], local.get(g)
            groups.append({
                "input": j["input"], "group": g, "views": tk["views"],
                "seconds": sum(s["t1"] - s["t0"] for s in top),
                "syncs": (sum(s["syncs"] for s in top) if out.get("host_syncs") else None),
                "tk_tracks": tk["tracks"], "tk_fallback": tk["fallback"],
                "local_ba_tracks": ba["tracks"] if ba else None,
                "local_ba_observations": ba["observations"] if ba else None,
                "local_ba_iterations": ba["iterations"] if ba else None})
    out["stage_s_by_group"] = {}
    for name, per_group in sorted(by_stage.items()):
        means = {g: statistics.mean(v) for g, v in per_group.items()}
        slow = max(means, key=means.get)
        out["stage_s_by_group"][name] = {
            "groups": len(means), "median_s": statistics.median(means.values()),
            "max_s": means[slow], "slowest_group": slow,
            "first_s": means[min(means)], "last_s": means[max(means)]}
    out["slowest_groups"] = sorted(groups, key=lambda r: -r["seconds"])[:SLOWEST]
    calls = [(t, c) for t in traced for c in t["ba_calls"]]
    if calls:
        out["ba_calls_a_job"] = len(calls) / n
        out["ba"] = {str(kind): _ba_row([c for _, c in rows], n)
                     for kind, rows in sorted(_by(calls, lambda tc: str(_kind(*tc))).items())}
    tks = [c for t in traced for c in t["tk_calls"]]
    if tks:
        out["tk"] = {"calls_a_job": len(tks) / n,
                     "tracks_mean": statistics.mean(c["tracks"] for c in tks),
                     "tracks_min": min(c["tracks"] for c in tks),
                     "hypotheses": sorted({c["hypotheses"] for c in tks}),
                     "fallbacks": sum(c["fallback"] for c in tks), "calls": len(tks),
                     "route_shares": {r: sum(c["route"] == r for c in tks) / len(tks)
                                      for r in sorted({c["route"] for c in tks})},
                     "captures_a_job": sum(t["tk_captures"] for t in traced) / n}
    schedules = [c for t in traced for c in t["grouping_calls"]]
    if schedules:
        counted = [c for c in schedules if c["patterns"] is not None]
        out["grouping"] = {
            "calls_a_job": len(schedules) / n,
            "seconds_a_job": sum(s["t1"] - s["t0"] for t in traced for s in t["spans"]
                                 if s["name"] == "pose/grouping") / n,
            "tracks_mean": _mean(c["tracks"] for c in schedules),
            "views": sorted({c["views"] for c in schedules}),
            "patterns_mean": _mean(c["patterns"] for c in counted),
            "patterns_over_tracks_mean": _mean(c["patterns"] / c["tracks"] for c in counted
                                               if c["tracks"]),
            "groups_mean": _mean(c["groups"] for c in schedules)}
    # by the input's noise level: TK's fallbacks, the local BAs' sizes and
    # how the job's last (global) BA ended
    out["by_noise_px"] = {}
    for noise, rows in sorted(_by(list(zip(done, traced)),
                                  lambda jt: noise_of(jt[0]["input"])).items()):
        ts = [t for _, t in rows]
        last = [t["ba_calls"][-1] for t in ts if t["ba_calls"]]
        local = [c for t in ts for c in t["ba_calls"] if _kind(t, c) == "pose/local_ba"]
        tk = [c for t in ts for c in t["tk_calls"]]
        out["by_noise_px"][str(noise)] = {
            "jobs": len(ts),
            "tk_fallback_share": _mean(c["fallback"] for c in tk),
            "local_ba_observations_mean": _mean(c["observations"] for c in local),
            "final_ba": _ba_row(last, len(ts)) if last else None}
    return out


def main(argv=None):
    args = harness.parse(argv)
    if args.control:
        raise SystemExit("--control judges answers; this script judges none")
    import torch

    bench = harness.load_json(REPO, "BENCHMARK.json")
    spec = harness.cell(bench, args.workload)
    if args.dry_run:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device (or --dry-run)")
    else:
        device = torch.device("cuda", 0)
    harness.port.build_kernels(device)
    with tempfile.TemporaryDirectory(prefix="pose_trace_") as workdir:
        runner = harness.Runner(spec, args.seed, device, workdir, args.dry_run)
        runner.warm_up()
        jobs, _, window_s, _ = runner.window(args.seconds, trace=True)
    out = {"workload": args.workload, "seed": args.seed, "window_s": window_s,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           **summarize(by_job({"jobs": jobs}), lambda i: runner.inputs[i].noise_px)}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
