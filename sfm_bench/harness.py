"""Runs one cell of BENCHMARK.json once: set-up, a closed-loop window of
whole reconstructions, the judge, one result line.

Everything a cell needs is found by name:
  BENCHMARK.json            the cell, its configuration and its metrics
  configs/<config>.json     the entry it drives and the ReconstructionConfig
                            fields it sets
  mixes/<traffic>.json      the generator of its inputs and their parameters
  limits/<workload>.json    the limit of each number the judge compares
  end_to_end/<metric>.py    read(records) -> number or None, host clock
  layer_metrics/<metric>.py read(records) -> number or None, from the
                            traced run's stage spans, counters and trace

The window runs whole jobs one after another, cycling through the inputs
made in set-up, until `seconds` have passed and the job in flight is done;
each job ends in torch.cuda.synchronize(). With trace 1 every job runs
under the program's stage collector (each stage ends in a device barrier)
and BA recorder, and torch.profiler traces the device over the first
TRACE_SECONDS of the window (whole jobs).

With --control, the control's answers are judged in the program's place
(the same checks, the same `correct`): a run in which `correct` has to come
out false. The benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from sfm_bench import port
from sfm_bench import trace as trace_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "orthosfm_tpu")
TRACE_SECONDS = 6.0

EXIT_NO_CARD, EXIT_NO_PROGRAM, EXIT_FORBIDDEN = 3, 4, 5


class Stop(Exception):
    """Ends a run with an exit code and no result line."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    """The cell's entries and files: workload, config entry, configuration
    file, mix, limits."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise Stop(2, f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return {"workload": wl, "entry": entry, "config": load_json(ROOT, entry["file"]),
            "mix": load_json(HERE, "mixes", f"{wl['traffic']}.json"),
            "limits": load_json(HERE, "limits", f"{wl['name']}.json")}


def metrics_for(bench: dict, key: str, workload: str) -> list:
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def reader(kind: str, name: str):
    """read(records) of the metric `name` from `kind` (end_to_end or
    layer_metrics)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"sfm_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dirs() -> None:
    """Every build and kernel cache that torch or CUDA may keep, at fixed
    paths inside the checkout (the program's own kernels build into
    orthosfm_torch/_build there)."""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def freeze_setup() -> None:
    """The harness's objects of set-up (the inputs and their copies) out of
    the garbage collector's reach (gc.freeze), so that its passes in the
    window walk only what the window makes."""
    import gc

    gc.collect()
    gc.freeze()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def same_answer(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k]
               for k in a)


class Runner:
    """One run of one cell on `device`."""

    def __init__(self, spec: dict, seed: int, device, workdir: str, dry_run: bool):
        from sfm_bench.inputs import generate

        self.spec, self.device, self.workdir = spec, device, workdir
        mix = dict(spec["mix"])
        toy = mix.pop("dry_run", {})
        if dry_run:
            mix.update(toy)
        self.mix = mix
        self.images = mix["generator"] == "rendered_images"
        self.inputs = generate.make_inputs(mix, seed, workdir, device)
        self.handed = [self._hand(i, inp) for i, inp in enumerate(self.inputs)]

    def _hand(self, i, inp):
        """The program's input for `inp`: its TrackSet on the device, or its
        configuration naming the image folder and a project folder."""
        fields = self.spec["config"]["reconstruction"]
        if not self.images:
            cfg = port.reconstruction_config(fields, inp.solver, inp.program_seed)
            return cfg, port.trackset(inp.obs, self.device)
        project = os.path.join(self.workdir, f"project_{i}")
        os.makedirs(project, exist_ok=True)
        cfg = port.reconstruction_config(fields, inp.solver, inp.program_seed,
                                              project_folder=project,
                                              image_folder=inp.image_folder)
        return cfg, None

    def job(self, i: int):
        cfg, tracks = self.handed[i]
        if self.images:
            return port.run_images(cfg, self.device)
        return port.run_tracks(tracks, self.inputs[i].wh, cfg)

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def warm_up(self):
        """One job of each kind of input (a cloud and solver, or a solver):
        every shape the window runs."""
        seen = set()
        for i, inp in enumerate(self.inputs):
            if inp.key not in seen:
                seen.add(inp.key)
                self.job(i)
                self.sync()

    def window(self, seconds: float, trace: bool):
        """The closed loop, for `seconds` and the job in flight, and on until
        the mix's `min_jobs` have run (a tail needs its samples). Returns
        (jobs, answers by input, window seconds, device trace record or
        None)."""
        jobs, answers = [], {}
        tracer = trace_mod.Trace() if trace and self.device.type == "cuda" else None
        n = len(self.inputs)
        if tracer:
            tracer.begin()  # CUPTI's start-up takes seconds: before the window opens
        self.sync()
        t_start = time.monotonic()
        if tracer:
            tracer.open_window()
        min_jobs = max(1, self.mix.get("min_jobs", 1))
        while len(jobs) < min_jobs or time.monotonic() - t_start < seconds:
            i = len(jobs) % n
            rec, error, result = None, None, None
            t0 = time.monotonic()
            try:
                if trace:
                    with port.recording(self.device) as rec:
                        result = self.job(i)
                else:
                    result = self.job(i)
                self.sync()
            except Exception as e:  # noqa: BLE001 - a job that raises counts as failed
                error = f"{type(e).__name__}: {e}"
            t1 = time.monotonic()
            job = {"input": i, "wall_s": t1 - t0, "t0": t0, "t1": t1, "error": error}
            if tracer and tracer.start and not tracer.end and t1 - t_start >= TRACE_SECONDS:
                tracer.stop()
            if result is not None:
                ans = port.answer(result, with_obs=self.images)
                del result
                job["placed"] = int(ans["present"].sum())
                if job["placed"] < len(ans["present"]):
                    job["error"] = f"placed {job['placed']} of {len(ans['present'])} views"
                kept = answers.setdefault(i, [])
                if not any(same_answer(ans, a) for a in kept):
                    kept.append(ans)
            if rec is not None and error is None:
                job.update(stages=dict(rec.stages), spans=list(rec.spans),
                           ba_iterations=port.ba_iterations(rec))
                if self.images:
                    job["timing"] = self._timing(i)
            jobs.append(job)
        window_s = time.monotonic() - t_start
        if tracer and not tracer.end:
            tracer.stop()
        return jobs, answers, window_s, (tracer.record() if tracer else None)

    def _timing(self, i):
        """The phases of the job's time_measurements.txt ("Initialization
        Time [s] = 0.68", ...), by their first word in lower case."""
        cfg, _ = self.handed[i]
        with open(os.path.join(cfg.project_folder, "time_measurements.txt")) as f:
            return {ln.split()[0].lower(): float(ln.split("=")[1]) for ln in f if "=" in ln}

    def judge(self, answers: dict, control: bool) -> list:
        """Every distinct answer the window produced, judged: one per input
        unless the program answered one input in two ways."""
        from sfm_bench.reference import judge

        out = []
        for i, kept in sorted(answers.items()):
            inp = self.inputs[i]
            job = {"obs": inp.obs, "wh": inp.wh, "gt_R": inp.gt_R, "noise_px": inp.noise_px}
            for ans in kept:
                nums = judge.judge(ans, job, self.mix.get("accuracy_bars", []), self.device,
                                   control=control)
                out.append({"input": inp.name, "answers": len(kept), **nums})
        return out


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(args, t_process: float) -> dict:
    bench = load_json(ROOT, "BENCHMARK.json")
    spec = cell(bench, args.workload)
    import torch

    if args.dry_run:
        device = torch.device("cpu")
    else:
        need = spec["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise Stop(EXIT_NO_CARD, f"the cell needs {need} CUDA device(s); found "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    if not port.present(ROOT):
        raise Stop(EXIT_NO_PROGRAM, "the program (orthosfm_torch) is not in this checkout")
    workdir = tempfile.mkdtemp(prefix="sfm_bench_")
    try:
        return _run(args, bench, spec, device, workdir, t_process)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, bench, spec, device, workdir, t_process) -> dict:
    import torch

    port.build_kernels(device)
    runner = Runner(spec, args.seed, device, workdir, args.dry_run)
    runner.warm_up()
    runner.sync()
    freeze_setup()
    setup_s = time.monotonic() - t_process
    cuda = device.type == "cuda"
    if cuda:
        peak_setup = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    jobs, answers, window_s, dev = runner.window(args.seconds, bool(args.trace))
    info = device_info(device)
    if cuda:
        info["memory_peak_bytes"] = max(peak_setup, info["memory_peak_bytes"])
    wl = spec["workload"]["name"]
    records = {"setup_s": setup_s, "window_s": window_s, "jobs": jobs,
               "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
               "device": dev}
    failed = sum(1 for j in jobs if j["error"])
    print(f"jobs {len(jobs)} in a window of {window_s:.3f} s, {failed} failed; inputs "
          f"{len(runner.inputs)}; setup {setup_s:.3f} s", file=sys.stderr)
    print("job walls " + " ".join(f"{j['wall_s']:.3f}" for j in jobs), file=sys.stderr)
    for j in jobs:
        if j["error"]:
            print(f"  job {j['input']} ({runner.inputs[j['input']].name}): {j['error']}",
                  file=sys.stderr)
    # --trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer ones
    key, kind = ("per_layer", "layer_metrics") if args.trace else ("end_to_end", "end_to_end")
    metrics = {}
    for m in metrics_for(bench, key, wl):
        v = reader(kind, m["name"])(records)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if dev is not None:
        info["busy_s"] = trace_mod.busy_seconds(dev)
        info["window_s"] = dev["end"] - dev["start"]
    out = {"correct": False, "attempted": len(jobs), "failed": failed}
    if args.dry_run:
        out["metrics"] = {}
        out["dry_run"] = {f"cpu_{k}": v["value"] for k, v in metrics.items()}
    else:
        out["metrics"] = metrics
    out["device"] = info
    if dev is not None:
        out["breakdown"] = trace_mod.breakdown(dev, [j for j in jobs if "spans" in j])
    del runner.handed
    if cuda:
        torch.cuda.empty_cache()
    if args.control:  # the program's own numbers beside the control's, to read
        for j in runner.judge(answers, control=False):
            print("judged program " + json.dumps(j), file=sys.stderr)
    t_judge = time.monotonic()
    judged = runner.judge(answers, control=args.control)
    print(f"judged {len(judged)} answers in {time.monotonic() - t_judge:.3f} s"
          + (" (the control's, in the program's place)" if args.control else ""),
          file=sys.stderr)
    for j in judged:
        print("judged " + json.dumps(j), file=sys.stderr)
    checks = {}
    for name, limit in spec["limits"].items():
        vals = [j[name] for j in judged if name in j]
        if vals:
            checks[name] = {"value": max(vals), "limit": limit}
    # every number the cell's limits name has to be read, and be within its limit
    out["correct"] = failed == 0 and set(checks) == set(spec["limits"]) and all(
        c["value"] <= c["limit"] for c in checks.values())
    out["checks"] = checks
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="sfm_bench", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    p.add_argument("--dry-run", action="store_true",
                   help="walk the cell at its toy size on the CPU (checks paths, files and the "
                        "result line; no device metric)")
    p.add_argument("--control", action="store_true",
                   help="judge the control's answers (the reference's step from each of the "
                        "program's answers, in TF32) in the program's place: `correct` has to "
                        "come out false")
    return p.parse_args(argv)


def main(argv=None, t_process: float | None = None) -> int:
    t_process = time.monotonic() if t_process is None else t_process
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    try:
        out = run(args, t_process)
    except Stop as e:
        print(f"sfm_bench: {e}", file=sys.stderr)
        return e.code
    # the window has closed and the judge has run: nothing of JAX may be loaded
    found = forbidden_modules()
    if found:
        print("sfm_bench: modules loaded that the port may not use: " + ", ".join(found),
              file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
