#!/usr/bin/env python3
"""Times K3 (camera_solve, csrc/ba_kernels.cu) by each of its routes that
can serve a size, beside the library's Cholesky (torch.linalg.cholesky_ex
then torch.cholesky_solve) and torch.linalg.solve_ex on the same prepared
system, on one GPU, and holds each route to an f64 solve.

    python3 scripts/torch_k3_routes.py [--views 64 128 256 512 700 1100 2000]
                                       [--tracks 300] [--split] [--fused]
                                       [--ba-run 2000x2000 ...]
                                       [--tree DIR ...] [--json OUT]

For each view count V the system is the standard BA problem's
(testbench.problems.make_problem: quaternion cameras, V views of a sphere
of `--tracks` points, every track seen by every view) reduced camera system
S' from the plain version of K1 at lambda 1e-3, so every route solves the
same n = 6V system. Each route (one CTA up to 37 views, the cluster of 8
CTAs up to 1365, the grid route at any size) is timed by CUDA events, its
error against the f64 solve printed beside the plain f32 LU's. The
automatic choice (camera_solve_route) switches to the grid route at the
crossover these times give (GRID_MIN_V in the CUDA source).

--split also gives the grid route's time by launch kind (torch.profiler's
device time by kernel name: grid_init, grid_solve and grid_finish, or an
older tree's grid_panel, grid_update and grid_backsub, one launch a panel)
and its launches a solve; and, where the tree's timing build
(ba_kernels.timing_library) stamps the grid_solve launch
(osfm_grid_solve_stamps: %globaltimer at every grid barrier, read by CTA
0), that launch's time by stage: the first panel's diagonal block (its
first sub-panel, the rest of its factor and inverse, and the write-out and
barrier), the panels' row solves (trsm), their trailing updates with the
next diagonal block's factorization and inverse (update), and the back
substitution.

--fused also times K3 as lm_fused's camera solve stage at each V below
120 views, by each of the two routes it can take there: two copies of the
source whose GRID_MIN_V puts the cluster or the grid route at every size
from 6 views, built with the timing defines under orthosfm_torch/_build/
variants/, each timed by kernel_bench.lm_fused_split (ms of the solve
stage and of the whole iteration, 10 iterations that all work); and where
the main build's camera solve at V is the grid route, that route's time by
stage inside lm_fused (one iteration of the timing build, stamped as
--split stamps grid_solve's own launch).

--grid-variants also times the grid route from more copies of the
source: `all_sms`, its cooperative launch on one CTA a SM (as inside
lm_fused) instead of the CTAs its first update and back substitution can
use; `noinline`, grid_solve's body called as a function of its own;
`fused_call`, lm_fused's grid stage so called; `diag_inline`, the
diagonal block inlined; and `grid_constant`, lm_fused's argument
`__grid_constant__`. Each copy's own launches are checked bit for bit against the main build's and timed,
and where lm_fused's camera solve is the grid route its solve stage too
(kernel_bench.lm_fused_split, 10 iterations that all work); each copy's
ptxas -v usage is printed.

--ba-run VxT times ba.run on the card (its default route: lm_fused up to
FUSED_MAX_VIEWS views, past that K1, K3 and K2 an iteration) at V views x T
tracks, 10 iterations, in ms an iteration to a synchronize.

--tree DIR (repeatable) runs everything once for each checkout DIR, in
turns (scripts/torch_turns.py: each in a process of its own that imports
DIR's orthosfm_torch and builds its kernels from DIR's csrc/), in the
order given. Prints a table and one JSON object; needs CUDA.
"""

import argparse
import ctypes
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import torch_turns
from torch_turns import REPO

# the grid route's launches by kind, as their kernels are named
LAUNCH_KINDS = ("grid_init", "grid_panel", "grid_update", "grid_backsub", "grid_solve",
                "grid_finish")
# the grid_solve launch's stages, in the order of the CUDA source's stamp
# kinds: the first diagonal block's write-out and barrier, the panels' row
# solves, their updates, the back substitution, and the first diagonal
# block's first sub-panel and the rest of its factor and inverse
STAGE_KINDS = ("diag", "trsm", "update", "backsub", "diag_first_subpanel", "diag_rest")


def launch_split(call, n=3):
    """{kind: {"ms", "launches"}} a call of the grid route, from the device
    time torch.profiler gives each kernel over n calls."""
    out = {}
    for name, d in torch_turns.bench().kernel_launches(call, n).items():
        for kind in LAUNCH_KINDS:
            if kind in name:
                k = out.setdefault(kind, {"ms": 0.0, "launches": 0.0})
                k["ms"] += d["ms"]
                k["launches"] += d["launches"]
    return out


def stage_split(bk, call, num_views, n=3):
    """{stage: ms} of the grid_solve launch a call(lib) of the timing build
    (mean over n calls), from the stamps its CTA 0 writes at each grid
    barrier; None where the tree's timing build does not stamp it."""
    import torch

    lib = bk.timing_library() if hasattr(bk, "timing_library") else None
    if not hasattr(lib, "osfm_grid_solve_stamps"):
        return None
    npan = -(-6 * num_views // 128)
    stamps = torch.zeros(2 * (3 * npan + 64) + 8, dtype=torch.int64, device="cuda")
    sums = dict.fromkeys(("start", *STAGE_KINDS), 0.0)
    call(lib)
    torch.cuda.synchronize()
    try:
        for _ in range(n):
            stamps.zero_()
            lib.osfm_grid_solve_stamps(stamps.data_ptr())
            call(lib)
            torch.cuda.synchronize()
            lib.osfm_grid_solve_stamps(None)
            s = stamps.cpu().tolist()
            count, prev = s[0], None
            for k in range(count):
                kind, t = s[1 + 2 * k], s[2 + 2 * k]
                if prev is not None:
                    sums[STAGE_KINDS[kind]] += (t - prev) / 1e6 / n
                prev = t
    finally:
        lib.osfm_grid_solve_stamps(None)
    del sums["start"]
    return sums


def time_routes(num_views, n_tracks, split, grid_libs=None):
    """{route: {"ms", "rel_err_f64", ...}} and the library's Cholesky and
    solve_ex times and the plain LU's error at V = num_views."""
    import torch

    from orthosfm_torch.core import cameras as cam_mod
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench.problems import make_problem

    cuda_ms = torch_turns.bench().cuda_ms
    dev = torch.device("cuda")
    cams, points, obs, mask = make_problem("quat", dev, num_views, n_tracks)
    pT, obsT, maskT = ba.prepare(points, obs, mask)
    free = cam_mod.free_mask(cams).float().contiguous()
    p2, r2, c2 = bk.lm_buffers(pT, cams.rot.contiguous(), ba.pack_camp(cams))
    state = bk.new_state(1e-3, dev)
    S, dU, rhs = bk.normal_eq_schur_ref("quat", p2, obsT, maskT, r2, c2, free, state, 1.0, True)
    d64 = ba._solve_camera_system(S.double(), dU.double(), rhs.double(), free,
                                  torch.tensor(1e-3, dtype=torch.float64, device=dev))

    def rel(d):
        return float((d.double() - d64).abs().max() / d64.abs().max())

    n_time = 20 if num_views <= 256 else 5
    out, grid_libs = {}, grid_libs or {}
    for route in bk.CAMERA_SOLVE_ROUTES:
        try:
            bk.camera_solve_route(num_views, route)
        except ValueError:
            continue

        def call(lib=None, route=route):  # lib: the timing build (an older tree has none)
            return bk.camera_solve("quat", S, dU, rhs, free, state, r2, c2, route=route,
                                   **({"lib": lib} if lib else {}))

        delta = call()
        torch.cuda.synchronize()
        out[route] = {"ms": cuda_ms(call, n_time), "rel_err_f64": rel(delta)}
        if split and route == "grid":
            out[route]["launches"] = launch_split(call)
            out[route]["stages"] = stage_split(bk, call, num_views)
        if route == "grid":
            for name, lib in grid_libs.items():
                same = torch.equal(call(lib), delta)
                out[name] = {"ms": cuda_ms(lambda: call(lib), n_time), "same_bits": same}
                if lib.osfm_camera_solve_route(num_views, -1) == bk.CAMERA_SOLVE_ROUTES.index(
                        "grid") and bk.fused_fits(num_views, n_tracks, dev):
                    split = torch_turns.bench().lm_fused_split(
                        "quat", dev, num_views, n_tracks, fused_cfg(), lib=lib)
                    out[name]["lm_fused_solve_stage_ms"] = split["stage_ms"]["solve"]
    S_s, b, _ = ba.prepare_camera_system(S, dU, rhs, free, state[bk.LAM])

    def cholesky():
        L, _ = torch.linalg.cholesky_ex(S_s)
        return torch.cholesky_solve(b[:, None], L)

    plain = bk.camera_solve_ref("quat", S, dU, rhs, free, state, r2, c2)
    return out, {"cholesky_ms": cuda_ms(cholesky, n_time),
                 "solve_ex_ms": cuda_ms(lambda: torch.linalg.solve_ex(S_s, b), n_time),
                 "plain_rel_err_f64": rel(plain), "auto": bk.camera_solve_route(num_views)}


def fused_cfg():
    """The LM config lm_fused is timed at here: 10 iterations that all work."""
    from orthosfm_torch.config import BundleAdjustConfig

    return BundleAdjustConfig(max_iterations=10, function_tolerance=0.0, min_lambda=1e-12)


# the line of the CUDA source that --fused's copies change, and the value
# each copy gives it: the cluster route below 120 views, or the grid route
GRID_MIN_LINE = re.compile(r"constexpr int GRID_MIN_V = \d+;")
FUSED_ROUTE_MIN_V = {"cluster": 1 << 30, "grid": 6}


# --grid-variants' copies of the source: {name: [(text, replacement), ...]}
GRID_CALL = '''__device__ __noinline__ void grid_solve_call(int n, float* scratch) {
  extern __shared__ __align__(16) float call_dyn[];
  cg::grid_group grid = cg::this_grid();
  grid_solve_all(n, scratch, align1024(call_dyn), grid);
}

'''
GRID_VARIANTS = {
    "all_sms": [("  grid = need < grid ? (need > 1 ? need : 1) : grid;\n", "")],
    "noinline": [("__global__ void __launch_bounds__(GS_NT, 1) grid_solve_kernel(",
                  GRID_CALL + "__global__ void __launch_bounds__(GS_NT, 1) grid_solve_kernel("),
                 ("  grid_solve_all(n, scratch, align1024(gsm_raw), grid);\n",
                  "  grid_solve_call(n, scratch);\n")],
    "fused_call": [("__global__ void __launch_bounds__(GS_NT, 1) grid_solve_kernel(",
                    GRID_CALL + "__global__ void __launch_bounds__(GS_NT, 1) grid_solve_kernel("),
                   ("    grid_solve_all(n, a.gscratch, align1024(fsm), grid);\n",
                    "    grid_solve_call(n, a.gscratch);\n")],
    "diag_inline": [("__device__ __noinline__ void grid_diag(",
                     "__device__ __forceinline__ void grid_diag(")],
    "grid_constant": [("lm_fused_kernel(const FusedArgs a)",
                       "lm_fused_kernel(const __grid_constant__ FusedArgs a)")],
}


def variant_builds(texts):
    """{name: the timing build of `texts[name]`, a copy of the source under
    orthosfm_torch/_build/variants/}, built side by side, and {name: its
    ptxas -v log}."""
    from orthosfm_torch import kernel_build
    from orthosfm_torch.solvers import ba_kernels as bk

    folder = kernel_build.BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in texts.items():
        paths[name] = folder / f"ba_{name}.cu"
        paths[name].write_text(text)
    with ThreadPoolExecutor(len(paths)) as pool:
        logs = list(pool.map(lambda path: kernel_build.build(path, bk.TIMING_DEFINES)[1],
                             paths.values()))
    libs = {}
    for name, path in paths.items():
        libs[name] = kernel_build.load(path, {**bk._SIGNATURES, "osfm_lm_fused_stamps": [bk._P]},
                                       bk.TIMING_DEFINES)
        libs[name].osfm_camera_solve_scratch_floats.restype = ctypes.c_longlong
    return libs, dict(zip(paths, logs))


def grid_variant_builds():
    """variant_builds of GRID_VARIANTS, each replacement made once."""
    from orthosfm_torch.solvers import ba_kernels as bk

    src, texts = bk.SOURCE.read_text(), {}
    for name, edits in GRID_VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"the source no longer has one {old.strip()!r}")
            text = text.replace(old, new)
        texts[f"grid_{name}"] = text
    libs, logs = variant_builds(texts)
    from orthosfm_torch import kernel_build

    for name, log in logs.items():
        print(f"{name}: ptxas " + ", ".join(
            f"{fn} {kernel_build.ptxas_usage(log, fn)}"
            for fn in ("grid_solve_kernel", "grid_solve_call", "lm_fused_kernelILb0",
                       "lm_fused_kernelILb1", "grid_diag")))
    return libs


def fused_route_builds():
    """{route: the timing build of a copy of the source whose GRID_MIN_V
    makes lm_fused's camera solve that route}, built side by side."""
    from orthosfm_torch import kernel_build
    from orthosfm_torch.solvers import ba_kernels as bk

    src = bk.SOURCE.read_text()
    if len(GRID_MIN_LINE.findall(src)) != 1:
        raise RuntimeError("the source no longer has one GRID_MIN_V line")
    return variant_builds({route: GRID_MIN_LINE.sub(f"constexpr int GRID_MIN_V = {min_v};", src)
                           for route, min_v in FUSED_ROUTE_MIN_V.items()})[0]


def time_fused_routes(num_views, n_tracks, libs):
    """{route: ms of lm_fused's solve stage and of its whole iteration} at
    num_views x n_tracks, for each build of fused_route_builds that
    serves that size."""
    import torch

    from orthosfm_torch.solvers import ba_kernels as bk

    cfg = fused_cfg()
    out = {}
    for route, lib in libs.items():
        if lib.osfm_lm_fused_grid(num_views, bk._k2_warps(num_views)) < 1:
            continue
        s = torch_turns.bench().lm_fused_split("quat", torch.device("cuda"), num_views, n_tracks,
                                               cfg, lib=lib)
        out[route] = {"solve_ms": s["stage_ms"]["solve"], "iteration_ms": s["iteration_ms"],
                      "iterations": s["iterations"]}
    return out


def loop_kernels(num_views, n_tracks):
    """{K1, K3, K2: device ms an iteration} of the per-iteration kernels in
    an LM loop (ba.run's impl "kernel", fused_cfg()'s 10 iterations that
    all work), from torch.profiler: each kernel where the loop runs it,
    after the one before, not on inputs it has just read."""
    import dataclasses

    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    args = make_problem("quat", torch.device("cuda"), num_views, n_tracks)
    cfg = dataclasses.replace(fused_cfg(), impl="kernel")
    out = dict.fromkeys(("K1", "K3", "K2"), 0.0)
    kinds = {"schur_": "K1", "grid_": "K3", "camera_solve": "K3", "point_update": "K2"}
    for name, d in torch_turns.bench().kernel_launches(
            lambda: ba.run(*args, True, cfg), 2).items():
        for key, kind in kinds.items():
            if key in name:
                out[kind] += d["ms"] / cfg.max_iterations
                break
    return out


def fused_grid_stages(num_views, n_tracks):
    """stage_split of the grid route inside lm_fused: one iteration of
    lm_solve from the timing build at num_views x n_tracks."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba_kernels as bk

    inputs = torch_turns.bench().stage_inputs("quat", torch.device("cuda"), num_views, n_tracks)
    pT, obsT, maskT, rot, camp, free = inputs
    cfg = bk.LMConfig.of(BundleAdjustConfig())

    def call(lib):
        p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
        return bk.lm_solve("quat", p2, obsT, maskT, r2, c2, free, 1.0, True, cfg, 1, lib=lib)

    return stage_split(bk, call, num_views)


def time_ba_run(num_views, n_tracks, iterations=10):
    """ms an iteration of ba.run's default route at num_views x n_tracks to a
    synchronize (the best of three calls after one warm-up), and its K3
    launches by route a call."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench.problems import make_problem

    wall_ms = torch_turns.bench().wall_ms
    cams, points, obs, mask = make_problem("quat", torch.device("cuda"), num_views, n_tracks)
    cfg = BundleAdjustConfig(max_iterations=iterations, function_tolerance=0.0, min_lambda=1e-12)
    run = lambda: ba.run(cams, points, obs, mask, True, cfg)  # noqa: E731
    run()
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    run()
    routes = bk.route_launches()
    best = min(wall_ms(run, 1) for _ in range(3))
    return {"ms_per_iteration": best / iterations, "iterations": iterations,
            "camera_solve_routes": routes}


def one_tree(args) -> dict:
    """Every measurement of this process's tree (sys.path set by main)."""
    rows = {}
    libs = fused_route_builds() if args.fused else {}
    grid_libs = grid_variant_builds() if args.grid_variants else {}
    for V in args.views:
        routes, other = time_routes(V, args.tracks, args.split, grid_libs)
        rows[V] = {"routes": routes, **other}
        if libs and V < 120:
            rows[V]["lm_fused"] = time_fused_routes(V, args.tracks, libs)
            print(f"         lm_fused at V={V}: " + ", ".join(
                f"{r}: solve stage {t['solve_ms']:.4f} ms, iteration {t['iteration_ms']:.4f} ms"
                for r, t in rows[V]["lm_fused"].items()), flush=True)
        if args.fused and other["auto"] == "grid":
            stages = rows[V]["lm_fused_grid_stages"] = fused_grid_stages(V, args.tracks)
            print("         grid_solve by stage inside lm_fused: " + ", ".join(
                f"{k} {ms:.4f} ms" for k, ms in stages.items()), flush=True)
            loop = rows[V]["lm_loop_kernels"] = loop_kernels(V, args.tracks)
            print("         the per-iteration kernels in an LM loop, ms an iteration: " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in loop.items()), flush=True)
        times = "   ".join(f"{r} {t['ms']:.4f} ms (" + (
            f"rel err {t['rel_err_f64']:.2e})" if "rel_err_f64" in t
            else f"the main build's bits: {t['same_bits']}" + (
                f", lm_fused's solve stage {t['lm_fused_solve_stage_ms']:.4f} ms)"
                if "lm_fused_solve_stage_ms" in t else ")")) for r, t in routes.items())
        print(f"V={V:5d} n={6 * V:6d}  {times}   cholesky {other['cholesky_ms']:.4f} ms   "
              f"solve_ex {other['solve_ex_ms']:.4f} ms   plain LU rel err "
              f"{other['plain_rel_err_f64']:.2e}   auto: {other['auto']}", flush=True)
        grid = routes.get("grid", {})
        if grid.get("launches"):
            print("         grid by launch kind: " + ", ".join(
                f"{k} {d['ms']:.4f} ms ({d['launches']:g} launches)"
                for k, d in grid["launches"].items()), flush=True)
        if grid.get("stages"):
            print("         grid_solve by stage: " + ", ".join(
                f"{k} {ms:.4f} ms" for k, ms in grid["stages"].items()), flush=True)
    runs = {}
    for shape in args.ba_run:
        V, T = map(int, shape.split("x"))
        runs[shape] = time_ba_run(V, T)
        print(f"ba.run {shape}: {runs[shape]['ms_per_iteration']:.3f} ms an iteration "
              f"(K3 by route {runs[shape]['camera_solve_routes']})", flush=True)
    return {"tracks": args.tracks, "views": rows, "ba_run": runs}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--views", type=int, nargs="+", default=[64, 128, 256, 512, 700, 1100, 2000])
    p.add_argument("--tracks", type=int, default=300)
    p.add_argument("--split", action="store_true", help="the grid route by launch and stage")
    p.add_argument("--fused", action="store_true",
                   help="below 120 views, each route as lm_fused's solve stage")
    p.add_argument("--grid-variants", action="store_true",
                   help="the grid route on every SM and through a call, beside its own")
    p.add_argument("--ba-run", nargs="*", default=[], help="VxT shapes to time ba.run at")
    p.add_argument("--tree", action="append", default=[], help="a checkout to time, in turns")
    p.add_argument("--one", default="", help=argparse.SUPPRESS)
    p.add_argument("--json", default="")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_k3_routes: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        sys.path.insert(0, os.path.abspath(args.one))
        print(json.dumps({"tree": args.one, **one_tree(args)}))
        return 0
    card = torch_turns.card()
    print(card, flush=True)
    if not args.tree:
        sys.path.insert(0, REPO)
        result = {"card": card, **one_tree(args)}
    else:
        argv = ["--views", *map(str, args.views), "--tracks", str(args.tracks),
                *(["--split"] if args.split else []), *(["--fused"] if args.fused else []),
                *(["--grid-variants"] if args.grid_variants else []),
                "--ba-run", *args.ba_run]
        result = {"card": card, "turns": torch_turns.run_turns(__file__, args.tree, argv, 3000)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
