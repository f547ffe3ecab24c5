#!/usr/bin/env python3
"""Times K3 (camera_solve, csrc/ba_kernels.cu) by each of its routes that
can serve a size, beside the library's Cholesky (torch.linalg.cholesky_ex
then torch.cholesky_solve) and torch.linalg.solve_ex on the same prepared
system, on one GPU, and holds each route to an f64 solve.

    python3 scripts/torch_k3_routes.py [--views 64 128 256 512 700 1100 2000]
                                       [--tracks 300] [--split]
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

--ba-run VxT times ba.run on the card (its default route: from 120 views
K1, K3 and K2 an iteration) at V views x T tracks, 10 iterations, in ms an
iteration to a synchronize.

--tree DIR (repeatable) runs everything once for each checkout DIR, in
turns (scripts/torch_turns.py: each in a process of its own that imports
DIR's orthosfm_torch and builds its kernels from DIR's csrc/), in the
order given. Prints a table and one JSON object; needs CUDA.
"""

import argparse
import json
import os
import sys

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


def time_routes(num_views, n_tracks, split):
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
    out = {}
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
    S_s, b, _ = ba.prepare_camera_system(S, dU, rhs, free, state[bk.LAM])

    def cholesky():
        L, _ = torch.linalg.cholesky_ex(S_s)
        return torch.cholesky_solve(b[:, None], L)

    plain = bk.camera_solve_ref("quat", S, dU, rhs, free, state, r2, c2)
    return out, {"cholesky_ms": cuda_ms(cholesky, n_time),
                 "solve_ex_ms": cuda_ms(lambda: torch.linalg.solve_ex(S_s, b), n_time),
                 "plain_rel_err_f64": rel(plain), "auto": bk.camera_solve_route(num_views)}


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
    for V in args.views:
        routes, other = time_routes(V, args.tracks, args.split)
        rows[V] = {"routes": routes, **other}
        times = "   ".join(f"{r} {t['ms']:.4f} ms (rel err {t['rel_err_f64']:.2e})"
                           for r, t in routes.items())
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
                *(["--split"] if args.split else []), "--ba-run", *args.ba_run]
        result = {"card": card, "turns": torch_turns.run_turns(__file__, args.tree, argv, 3000)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
