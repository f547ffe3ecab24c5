#!/usr/bin/env python3
"""Times K3 (camera_solve, csrc/ba_kernels.cu) by each of its routes that
can serve a size, beside torch.linalg.solve_ex on the same prepared system,
on one GPU, and holds each route to an f64 solve.

    python3 scripts/torch_k3_routes.py [--views 64 128 256 512 700 1100 2000]
                                       [--tracks 300] [--json OUT]

For each view count V the system is the standard BA problem's
(testbench.problems.make_problem: quaternion cameras, V views of a sphere
of `--tracks` points, every track seen by every view) reduced camera system
S' from the plain version of K1 at lambda 1e-3, so every route solves the
same n = 6V system. Each route (one CTA up to 37 views, the cluster of 8
CTAs up to 1365, the grid route at any size) is timed by CUDA events, its
error against the f64 solve printed beside the plain f32 LU's. The
automatic choice (camera_solve_route) switches to the grid route at the
crossover these times give (GRID_MIN_V in the CUDA source). Prints a table
and one JSON object; needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def time_routes(num_views, n_tracks):
    """{route: {"ms", "rel_err_f64"}} and solve_ex's time and the plain
    LU's error at V = num_views."""
    import torch

    from orthosfm_torch.core import cameras as cam_mod
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench.problems import make_problem
    from orthosfm_torch.utils.kernel_bench import cuda_ms

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

        def call(route=route):
            return bk.camera_solve("quat", S, dU, rhs, free, state, r2, c2, route=route)

        delta = call()
        torch.cuda.synchronize()
        out[route] = {"ms": cuda_ms(call, n_time), "rel_err_f64": rel(delta)}
    S_s, b, _ = ba.prepare_camera_system(S, dU, rhs, free, state[bk.LAM])
    plain = bk.camera_solve_ref("quat", S, dU, rhs, free, state, r2, c2)
    return out, {"solve_ex_ms": cuda_ms(lambda: torch.linalg.solve_ex(S_s, b), n_time),
                 "plain_rel_err_f64": rel(plain), "auto": bk.camera_solve_route(num_views)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--views", type=int, nargs="+", default=[64, 128, 256, 512, 700, 1100, 2000])
    p.add_argument("--tracks", type=int, default=300)
    p.add_argument("--json", default="")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_k3_routes: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card)
    rows = {}
    for V in args.views:
        routes, other = time_routes(V, args.tracks)
        rows[V] = {"routes": routes, **other}
        times = "   ".join(f"{r} {t['ms']:.4f} ms (rel err {t['rel_err_f64']:.2e})"
                           for r, t in routes.items())
        print(f"V={V:5d} n={6 * V:6d}  {times}   solve_ex {other['solve_ex_ms']:.4f} ms   "
              f"plain LU rel err {other['plain_rel_err_f64']:.2e}   auto: {other['auto']}",
              flush=True)
    result = {"card": card, "tracks": args.tracks, "views": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
