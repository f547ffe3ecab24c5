#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (orthosfm_torch) on one GPU.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit, and the build of the CUDA kernels from
     orthosfm_torch/csrc/;
  2. each kernel (schur_assemble, camera_solve, point_update_cost, lm_accept)
     against its plain PyTorch version on the card, at the shapes of the
     standard BA problem (16 views x 8192 sphere tracks, 2048^2, cameras
     perturbed by up to 1 degree), for quaternion and Euler cameras, with
     points optimized and fixed;
  3. the slice: pose estimation from tracks (run_pose_estimation with the
     kernels) on the 16-view 2048^2 blob scene (7800 tracks), solvers 0
     and 3, noise-free (mean angular error < 0.01 deg) and with sigma = 1 px
     pixel noise (< 0.25 deg), with the launch counts of every kernel over
     this phase, and the port's writers producing cameras.txt,
     sparse_cloud.ply, tracks.txt and time_measurements.txt;
  4. BA iterations/s of the kernel path and of the plain PyTorch path on the
     standard problem and on a 64-view problem (64 x 4096 tracks), 30
     iterations each.

Any failed check raises. On success the line before the last is a JSON
object of per-kernel results, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script exits non-zero before doing anything.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_VIEWS = 16
N_TRACKS = 8192
WIDTH = 2048.0
SOURCE = "orthosfm_torch/csrc/ba_kernels.cu"
REPLACES = {
    "schur_assemble": "orthosfm_tpu/solvers/ba_pallas.py:394",
    "camera_solve": "orthosfm_tpu/solvers/ba_fused.py:545",
    "point_update_cost": "orthosfm_tpu/solvers/ba_pallas.py:447",
    "lm_accept": "orthosfm_tpu/solvers/ba_fused.py:545",
}
# Kernel vs plain version on the same inputs. Sums over 8192 tracks run in
# another order on the card (per-CTA partials) than in the CPU-style plain
# path, and Gauss-Jordan without pivoting replaces an LU solve: f32 rounding
# of ~1e-6 relative per sum. The solve's bound sits well below the change
# that mishandled damping would make (about lambda relative: 1e-3 and 1 are
# both checked).
TOL_SCHUR_REL = 1e-4      # max |S' - S'_ref| / max |S'_ref| (and rhs, dU)
TOL_SOLVE_REL = 1e-5      # max |delta - delta_ref| / max |delta_ref|
SOLVE_LAMBDAS = (1e-3, 1.0)
BA_SHAPES = ((N_VIEWS, N_TRACKS), (64, 4096))
TOL_POINTS_ABS = 1e-5     # retracted unit points, abs
TOL_COST_REL = 1e-4       # robust cost, relative
TOL_STATE_REL = 1e-5      # LM scalar state after accept, relative


def cuda_ms(fn, n=20):
    """Mean device time of fn() over n launches, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def rel_err(a, b):
    return max_err(a, b) / max(float(b.double().abs().max()), 1e-30)


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def check_kernels(device):
    """Phase 2: every kernel against its plain version on the card."""
    import torch

    from orthosfm_torch.core import cameras as cam_mod
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench.problems import make_problem

    errs = {name: 0.0 for name in REPLACES}   # max abs error over all cases
    rels = {name: 0.0 for name in REPLACES}   # max relative error over all cases
    times = {}
    cfg = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)
    for kind in ("quat", "euler"):
        cams, points, obs, mask = make_problem(kind, device, N_VIEWS, N_TRACKS, WIDTH)
        pT, obsT, maskT = ba.prepare(points, obs, mask)
        free = cam_mod.free_mask(cams).float().contiguous()
        rot = cams.rot.contiguous()
        camp = ba.pack_camp(cams)
        state = bk.new_state(1e-3, device)
        for opt in (True, False):
            args = (kind, pT, obsT, maskT, rot, camp, free, state, 1.0, opt)
            S, dU, rhs = bk.schur_assemble(*args)
            S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
            e = max(rel_err(S, S_r), rel_err(rhs, rhs_r), rel_err(dU, dU_r))
            print(f"  schur_assemble   {kind:5s} opt={opt!s:5s} rel err {e:.3e}")
            require(e < TOL_SCHUR_REL, f"schur_assemble {kind} opt={opt}: {e}")
            rels["schur_assemble"] = max(rels["schur_assemble"], e)
            errs["schur_assemble"] = max(errs["schur_assemble"], max_err(S, S_r),
                                         max_err(rhs, rhs_r), max_err(dU, dU_r))

            for lam in SOLVE_LAMBDAS:
                sargs = (kind, S_r, dU_r, rhs_r, free, bk.new_state(lam, device), rot, camp)
                delta, rot_c, camp_c = bk.camera_solve(*sargs)
                delta_r, rot_cr, camp_cr = bk.camera_solve_ref(*sargs)
                e = rel_err(delta, delta_r)
                print(f"  camera_solve     {kind:5s} opt={opt!s:5s} lambda={lam:g} "
                      f"rel err {e:.3e}")
                require(e < TOL_SOLVE_REL, f"camera_solve {kind} opt={opt} lambda={lam}: {e}")
                rels["camera_solve"] = max(rels["camera_solve"], e)
                errs["camera_solve"] = max(errs["camera_solve"], max_err(delta, delta_r),
                                           max_err(rot_c, rot_cr), max_err(camp_c, camp_cr))
            # the stages after the solve continue from the lambda of `state`
            sargs = (kind, S_r, dU_r, rhs_r, free, state, rot, camp)
            delta_r, rot_cr, camp_cr = bk.camera_solve_ref(*sargs)

            uargs = (kind, pT, obsT, maskT, rot, camp, free, state, delta_r, rot_cr, camp_cr,
                     1.0, opt)
            p_new, parts = bk.point_update_cost(*uargs)
            p_new_r, parts_r = bk.point_update_cost_ref(*uargs)
            e_p = max_err(p_new, p_new_r)
            e_c = rel_err(parts.sum(), parts_r.sum())
            print(f"  point_update_cost {kind:5s} opt={opt!s:5s} points {e_p:.3e} "
                  f"cost rel {e_c:.3e}")
            require(e_p < TOL_POINTS_ABS and e_c < TOL_COST_REL,
                    f"point_update_cost {kind} opt={opt}: {e_p} {e_c}")
            rels["point_update_cost"] = max(rels["point_update_cost"], e_p, e_c)
            errs["point_update_cost"] = max(errs["point_update_cost"], e_p,
                                            max_err(parts.sum(), parts_r.sum()))

            # Accept: the previous cost is the initial one, so a good step is taken
            _, init_parts = bk.point_update_cost_ref(kind, pT, obsT, maskT, rot, camp, free,
                                                     None, None, rot, camp, 1.0, False)
            s_in = bk.new_state(1e-3, device)
            s_in[bk.COST] = init_parts.sum()
            outs = []
            for accept in (bk.lm_accept, bk.lm_accept_ref):
                st = torch.zeros_like(s_in)
                r_, c_, p_ = rot.clone(), camp.clone(), pT.clone()
                accept(parts_r, s_in, st, r_, c_, p_, rot_cr, camp_cr,
                       p_new_r if opt else None, cfg)
                outs.append((st, r_, c_, p_))
            e_s = rel_err(outs[0][0], outs[1][0])
            e_x = max(max_err(a, b) for a, b in zip(outs[0][1:], outs[1][1:]))
            print(f"  lm_accept        {kind:5s} opt={opt!s:5s} state rel {e_s:.3e} "
                  f"selection {e_x:.3e}")
            require(e_s < TOL_STATE_REL and e_x == 0.0, f"lm_accept {kind} opt={opt}")
            require(float(outs[0][0][bk.ITERS]) == 1.0, "lm_accept did not step")
            rels["lm_accept"] = max(rels["lm_accept"], e_s, e_x)
            errs["lm_accept"] = max(errs["lm_accept"], max_err(outs[0][0], outs[1][0]), e_x)

            if kind == "quat" and opt:
                st = torch.zeros_like(s_in)
                r_, c_, p_ = rot.clone(), camp.clone(), pT.clone()
                pairs = {
                    "schur_assemble": (lambda: bk.schur_assemble(*args),
                                       lambda: bk.normal_eq_schur_ref(*args)),
                    "camera_solve": (lambda: bk.camera_solve(*sargs),
                                     lambda: bk.camera_solve_ref(*sargs)),
                    "point_update_cost": (lambda: bk.point_update_cost(*uargs),
                                          lambda: bk.point_update_cost_ref(*uargs)),
                    "lm_accept": (
                        lambda: bk.lm_accept(parts_r, s_in, st, r_, c_, p_, rot_cr, camp_cr,
                                             p_new_r, cfg),
                        lambda: bk.lm_accept_ref(parts_r, s_in, st, r_, c_, p_, rot_cr,
                                                 camp_cr, p_new_r, cfg)),
                }
                for name, (kern, plain) in pairs.items():
                    times[name] = (cuda_ms(kern), cuda_ms(plain))

    # A many-view system (n = 384): the camera solve spreads its augmented
    # matrix over a cluster of 8 CTAs.
    cams, points, obs, mask = make_problem("quat", device, 64, 4096, WIDTH)
    pT, obsT, maskT = ba.prepare(points, obs, mask)
    free = cam_mod.free_mask(cams).float().contiguous()
    args = ("quat", pT, obsT, maskT, cams.rot.contiguous(), ba.pack_camp(cams), free,
            bk.new_state(1e-3, device), 1.0, True)
    S, dU, rhs = bk.schur_assemble(*args)
    S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
    e1 = max(rel_err(S, S_r), rel_err(rhs, rhs_r), rel_err(dU, dU_r))
    e3 = 0.0
    for lam in SOLVE_LAMBDAS:
        sargs = ("quat", S_r, dU_r, rhs_r, free, bk.new_state(lam, device), args[4], args[5])
        e3 = max(e3, rel_err(bk.camera_solve(*sargs)[0], bk.camera_solve_ref(*sargs)[0]))
    rels["schur_assemble"] = max(rels["schur_assemble"], e1)
    rels["camera_solve"] = max(rels["camera_solve"], e3)
    sargs = ("quat", S_r, dU_r, rhs_r, free, args[7], args[4], args[5])
    print(f"  64 views x 4096 tracks: schur_assemble rel err {e1:.3e}, "
          f"camera_solve rel err {e3:.3e}")
    require(e1 < TOL_SCHUR_REL and e3 < TOL_SOLVE_REL, "64-view system")
    times["camera_solve_64"] = (cuda_ms(lambda: bk.camera_solve(*sargs), 5),
                                cuda_ms(lambda: bk.camera_solve_ref(*sargs), 5))
    times["schur_assemble_64"] = (cuda_ms(lambda: bk.schur_assemble(*args), 5),
                                  cuda_ms(lambda: bk.normal_eq_schur_ref(*args), 5))

    for name, (k_ms, p_ms) in times.items():
        shape = "64 views x 4096" if name.endswith("_64") else f"{N_VIEWS} views x {N_TRACKS}"
        print(f"  {name:18s} kernel {k_ms:.4f} ms   plain {p_ms:.4f} ms  ({shape} tracks, quat)")
    return errs, rels, times


def run_slice(device, project):
    """Phase 3: the main path, pose estimation from tracks with the kernels."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig, ReconstructionConfig, SolverType
    from orthosfm_torch.data import synthetic
    from orthosfm_torch.io import ply, timing, tracks_io
    from orthosfm_torch.pipeline import incremental, reconstruct
    from orthosfm_torch.testbench import metrics

    ds = synthetic.generate_dataset(synthetic.blob_cloud(7800), num_views=N_VIEWS, seed=0,
                                    width=int(WIDTH), height=int(WIDTH), device=device)
    wh = np.full(N_VIEWS, WIDTH, np.float32)
    names = [f"view_{i:03d}.png" for i in range(N_VIEWS)]
    for solver in (0, 3):
        for sigma, limit in ((0.0, 0.01), (1.0, 0.25)):
            tracks = ds.tracks
            if sigma:
                tracks = synthetic.add_observation_noise(tracks, sigma,
                                                         np.random.default_rng(solver))
            cfg = ReconstructionConfig(solver=SolverType(solver),
                                       ba=BundleAdjustConfig(impl="kernel"))
            t0 = time.perf_counter()
            res = incremental.run_pose_estimation(tracks, wh, wh, cfg, verbose=False)
            torch.cuda.synchronize()
            t_pose = time.perf_counter() - t0
            ang, _ = metrics.pose_errors(res.cameras, ds.gt_cameras)
            require(bool(res.present.all()), f"solver {solver} sigma {sigma}: camera missing")
            require(res.cameras.rot.device == device, "pose estimation left the card")
            mean_ang = float(np.mean(ang))
            t0 = time.perf_counter()
            out = os.path.join(project, f"solver{solver}_sigma{sigma:g}")
            os.makedirs(out)
            reconstruct.export_cameras(res, names, os.path.join(out, "cameras.txt"))
            ply.save_point_cloud(res.tracks, os.path.join(out, "sparse_cloud.ply"))
            tracks_io.save_tracks(tracks, os.path.join(out, "tracks.txt"))
            t_write = time.perf_counter() - t0
            timing.save_runtimes(os.path.join(out, "time_measurements.txt"), 0.0, 0.0,
                                 t_pose, t_pose + t_write)
            n_cams = sum(1 for _ in open(os.path.join(out, "cameras.txt")))
            require(n_cams == N_VIEWS, f"cameras.txt holds {n_cams} cameras")
            print(f"  solver {solver} sigma {sigma:g} px: mean angular error {mean_ang:.6f} deg "
                  f"(limit {limit}), max {float(np.max(ang)):.6f} deg; pose estimation "
                  f"{t_pose:.3f} s, writing outputs {t_write:.3f} s")
            require(mean_ang < limit, f"solver {solver} sigma {sigma}: {mean_ang} >= {limit}")


def ba_rate(device, num_views, n_tracks):
    """Phase 4: BA iterations/s of both paths, in turns."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    cams, points, obs, mask = make_problem("quat", device, num_views, n_tracks, WIDTH)
    rates = {"kernel": [], "torch": []}
    for impl in ("kernel", "torch", "torch", "kernel"):
        cfg = BundleAdjustConfig(max_iterations=30, function_tolerance=0.0, min_lambda=1e-12,
                                 impl=impl)
        ba.run(cams, points, obs, mask, True, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ba.run(cams, points, obs, mask, True, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        iters = int(r.iterations)
        require(iters == 30, f"{impl}: {iters} iterations")
        require(float(r.cost) < float(r.initial_cost) * 1e-2, f"{impl} BA did not converge")
        rates[impl].append(iters / dt)
        print(f"  impl={impl:6s} {iters} iterations in {dt * 1e3:.2f} ms: {iters / dt:.1f} it/s "
              f"(cost {float(r.initial_cost):.1f} -> {float(r.cost):.3e})")
    return {k: float(np.mean(v)) for k, v in rates.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    t_all = time.perf_counter()

    from orthosfm_torch.solvers import ba_kernels as bk

    print("== phase 1: card and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    path, log = bk.build()
    bk.library()
    print(f"  built {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    print("== phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    errs, rels, times = check_kernels(device)
    print(f"  phase 2 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 3: pose estimation from tracks (16 views x 7800 tracks, 2048^2)")
    t0 = time.perf_counter()
    bk.reset_launch_counts()
    with tempfile.TemporaryDirectory() as project:
        run_slice(device, project)
    launches = bk.launch_counts()
    print(f"  launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")
    print(f"  phase 3 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 4: BA iterations/s (quat, 30 iterations)")
    t0 = time.perf_counter()
    rates = {}
    for num_views, n_tracks in BA_SHAPES:
        print(f"  {num_views} views x {n_tracks} tracks")
        r = ba_rate(device, num_views, n_tracks)
        rates[f"{num_views}x{n_tracks}"] = r
        print(f"  kernel path {r['kernel']:.1f} it/s, plain torch path {r['torch']:.1f} it/s")
    print(f"  phase 4 wall time {time.perf_counter() - t0:.2f} s")
    print(f"total wall time {time.perf_counter() - t_all:.2f} s")

    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": launches[name], "max_abs_err": errs[name], "max_rel_err": rels[name],
                "ms": times[name][0], "plain_ms": times[name][1]} for name in REPLACES]
    print(json.dumps({"kernels": kernels, "ba_iter_per_s": rates}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
