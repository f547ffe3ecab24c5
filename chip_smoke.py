#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (orthosfm_torch) on one GPU.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit, and the build of the native sources
     of orthosfm_torch/csrc/ (the BA kernels, the top-2 matching kernel and
     the union-find), one compiler each, all started together;
  2. each kernel against its plain PyTorch version on the card: the BA
     kernels (schur_assemble, camera_solve, point_update_cost, lm_accept) at
     the shapes of the standard BA problem (16 views x 8192 sphere tracks,
     2048^2, cameras perturbed by up to 1 degree), for quaternion and Euler
     cameras, with points optimized and fixed; top2 on random unit
     descriptors, 8 pairs x 8192 rows x 128 and x 64, with duplicated rows
     (exact ties), repeated views and databases of 0 and 1 valid rows;
  3. pose estimation from tracks (run_pose_estimation with the kernels) on
     the 16-view 2048^2 blob scene (7800 tracks), solvers 0 and 3,
     noise-free (mean angular error < 0.01 deg) and with sigma = 1 px pixel
     noise (< 0.25 deg), with the launch counts of the BA kernels over this
     phase, and the port's writers producing cameras.txt, sparse_cloud.ply,
     tracks.txt and time_measurements.txt;
  4. BA iterations/s of the kernel path and of the plain PyTorch path on the
     standard problem and on a 64-view problem (64 x 4096 tracks), 30
     iterations each;
  5. the image front end at reference scale: 16 sphere views of 2048^2
     rendered on the card (seed 7, a 200 degree ring), then SIFT + SURF,
     pair matching through top2, RANSAC-F, union-find tracks and pose
     estimation (quaternion solver, kernels on), with the time of each
     stage, the counts of features, pairs and tracks, and the launch count
     of top2 over this phase; every view must be placed with a mean angular
     error < 1 deg. Then top2 against its plain version on the real SIFT and
     SURF stacks of this run, with the cross-checked match counts per pair.

Any failed check raises. On success the line before the last is a JSON
object of per-kernel results, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script exits non-zero before doing anything.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_VIEWS = 16
N_TRACKS = 8192
WIDTH = 2048.0
BA_SOURCE = "orthosfm_torch/csrc/ba_kernels.cu"
MATCH_SOURCE = "orthosfm_torch/csrc/match_kernels.cu"
REPLACES = {
    "schur_assemble": "orthosfm_tpu/solvers/ba_pallas.py:394",
    "camera_solve": "orthosfm_tpu/solvers/ba_fused.py:545",
    "point_update_cost": "orthosfm_tpu/solvers/ba_pallas.py:447",
    "lm_accept": "orthosfm_tpu/solvers/ba_fused.py:545",
    "top2": "orthosfm_tpu/ops/matching_pallas.py:87",
}
SOURCE_OF = {name: BA_SOURCE for name in REPLACES}
SOURCE_OF["top2"] = MATCH_SOURCE
BA_KERNELS = ("schur_assemble", "camera_solve", "point_update_cost", "lm_accept")
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
# top2: the kernel sums each dot product in one FMA chain, the plain
# version by cuBLAS's f32 GEMM in another order; d2 = 2 - 2 sim of unit
# vectors differs by a few 1e-7. Indices must agree except on rows whose
# best and second d2 (plain version) lie within this of each other.
TOL_TOP2 = 1e-5
# Phase 5: the JAX package's reference-scale run
# (testbench/bench_pipeline.py --views 16 --width 2048)
FRONT_VIEWS = 16
FRONT_WIDTH = 2048
FRONT_SEED = 7
FRONT_RING_DEG = 200.0
FRONT_LIMIT_DEG = 1.0


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

    errs = {name: 0.0 for name in BA_KERNELS}   # max abs error over all cases
    rels = {name: 0.0 for name in BA_KERNELS}   # max relative error over all cases
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


def top2_agreement(stack, bi, bj, ci, cj):
    """top2 kernel against its plain version on one batch of pairs:
    (max abs error of best and second d2, that error relative to the largest
    plain d2, rows whose index differs outside a near tie, near-tie query
    rows per pair)."""
    import torch

    from orthosfm_torch.ops import matching_kernels as mk

    kb, ks, ki = mk.top2(stack, bi, bj, ci, cj, impl="kernel")
    rb, rs, ri = mk.top2_ref(stack, bi, bj, ci, cj)
    torch.cuda.synchronize()
    err = max(max_err(kb, rb), max_err(ks, rs))
    rel = max(rel_err(kb, rb), rel_err(ks, rs))
    rows = torch.arange(stack.shape[1], device=stack.device)[None, :] < ci[:, None]
    near = ((rs - rb) <= TOL_TOP2) & rows
    bad = int(((ki != ri) & ~near).sum())
    return err, rel, bad, near.sum(dim=1)


def check_top2_random(device):
    """Phase 2, top2: random unit descriptors with exact ties, repeated views
    and databases of 0 and 1 valid rows, D = 128 and 64; kernel and plain
    times at 8 pairs x 8192 x 128."""
    import torch

    from orthosfm_torch.ops import matching_kernels as mk

    n = 8192
    gen = torch.Generator(device=device).manual_seed(0)
    err_all, rel_all, times = 0.0, 0.0, {}
    # pairs (view i, view j, valid rows of i, valid rows of j)
    pairs = [(0, 1, n, n), (2, 3, n, n), (4, 5, n - 37, n - 100), (6, 7, n, 0),
             (8, 9, n, 1), (1, 1, n, n), (10, 2, 1000, n), (3, 0, n, 4097)]
    for D in (128, 64):
        stack = torch.randn((11, n, D), generator=gen, device=device)
        stack /= torch.linalg.vector_norm(stack, dim=-1, keepdim=True)
        stack[3, 4096:] = stack[3, :4096]   # every database row of view 3 twice
        stack[2, :2048] = stack[3, :2048]   # queries equal to duplicated rows: d2 = 0 twice
        stack[1, 5000:5100] = stack[1, 100:200]
        cols = [torch.tensor(c, dtype=torch.int32, device=device) for c in zip(*pairs)]
        err, rel, bad, near = top2_agreement(stack, *cols)
        print(f"  top2 random D={D}: 8 pairs x {n}: max |d2 err| {err:.3e}, index "
              f"mismatches outside near ties {bad}, near-tie rows {int(near.sum())}")
        require(err < TOL_TOP2 and bad == 0, f"top2 random D={D}")
        err_all, rel_all = max(err_all, err), max(rel_all, rel)
        times[f"top2_random_{D}"] = (cuda_ms(lambda: mk.top2(stack, *cols, impl="kernel"), 5),
                                     cuda_ms(lambda: mk.top2_ref(stack, *cols), 5))
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name:18s} kernel {k_ms:.4f} ms   plain {p_ms:.4f} ms  (8 pairs x {n} rows)")
    return err_all, rel_all, times


class StageTimer:
    """Wall time of named stages, each bracketed by torch.cuda.synchronize()."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def run_front_end(device):
    """Phase 5: the image front end and pose estimation at reference scale,
    through the functions reconstruct() calls, in its order."""
    import torch

    from orthosfm_torch.config import ReconstructionConfig, SolverType
    from orthosfm_torch.data.views import View
    from orthosfm_torch.ops import ransac_f
    from orthosfm_torch.pipeline import incremental, track_utils
    from orthosfm_torch.pipeline import matching as matching_mod
    from orthosfm_torch.testbench import metrics, render

    t0 = time.perf_counter()
    gt, images, _ = render.make_scene_views(FRONT_VIEWS, FRONT_WIDTH, FRONT_WIDTH,
                                            seed=FRONT_SEED, ring_degrees=FRONT_RING_DEG,
                                            device=device)
    torch.cuda.synchronize()
    print(f"  rendered {FRONT_VIEWS} views of {FRONT_WIDTH}^2 on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    # the views hold host arrays, as images loaded from files do
    views = [View(i, f"view_{i:02d}.png", FRONT_WIDTH, FRONT_WIDTH, pixels=img.cpu().numpy())
             for i, img in enumerate(images)]
    cfg = ReconstructionConfig(solver=SolverType.ORTHO_QUATERNION)
    timer = StageTimer()
    t_all = time.perf_counter()
    features = matching_mod.extract_all_view_features(views, cfg, device, timer=timer)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        pair_matches = matching_mod.match_all_pairs(features, cfg, verbose=True, timer=timer)
    tracks = matching_mod.tracks_from_matches(views, features, pair_matches, device=device,
                                              timer=timer)
    with timer("masks_colors"):
        tracks = track_utils.propagate_colors(track_utils.filter_tracks_with_masks(tracks, views),
                                              views)
    wh = np.full(FRONT_VIEWS, float(FRONT_WIDTH), np.float32)
    with timer("pose_estimation"):
        res = incremental.run_pose_estimation(tracks, wh, wh, cfg, verbose=False)
    t_all = time.perf_counter() - t_all

    # match_all_pairs reports every pair once: rejected by the low-res gate,
    # by the match count or by the inlier count, or matched
    outcome = {"low-res": r"rejected, low-res matches below", "count": r"matches below threshold",
               "inliers": r"inliers below threshold", "accepted": r"\) matched, \d+ inliers"}
    lines = log.getvalue().splitlines()
    n = {k: sum(bool(re.search(p, ln)) for ln in lines) for k, p in outcome.items()}
    n_pairs = FRONT_VIEWS * (FRONT_VIEWS - 1) // 2
    n_sift = [f.n_sift for f in features]
    n_surf = [f.count - f.n_sift for f in features]
    n_tracks = int(tracks.alive.sum())
    print(f"  stage ms: " + ", ".join(f"{k} {v:.1f}" for k, v in timer.ms.items()))
    print(f"  front end + pose estimation {t_all:.3f} s")
    print(f"  features per view: SIFT {n_sift}, SURF {n_surf}")
    print(f"  pairs {n_pairs}: rejected by the low-res gate {n['low-res']}, by the match count "
          f"{n['count']}; candidates for RANSAC-F {n['inliers'] + n['accepted']}; accepted "
          f"{len(pair_matches)}; tracks {n_tracks}")
    require(sum(n.values()) == n_pairs and n["accepted"] == len(pair_matches),
            f"front end: pair outcomes {n} do not add up to {n_pairs} pairs")
    # the rank-2 enforcement alone: one batched 3x3 SVD over every hypothesis
    n_hyp = (n["inliers"] + n["accepted"]) * cfg.matching.ransac_f_iterations
    F = torch.randn((n_hyp, 3, 3), generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    print(f"  rank-2 enforcement (batched 3x3 SVD) of {n_hyp} hypotheses: "
          f"{cuda_ms(lambda: ransac_f.enforce_rank2(F), 3):.2f} ms, in a RANSAC-F stage of "
          f"{timer.ms['ransac_f']:.1f} ms")
    ang, pos = metrics.pose_errors(res.cameras, gt)
    mean_ang = float(np.mean(ang))
    print(f"  views placed {int(res.present.sum())}/{FRONT_VIEWS}; mean angular error "
          f"{mean_ang:.4f} deg (limit {FRONT_LIMIT_DEG}), max {float(np.max(ang)):.4f} deg, "
          f"mean position error {float(np.mean(pos)):.5f}")
    require(bool(res.present.all()), "front end: a view was not placed")
    require(mean_ang < FRONT_LIMIT_DEG, f"front end: mean angular error {mean_ang}")
    return features, cfg


def check_top2_real(device, features, cfg):
    """top2 against its plain version on the real SIFT and SURF stacks of
    phase 5 (all 120 pairs, one direction), with the cross-checked match
    counts per pair; kernel and plain times on the SIFT stack."""
    import torch

    from orthosfm_torch.ops import matching as match_ops
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.pipeline import matching as matching_mod

    pairs = [(i, j) for i in range(len(features)) for j in range(i + 1, len(features))]
    err_all, rel_all, times = 0.0, 0.0, {}
    for kind, ratio in (("sift", cfg.matching.lowe_ratio), ("surf", cfg.matching.surf_lowe_ratio)):
        descs = [f.sift_desc if kind == "sift" else f.surf_desc for f in features]
        stack, counts = matching_mod._stack_descriptors(descs, max(d.shape[0] for d in descs))
        bi = np.array([p[0] for p in pairs])
        bj = np.array([p[1] for p in pairs])
        fwd = [torch.as_tensor(np.asarray(a, np.int32), device=device)
               for a in (bi, bj, counts[bi], counts[bj])]
        bwd = [fwd[1], fwd[0], fwd[3], fwd[2]]
        err, rel, bad, near = top2_agreement(stack, *fwd)
        err2, rel2, bad2, near2 = top2_agreement(stack, *bwd)
        m_k = match_ops.match_pairs_batched(stack, *fwd, lowe_ratio=ratio, impl="kernel")
        m_t = match_ops.match_pairs_batched(stack, *fwd, lowe_ratio=ratio, impl="torch")
        # a pair's cross-checked matches may differ by its near-tie rows
        allowed = (near + near2).cpu().numpy()
        diff = np.abs((m_k >= 0).sum(dim=1).cpu().numpy() - (m_t >= 0).sum(dim=1).cpu().numpy())
        near, near2 = int(near.sum()), int(near2.sum())
        N, D = stack.shape[1:]
        print(f"  top2 {kind} stack ({len(pairs)} pairs x {N} x {D}): max |d2 err| "
              f"{max(err, err2):.3e}, index mismatches outside near ties {bad + bad2}, "
              f"near-tie rows {near + near2}; cross-checked matches kernel "
              f"{int((m_k >= 0).sum())} plain {int((m_t >= 0).sum())}, per-pair difference "
              f"max {int(diff.max())}, pairs over their near-tie allowance "
              f"{int((diff > allowed).sum())}")
        require(max(err, err2) < TOL_TOP2 and bad + bad2 == 0, f"top2 {kind} stack")
        require(bool(np.all(diff <= allowed)), f"top2 {kind}: match counts differ")
        err_all, rel_all = max(err_all, err, err2), max(rel_all, rel, rel2)
        times[f"top2_{kind}"] = (cuda_ms(lambda: mk.top2(stack, *fwd, impl="kernel"), 3),
                                 cuda_ms(lambda: mk.top2_ref(stack, *fwd), 3))
        print(f"  top2_{kind}: kernel {times[f'top2_{kind}'][0]:.3f} ms   plain "
              f"{times[f'top2_{kind}'][1]:.3f} ms  ({len(pairs)} pairs x {N} x {D}, one direction)")
    return err_all, rel_all, times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    t_all = time.perf_counter()

    from orthosfm_torch import kernel_build
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.pipeline import tracks_build
    from orthosfm_torch.solvers import ba_kernels as bk

    print("== phase 1: card and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = (bk.SOURCE, mk.SOURCE, tracks_build.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(kernel_build.build, sources))
    for lib in (bk.library, mk.library, tracks_build.library):
        lib()
    print(f"  built {', '.join(os.path.relpath(p) for p, _ in built)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for _, log in built:
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip())

    print("== phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    errs, rels, times = check_kernels(device)
    errs["top2"], rels["top2"], top2_times = check_top2_random(device)
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

    print(f"== phase 5: image front end, {FRONT_VIEWS} x {FRONT_WIDTH}^2 sphere views, "
          "through pose estimation")
    t0 = time.perf_counter()
    mk.top2.launches = 0
    bk.reset_launch_counts()
    features, cfg = run_front_end(device)
    launches["top2"] = mk.top2.launches
    front_ba = bk.launch_counts()
    print(f"  launches top2 {launches['top2']}, BA {front_ba}")
    require(launches["top2"] > 0, "top2 was not launched on the front end's path")
    require(all(n > 0 for n in front_ba.values()), "a BA kernel was not launched in phase 5")
    err, rel, real_times = check_top2_real(device, features, cfg)
    errs["top2"], rels["top2"] = max(errs["top2"], err), max(rels["top2"], rel)
    times["top2"] = real_times["top2_sift"]
    print(f"  phase 5 wall time {time.perf_counter() - t0:.2f} s")
    print(f"total wall time {time.perf_counter() - t_all:.2f} s")

    kernels = [{"name": name, "route": "cuda", "source": SOURCE_OF[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "max_rel_err": rels[name],
                "ms": times[name][0], "plain_ms": times[name][1]} for name in REPLACES]
    print(json.dumps({"kernels": kernels, "ba_iter_per_s": rates,
                      "top2_ms": {**top2_times, **real_times}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
