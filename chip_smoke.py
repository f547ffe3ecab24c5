#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (orthosfm_torch) on one GPU.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit, and the build of the native sources
     of orthosfm_torch/csrc/ (the BA kernels, the top-2 matching kernel and
     the union-find), one compiler each, all started together;
  2. each kernel against its plain PyTorch version on the card: the BA
     kernels (schur_assemble, camera_solve, and point_update_cost with the
     accept rule of lm_accept in its last CTA, held against
     point_update_cost_ref then lm_accept_ref, for a step accepted and one
     rejected) at the shapes of the standard BA problem (16 views x 8192
     sphere tracks, 2048^2, cameras perturbed by up to 1 degree), for
     quaternion and Euler cameras, with points optimized and fixed; each
     also at 3 views x 7800 tracks (the local BA) and 64 x 4096, and timed
     at all three beside its plain version, its bound and, for camera_solve,
     torch.linalg.solve_ex alone on the same prepared system, and
     point_update_cost also without its tail (the difference is the time
     the accept rule adds, lm_accept's row); top2 on random
     unit descriptors, 8 pairs x 8192 rows x 128 and x 64, with duplicated
     rows (exact ties), repeated views and databases of 0 and 1 valid rows;
  3. pose estimation from tracks (run_pose_estimation with the kernels) on
     the 16-view 2048^2 blob scene (7800 tracks), solvers 0 and 3,
     noise-free (mean angular error < 0.01 deg) and with sigma = 1 px pixel
     noise (< 0.25 deg), with the launch counts of the BA kernels over this
     phase, the LM iterations that did work and the host's enqueue time per
     launched iteration, and the port's writers producing cameras.txt,
     sparse_cloud.ply, tracks.txt and time_measurements.txt;
  4. BA iterations/s of the kernel path and of the plain PyTorch path on the
     standard problem and on a 64-view problem (64 x 4096 tracks), 30
     iterations each, and the host's enqueue time per iteration;
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
import math
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
# lm_accept is no kernel of its own: its rule runs in the last CTA of K2
FOLDED = {"lm_accept": "point_update_cost"}
# Kernel vs plain version on the same inputs. Sums over 8192 tracks run in
# another order on the card (per-CTA partials) than in the CPU-style plain
# path, and a Cholesky factorization replaces an LU solve: f32 rounding of
# ~1e-6 relative per sum. The solve's bound sits well below the change
# that mishandled damping would make (about lambda relative: 1e-3 and 1 are
# both checked).
TOL_SCHUR_REL = 1e-4      # max |S' - S'_ref| / max |S'_ref| (and rhs, dU)
TOL_SOLVE_REL = 1e-5      # max |delta - delta_ref| / max |delta_ref|
SOLVE_LAMBDAS = (1e-3, 1.0)
# K2 takes the plain step of each: lambda 1e-3 is the size of step the main
# path takes (from lambda_0 = 1e-4 downward), lambda 1 a damped one
BA_SHAPES = ((N_VIEWS, N_TRACKS), (64, 4096))
# K1, K3 and K2 are timed at the main path's three shapes: the local BA of
# a 3-view group (n = 18, the slice's 7800 tracks), the global BA
# (make_problem(), n = 96) and many views (n = 384)
BA_SHAPES_TIMED = ((3, 7800), (N_VIEWS, N_TRACKS), (64, 4096))
# Bounds: the card's published peaks (H100 SXM data sheet): f32 outside the
# tensor cores and HBM3 bandwidth
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# FMA per observation besides the Schur term, counted from the plain
# versions' formulas: K1 projection and Jacobians (~60), the point block and
# gradient (18), U's upper triangle (42), W = w Jc^T Jp (36), W V^-1 (54) and
# the rhs (30); K2 the Jacobians (~60), point block (18), W^T dc (24) and the
# projection and robust cost through the candidate cameras (~18)
K1_OBS_FMA = 240
K2_OBS_FMA = 120
# cuda_ms's sleep: cycles of torch.cuda._sleep per second (above the H100's
# 1.98 GHz boost clock, so the sleep lasts at least as long as asked)
SLEEP_CYCLES_PER_S = 2.0e9
TOL_POINTS_ABS = 1e-5     # retracted unit points, abs
TOL_COST_REL = 1e-4       # robust cost, relative
TOL_STATE_REL = 1e-5      # LM scalar state after accept but its cost, relative
LM_CFG_ARGS = (1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)  # lam0, func_tol, up, down, min, max
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
    """Mean device time of fn() over n launches, by CUDA events. The card
    first sleeps while the host enqueues all n calls, so the events time the
    device's work and not the host's pace (the wrappers' Python takes tens
    of microseconds a call, more than several kernels run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * n * host_s + 1e-3, 2.0) * SLEEP_CYCLES_PER_S))
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


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for work of
    `flops` f32 operations over `nbytes` bytes moved."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def ba_work(maskT, opt):
    """(flops, bytes) of K1, K3 and K2 (with its accept tail) on this
    problem, counting the observations the mask holds (m_t views of track
    t): the Schur term is the symmetric half of a rank-3 update of the
    (6 m_t)-square block per track, 3 (6m)(6m+1)/2 FMA; the per-observation
    block math is counted as K1_OBS_FMA and K2_OBS_FMA. Each input is read
    once, each output written once; the tail alone (lm_accept) reads K2's
    per-CTA partials and a state slot and writes the other."""
    V, T = maskT.shape
    n = 6 * V
    m = (maskT != 0).sum(dim=0).double()
    n_obs = float(m.sum())
    schur = float((3 * (6 * m) * (6 * m + 1) / 2).sum()) if opt else 0.0
    inputs = 16 * T + 12 * V * T + 72 * V  # pT, obsT + maskT, rot + camp + free
    k1 = (2 * (schur + K1_OBS_FMA * n_obs), inputs + 4 * (n * n + 2 * n))
    k3 = (2 * (n ** 3 / 6 + n * n), 4 * (n * n + 3 * n) + 32 + 4 * (6 + 4 + 8) * V)
    # the step, the candidate cameras, the new points, the state in and out
    k2 = (2 * K2_OBS_FMA * n_obs, inputs + 4 * 6 * V + 48 * V + 16 * T + 2 * 32)
    tail = (0.0, 4 * math.ceil(T / 32) + 2 * 32)
    return {"schur_assemble": k1, "camera_solve": k3, "point_update_cost": k2, "lm_accept": tail}


def stage_inputs(kind, device, num_views, n_tracks):
    """The standard problem's (pT, obsT, maskT, rot, camp, free) at a size."""
    from orthosfm_torch.core import cameras as cam_mod
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    cams, points, obs, mask = make_problem(kind, device, num_views, n_tracks, WIDTH)
    pT, obsT, maskT = ba.prepare(points, obs, mask)
    return (pT, obsT, maskT, cams.rot.contiguous(), ba.pack_camp(cams),
            cam_mod.free_mask(cams).float().contiguous())


def lm_inputs(inputs):
    """The stage inputs with the points and cameras as fresh LM buffers."""
    from orthosfm_torch.solvers import ba_kernels as bk

    pT, obsT, maskT, rot, camp, free = inputs
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    return p2, obsT, maskT, r2, c2, free


def camera_step(solve, kind, S, dU, rhs, free, lam, rot, camp):
    """One camera solve (K3 or its plain version) at lambda `lam` from fresh
    LM buffers of rot and camp: (delta, candidate rot, candidate camp)."""
    from orthosfm_torch.solvers import ba_kernels as bk

    r2, c2 = bk.lm_buffers(rot, camp)
    delta = solve(kind, S, dU, rhs, free, bk.new_state(lam, rot.device), r2, c2)
    return delta, r2[1], c2[1]


def check_schur_and_solve(kind, inputs, opt, errs, rels, label):
    """K1 and K3 against their plain versions on one problem; returns the
    plain step and candidate cameras of each lambda of SOLVE_LAMBDAS."""
    from orthosfm_torch.solvers import ba_kernels as bk

    pT, obsT, maskT, rot, camp, free = inputs
    device = pT.device
    args = (kind, *lm_inputs(inputs), bk.new_state(1e-3, device), 1.0, opt)
    S, dU, rhs = bk.schur_assemble(*args)
    S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
    e = max(rel_err(S, S_r), rel_err(rhs, rhs_r), rel_err(dU, dU_r))
    print(f"  schur_assemble   {label} {kind:5s} opt={opt!s:5s} rel err {e:.3e}")
    require(e < TOL_SCHUR_REL, f"schur_assemble {label} {kind} opt={opt}: {e}")
    rels["schur_assemble"] = max(rels["schur_assemble"], e)
    errs["schur_assemble"] = max(errs["schur_assemble"], max_err(S, S_r),
                                 max_err(rhs, rhs_r), max_err(dU, dU_r))
    steps = {}
    for lam in SOLVE_LAMBDAS:
        sargs = (kind, S_r, dU_r, rhs_r, free, lam, rot, camp)
        delta, rot_c, camp_c = camera_step(bk.camera_solve, *sargs)
        delta_r, rot_cr, camp_cr = steps[lam] = camera_step(bk.camera_solve_ref, *sargs)
        e = rel_err(delta, delta_r)
        print(f"  camera_solve     {label} {kind:5s} opt={opt!s:5s} lambda={lam:g} "
              f"rel err {e:.3e}")
        require(e < TOL_SOLVE_REL, f"camera_solve {label} {kind} opt={opt} lambda={lam}: {e}")
        rels["camera_solve"] = max(rels["camera_solve"], e)
        errs["camera_solve"] = max(errs["camera_solve"], max_err(delta, delta_r),
                                   max_err(rot_c, rot_cr), max_err(camp_c, camp_cr))
    return steps


def k2_stage(kind, inputs, opt, rot_c, camp_c, plain):
    """K2 with its accept tail (or its plain version) on LM buffers whose
    half 0 holds the current cameras and points and half 1 the candidate
    cameras."""
    from orthosfm_torch.solvers import ba_kernels as bk

    p2, obsT, maskT, r2, c2, free = lm_inputs(inputs)
    r2[1], c2[1] = rot_c, camp_c
    return bk.PointUpdateCost(kind, p2, obsT, maskT, r2, c2, free, 1.0, opt,
                              bk.LMConfig(*LM_CFG_ARGS), plain=plain), (p2, r2, c2)


def check_point_update_cost(kind, inputs, opt, lam, step, errs, rels, label):
    """K2 with its accept tail against point_update_cost_ref then
    lm_accept_ref (point_update_accept_ref), for the plain step of lambda
    `lam` held to a higher previous cost (accepted: state[CUR] flips) and to
    a lower one (rejected)."""
    import torch

    from orthosfm_torch.solvers import ba_kernels as bk

    delta, rot_c, camp_c = step
    device = delta.device
    _, parts_r = bk.point_update_cost_ref(kind, *inputs, bk.new_state(lam, device), delta,
                                          rot_c, camp_c, 1.0, opt)
    for factor, accepted in ((2.0, True), (0.5, False)):
        s_in = bk.new_state(lam, device)
        s_in[bk.COST] = parts_r.sum() * factor
        outs = []
        for plain in (False, True):
            stage, bufs = k2_stage(kind, inputs, opt, rot_c, camp_c, plain)
            s_out = torch.zeros_like(s_in)
            outs.append((s_out, stage(s_in, s_out, delta), bufs))
        (s_k, parts_k, (p_k, r_k, c_k)), (s_p, parts_p, (p_p, r_p, c_p)) = outs
        e_p = max_err(p_k[1], p_p[1]) if opt else max_err(p_k, p_p)
        e_c = rel_err(s_k[bk.COST], s_p[bk.COST]) if accepted else rel_err(parts_k.sum(),
                                                                           parts_p.sum())
        keep = [i for i in range(bk.STATE_SIZE) if i != bk.COST]
        e_s = rel_err(s_k[keep], s_p[keep])
        e_x = max(max_err(r_k, r_p), max_err(c_k, c_p), max_err(p_k[0], p_p[0]),
                  abs(float(s_k[bk.CUR]) - float(accepted)))
        step_kind = "accepted" if accepted else "rejected"
        print(f"  point_update_cost {label} {kind:5s} opt={opt!s:5s} lambda={lam:g} {step_kind}: "
              f"points {e_p:.3e} cost rel {e_c:.3e}; lm_accept state rel {e_s:.3e} selection "
              f"{e_x:.3e}")
        require(e_p < TOL_POINTS_ABS and e_c < TOL_COST_REL,
                f"point_update_cost {label} {kind} opt={opt} lambda={lam} {step_kind}: {e_p} {e_c}")
        require(e_s < TOL_STATE_REL and e_x == 0.0,
                f"lm_accept {label} {kind} opt={opt} lambda={lam} {step_kind}: {e_s} {e_x}")
        require(float(s_k[bk.ITERS]) == 1.0, "the accept tail did not step")
        rels["point_update_cost"] = max(rels["point_update_cost"], e_p, e_c)
        errs["point_update_cost"] = max(errs["point_update_cost"], e_p,
                                        max_err(s_k[bk.COST], s_p[bk.COST]))
        rels["lm_accept"] = max(rels["lm_accept"], e_s, e_x)
        errs["lm_accept"] = max(errs["lm_accept"], max_err(s_k[keep], s_p[keep]), e_x)


def near_fit_witness(device):
    """K2 near an exact fit: the noise-free 3 x 7800 problem with a fifth of
    its tracks unobserved and 40% of the other entries masked (as in the card
    tests), and the plain step of lambda 1e-3, after which the cost is ~1e-4
    of what it was. There f32 rounding in the cost pass moves the cost by up
    to ~1e-3 (a rounding of a rotation matrix is one error shared by all of
    a view's observations), so the kernel and the f32 plain version are no
    witnesses of each other's cost to TOL_COST_REL. Holds the kernel's
    points to the plain version's (TOL_POINTS_ABS) and returns the kernel's
    cost beside the plain version's in f32 and in f64 (the same f32 inputs
    and step), the plain f32 cost at the kernel's points, the plain f32 cost
    with its rotation matrices rounded from f64, and the f64 cost at the
    plain f32 points."""
    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk

    n_views, n_tracks, lam = 3, 7800, 1e-3
    pT, obsT, maskT, rot, camp, free = stage_inputs("quat", device, n_views, n_tracks)
    rng = np.random.default_rng(1)
    keep = torch.as_tensor(rng.random(maskT.shape) > 0.4, device=device)
    keep[:, : n_tracks // 5] = False
    keep[:, (keep & (maskT != 0)).sum(dim=0) < 2] = False
    inputs = (pT, obsT, (maskT * keep).contiguous(), rot, camp, free)
    S, dU, rhs = bk.normal_eq_schur_ref("quat", *lm_inputs(inputs), bk.new_state(lam, device),
                                        1.0, True)
    step = camera_step(bk.camera_solve_ref, "quat", S, dU, rhs, free, lam, rot, camp)
    stage, (p2, _, _) = k2_stage("quat", inputs, True, step[1], step[2], False)
    cost_k = float(stage(bk.new_state(lam, device), None, step[0]).double().sum())
    p_k = p2[1]
    p_r, parts_r = bk.point_update_cost_ref("quat", *inputs, bk.new_state(lam, device), *step,
                                            1.0, True)
    p_64, parts_64 = bk.point_update_cost_ref(
        "quat", *(x.double() for x in inputs), bk.new_state(lam, device).double(),
        *(x.double() for x in step), 1.0, True)
    _, parts_at_k = bk.point_update_cost_ref("quat", p_k, *inputs[1:], None, None, *step[1:],
                                             1.0, False)
    _, parts_64_at_r = bk.point_update_cost_ref("quat", *(x.double() for x in (p_r, *inputs[1:])),
                                                None, None, *(x.double() for x in step[1:]), 1.0,
                                                False)
    # the plain f32 cost at its own points, its rotation matrices rounded
    # from f64 instead of formed in f32
    m = inputs[2] != 0
    r = ba._project_residuals_T(ba.rotation_tensors("quat", step[1].double())[0].float(),
                                step[2], p_r, obsT)
    cost_r64 = ba.robust_cost(torch.where(m[:, None, :], r, torch.zeros_like(r)), m, 1.0)
    out = {"cost_kernel": cost_k, "cost_plain_f32": float(parts_r.double().sum()),
           "cost_plain_f64": float(parts_64.sum()),
           "cost_plain_f32_at_kernel_points": float(parts_at_k.double().sum()),
           "cost_plain_f32_rotations_from_f64": float(cost_r64),
           "cost_plain_f64_at_plain_f32_points": float(parts_64_at_r.sum()),
           "points_kernel_vs_plain_f32": max_err(p_k, p_r),
           "points_kernel_vs_plain_f64": max_err(p_k, p_64),
           "points_plain_f32_vs_plain_f64": max_err(p_r, p_64)}
    rel_64 = abs(cost_k - out["cost_plain_f64"]) / out["cost_plain_f64"]
    print(f"  point_update_cost near an exact fit ({n_views}x{n_tracks} masked, noise-free, "
          f"lambda={lam:g}): cost kernel {out['cost_kernel']:.6f} (rel to f64 {rel_64:.3e}), "
          f"plain f32 {out['cost_plain_f32']:.6f}, plain f64 {out['cost_plain_f64']:.6f}, plain "
          f"f32 at the kernel's points {out['cost_plain_f32_at_kernel_points']:.6f}, plain f32 "
          f"with rotations rounded from f64 {out['cost_plain_f32_rotations_from_f64']:.6f}, "
          f"plain f64 at the plain f32 points {out['cost_plain_f64_at_plain_f32_points']:.6f}; "
          f"points kernel - plain f32 {out['points_kernel_vs_plain_f32']:.3e}, kernel - plain "
          f"f64 {out['points_kernel_vs_plain_f64']:.3e}, plain f32 - plain f64 "
          f"{out['points_plain_f32_vs_plain_f64']:.3e}")
    require(out["points_kernel_vs_plain_f32"] < TOL_POINTS_ABS,
            f"point_update_cost near an exact fit: points {out['points_kernel_vs_plain_f32']}")
    return out


def time_ba_kernels(inputs):
    """K1, K3 and K2 with its accept tail at one shape (quat, points
    optimized, lambda 1e-3): kernel, plain and, for K3,
    torch.linalg.solve_ex alone on the same prepared system, with each one's
    bound from this problem's mask; and the tail alone (lm_accept): K2's
    time less K2's without the tail, beside lm_accept_ref."""
    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk

    pT, obsT, maskT, rot, camp, free = inputs
    state = bk.new_state(1e-3, pT.device)
    lm = lm_inputs(inputs)
    args = ("quat", *lm, state, 1.0, True)
    S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
    # K3 writes the candidate into half 1 of the buffers, which K1 never reads
    sargs = ("quat", S_r, dU_r, rhs_r, free, state, lm[3], lm[4])
    S_s, b, _ = ba.prepare_camera_system(S_r, dU_r, rhs_r, free, state[bk.LAM])
    delta, rot_c, camp_c = camera_step(bk.camera_solve_ref, "quat", S_r, dU_r, rhs_r, free, 1e-3,
                                       rot, camp)
    kernel, _ = k2_stage("quat", inputs, True, rot_c, camp_c, False)
    plain, _ = k2_stage("quat", inputs, True, rot_c, camp_c, True)
    s_in = bk.new_state(1e-3, pT.device)
    s_in[bk.COST] = 1e30
    s_out = torch.zeros_like(s_in)
    parts = plain(s_in, None, delta)
    acc_args = (parts, s_in, s_out, rot.clone(), camp.clone(), pT.clone(), rot_c, camp_c,
                pT.clone(), bk.LMConfig(*LM_CFG_ARGS))
    work = ba_work(maskT, True)
    n = 30 if maskT.shape[0] <= N_VIEWS else 10
    out = {}
    for name, kern, plain_fn, lib in (
            ("schur_assemble", lambda: bk.schur_assemble(*args),
             lambda: bk.normal_eq_schur_ref(*args), None),
            ("camera_solve", lambda: bk.camera_solve(*sargs), lambda: bk.camera_solve_ref(*sargs),
             lambda: torch.linalg.solve_ex(S_s, b)),
            ("point_update_cost", lambda: kernel(s_in, s_out, delta),
             lambda: plain(s_in, s_out, delta), None)):
        b_ms, b_by = bound(*work[name])
        out[name] = {"ms": cuda_ms(kern, n), "plain_ms": cuda_ms(plain_fn, n),
                     "library_ms": cuda_ms(lib, n) if lib else None,
                     "bound_ms": b_ms, "bound_by": b_by}
    no_tail = cuda_ms(lambda: kernel(s_in, None, delta), n)
    b_ms, b_by = bound(*work["lm_accept"])
    out["lm_accept"] = {"ms": out["point_update_cost"]["ms"] - no_tail,
                        "point_update_cost_without_tail_ms": no_tail,
                        "plain_ms": cuda_ms(lambda: bk.lm_accept_ref(*acc_args), n),
                        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    return out


def check_kernels(device):
    """Phase 2: every kernel against its plain version on the card."""
    errs = {name: 0.0 for name in BA_KERNELS}   # max abs error over all cases
    rels = {name: 0.0 for name in BA_KERNELS}   # max relative error over all cases
    # the main path's three shapes: the local BA (3 views, n = 18, K3 in one
    # warp), the global BA and make_problem() (16 views, n = 96), and many
    # views (64, n = 384, where K3's matrix leaves shared memory); both
    # camera kinds, points optimized and fixed, at the standard shape
    shapes = {}
    for num_views, n_tracks in BA_SHAPES_TIMED:
        label = f"{num_views}x{n_tracks}"
        kinds = ("quat", "euler") if (num_views, n_tracks) == (N_VIEWS, N_TRACKS) else ("quat",)
        for kind in kinds:
            inputs = stage_inputs(kind, device, num_views, n_tracks)
            for opt in (True, False):
                steps = check_schur_and_solve(kind, inputs, opt, errs, rels, label)
                for lam, step in steps.items():
                    check_point_update_cost(kind, inputs, opt, lam, step, errs, rels, label)
        shapes[label] = time_ba_kernels(inputs)
        for name, t in shapes[label].items():
            lib = "" if t["library_ms"] is None else f"   solve_ex {t['library_ms']:.4f} ms"
            print(f"  {name:18s} {label:8s} kernel {t['ms']:.4f} ms   plain {t['plain_ms']:.4f} "
                  f"ms{lib}   bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    shapes["near_fit"] = near_fit_witness(device)
    return errs, rels, dict(shapes[f"{N_VIEWS}x{N_TRACKS}"]), shapes


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
    """Phase 4: BA iterations/s of both paths, in turns, and the host's
    enqueue time per iteration (ba.run's return before the final sync, over
    its iterations)."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    cams, points, obs, mask = make_problem("quat", device, num_views, n_tracks, WIDTH)
    rates = {"kernel": [], "torch": []}
    enqueue = {"kernel": [], "torch": []}
    for impl in ("kernel", "torch", "torch", "kernel"):
        cfg = BundleAdjustConfig(max_iterations=30, function_tolerance=0.0, min_lambda=1e-12,
                                 impl=impl)
        ba.run(cams, points, obs, mask, True, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ba.run(cams, points, obs, mask, True, cfg)
        t_enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        iters = int(r.iterations)
        require(iters == 30, f"{impl}: {iters} iterations")
        require(float(r.cost) < float(r.initial_cost) * 1e-2, f"{impl} BA did not converge")
        rates[impl].append(iters / dt)
        enqueue[impl].append(t_enq * 1e3 / cfg.max_iterations)
        print(f"  impl={impl:6s} {iters} iterations in {dt * 1e3:.2f} ms: {iters / dt:.1f} it/s, "
              f"host enqueue {t_enq * 1e3 / cfg.max_iterations:.4f} ms/iteration "
              f"(cost {float(r.initial_cost):.1f} -> {float(r.cost):.3e})")
    out = {k: float(np.mean(v)) for k, v in rates.items()}
    out.update({f"{k}_enqueue_ms_per_it": float(np.mean(v)) for k, v in enqueue.items()})
    return out


class BARecorder:
    """Records every ba.run call of a phase: its BAResult.iterations
    tensors (read once, at the end), its max_iterations and the host time
    until it returned (its enqueue time: ba.run does not sync on the card)."""

    def __init__(self):
        self.iterations, self.max_iterations, self.host_s = [], 0, 0.0

    @contextlib.contextmanager
    def recording(self):
        from orthosfm_torch.config import BundleAdjustConfig
        from orthosfm_torch.solvers import ba

        run = ba.run

        def recorded(*args, **kwargs):
            t0 = time.perf_counter()
            res = run(*args, **kwargs)
            self.host_s += time.perf_counter() - t0
            cfg = kwargs.get("config", args[5] if len(args) > 5 else BundleAdjustConfig())
            self.max_iterations += cfg.max_iterations
            self.iterations.append(res.iterations)
            return res

        ba.run = recorded
        try:
            yield self
        finally:
            ba.run = run

    def summary(self):
        import torch

        worked = int(torch.stack(self.iterations).sum()) if self.iterations else 0
        return {"ba_calls": len(self.iterations), "iterations_launched": self.max_iterations,
                "iterations_worked": worked,
                "enqueue_ms_per_it": self.host_s * 1e3 / max(self.max_iterations, 1)}


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
        # the bound: each pair's valid rows, each descriptor read once, the
        # three (pairs, N) outputs written once
        ci, cj = counts[bi].astype(np.float64), counts[bj].astype(np.float64)
        b_ms, b_by = bound(2.0 * float(np.sum(ci * cj)) * D,
                           4.0 * (float(np.sum(ci + cj)) * D + 3 * len(pairs) * N))
        t = {"ms": cuda_ms(lambda: mk.top2(stack, *fwd, impl="kernel"), 3),
             "plain_ms": cuda_ms(lambda: mk.top2_ref(stack, *fwd), 3),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        times[f"top2_{kind}"] = t
        print(f"  top2_{kind}: kernel {t['ms']:.3f} ms   plain {t['plain_ms']:.3f} ms   bound "
              f"{b_ms:.5f} ms ({b_by})  ({len(pairs)} pairs x {N} x {D}, one direction)")
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
    errs, rels, times, shapes = check_kernels(device)
    errs["top2"], rels["top2"], top2_times = check_top2_random(device)
    print(f"  phase 2 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 3: pose estimation from tracks (16 views x 7800 tracks, 2048^2)")
    t0 = time.perf_counter()
    recorder = BARecorder()
    bk.reset_launch_counts()
    with tempfile.TemporaryDirectory() as project, recorder.recording():
        run_slice(device, project)
    launches = bk.launch_counts()
    slice_ba = recorder.summary()
    print(f"  launches {launches}")
    require(set(launches) == set(BA_KERNELS) - set(FOLDED), f"BA kernels launched: {launches}")
    print(f"  BA: {slice_ba['ba_calls']} calls, {slice_ba['iterations_worked']} of "
          f"{slice_ba['iterations_launched']} iterations did work; host enqueue "
          f"{slice_ba['enqueue_ms_per_it']:.4f} ms per iteration")
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
    recorder = BARecorder()
    mk.top2.launches = 0
    bk.reset_launch_counts()
    with recorder.recording():
        features, cfg = run_front_end(device)
    launches["top2"] = mk.top2.launches
    front_ba = bk.launch_counts()
    front_iters = recorder.summary()
    print(f"  launches top2 {launches['top2']}, BA {front_ba}")
    print(f"  BA: {front_iters['ba_calls']} calls, {front_iters['iterations_worked']} of "
          f"{front_iters['iterations_launched']} iterations did work; host enqueue "
          f"{front_iters['enqueue_ms_per_it']:.4f} ms per iteration")
    require(launches["top2"] > 0, "top2 was not launched on the front end's path")
    require(all(n > 0 for n in front_ba.values()), "a BA kernel was not launched in phase 5")
    err, rel, real_times = check_top2_real(device, features, cfg)
    errs["top2"], rels["top2"] = max(errs["top2"], err), max(rels["top2"], rel)
    times["top2"] = real_times["top2_sift"]
    print(f"  phase 5 wall time {time.perf_counter() - t0:.2f} s")
    print(f"total wall time {time.perf_counter() - t_all:.2f} s")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # a folded kernel's launches are those of the kernel whose last CTA runs it
    kernels = [{"name": name, "route": "cuda", "source": SOURCE_OF[name],
                "replaces": REPLACES[name], "launches": launches[FOLDED.get(name, name)],
                "max_abs_err": errs[name], "max_rel_err": rels[name],
                **{k: times[name][k] for k in keys},
                **({"folded_into": FOLDED[name]} if name in FOLDED else {})}
               for name in REPLACES]
    print(json.dumps({"kernels": kernels, "ba_shapes": shapes, "ba_iter_per_s": rates,
                      "ba_main_path": {"phase3": slice_ba, "phase5": front_iters},
                      "top2_ms": {**top2_times, **real_times}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
