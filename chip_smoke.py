#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (orthosfm_torch) on one GPU.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit, and the build of the native sources
     of orthosfm_torch/csrc/ (the BA kernels, the top-2 matching kernel, the
     union-find and the tracks.txt reader), one compiler each, all started
     together;
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
     the accept rule adds, lm_accept's row); at 1100 views x 300 tracks,
     where K1 and K2 read their per-view tables from global memory (past
     shared memory), K1 and K2 checked the same way and all three timed
     (K3 there runs its cluster from a global scratch); top2 (both
     directions from one launch) on random unit descriptors, 8 pairs x
     8192 rows x 128 and x 64, with duplicated rows (exact ties), repeated
     views and databases
     of 0 and 1 valid rows, against its plain version, a second run and
     the swapped pair table (bit for bit), timed beside its plain version,
     with the host's time a call;
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
     SURF stacks of this run, both directions, with the cross-checked match
     counts per pair, timed beside the plain version and torch.bmm of the
     gathered stacks (the product alone);
  6. the testbench on the card: testbench.run.main with --generate
     --solvers all --repetitions 1 at width 320, the whole dataset_matrix
     (10 rendered datasets, 21 (dataset, solver) cells, in process), every
     cell's mean angular error < 1 deg, printed beside the JAX package's
     docs/results.csv, with the launch counts of K1, K3, K2 and top2 over
     the run (the slice's main path: the counts in the kernels line); then
     the noise sweep at its full size (Cube, Sphere, Suzanne; 16 views, 2048
     tracks; solvers 0 and 3) at 0, 1 and 10 px (< 0.01, < 0.25, < 3 deg, no
     failed entry), beside docs/synthetic_results_r5.csv; then
     bench_pipeline.run_benchmark(16, 512) and its JSON line;
  7. RANSAC-H: reconstruct with pair_verification="homography" at the
     reference's 10000 hypotheses on the JAX package's test scene (5 views of
     224^2, seed 3, a 100 degree ring): every view placed, max error < 3 deg;
     then find_homography_batched_keys timed on phase 5's real candidate
     pairs (pairs, M, chunks, inlier counts);
  8. the multi-device path (orthosfm_torch/parallel/) on a process group of
     one rank over NCCL, the slice's main path: the sharded BA (K1 on the
     shard, one all_reduce of S, dU and rhs, K3, K2 in split mode, the
     all_reduce of the cost, K4 lm_accept) on make_problem() and on
     2000 views x 2000 tracks (K3 by its grid route), the sharded TK and
     match_all_pairs(mesh=) on phase 5's features, each bit for bit against
     one device, with the launch counts of every kernel over this phase
     (the counts in the kernels line); then two ranks on the one card over
     gloo (the sharded BA against one device), where gloo takes CUDA
     tensors, and the CLI's --devices past the cards present, which must
     raise.

Phase 2 also runs K3's grid route at 700, 1100 and 2000 views (n = 4200,
6600, 12000) beside torch.linalg.solve_ex, held to an f64 solve (no further
from it than twice the plain f32 LU is), with its bound, and the cluster
against the grid route at the crossover (128 views); phase 4 also runs
ba.run both ways at 700, 1100 and 2000 views x 2000 tracks, 10 iterations,
with each stage's time there.

With --parent DIR (a checkout of the parent commit), top2 is also timed in
turns against DIR's by scripts/torch_top2_turns.py.

Any failed check raises. On success the line before the last is a JSON
object of per-kernel results, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script exits non-zero before doing anything.
"""

import contextlib
import dataclasses
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
    "camera_solve_grid": "orthosfm_tpu/solvers/ba_fused.py:545",
    "point_update_cost": "orthosfm_tpu/solvers/ba_pallas.py:447",
    "lm_accept": "orthosfm_tpu/solvers/ba_fused.py:545",
    "top2": "orthosfm_tpu/ops/matching_pallas.py:87",
}
SOURCE_OF = {name: BA_SOURCE for name in REPLACES}
SOURCE_OF["top2"] = MATCH_SOURCE
BA_KERNELS = ("schur_assemble", "camera_solve", "point_update_cost", "lm_accept")
# The unsharded BA (phases 3 to 7) launches K1, K3 and K2; K4 lm_accept's
# rule runs there in K2's last CTA, and as a launch of its own only in the
# sharded BA (phase 8), which the kernels line's launches count.
UNSHARDED_BA = ("schur_assemble", "camera_solve", "point_update_cost")
# K3's grid route (camera_solve_grid in the kernels line): phase 2 at these
# views of K3_TRACKS tracks, timed at K3_GRID_TIMED; the crossover with the
# cluster (GRID_MIN_V in the CUDA source)
K3_GRID_VIEWS = (700, 1100, 2000)
K3_GRID_TIMED = 1100
K3_CROSSOVER_VIEWS = 128
K3_TRACKS = 300
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
# vectors differs by a few 1e-7. Indices must agree, in both directions,
# except on rows whose best and second d2 (plain version) lie within this of
# each other.
TOL_TOP2 = 1e-5
# Phase 5: the JAX package's reference-scale run
# (testbench/bench_pipeline.py --views 16 --width 2048)
FRONT_VIEWS = 16
FRONT_WIDTH = 2048
FRONT_SEED = 7
FRONT_RING_DEG = 200.0
FRONT_LIMIT_DEG = 1.0
# Phase 2 past shared memory: K1's per-view tables and sums leave it past
# ~600 views, K2's past ~990
BA_SHAPE_MANY = (1100, 300)
# Phase 4 past shared memory: ba.run end to end, both routes, 10 iterations
BA_RUN_SHAPES_MANY = ((700, 2000), (1100, 2000), (2000, 2000))
BA_RUN_ITERATIONS_MANY = 10
# Phase 8: the sharded BA's problems (views, tracks, iterations), its TK
# group and the two gloo ranks' problem
SHARDED_BA_SHAPES = ((N_VIEWS, N_TRACKS, 30), (2000, 2000, 10))
GLOO_SHAPE = (N_VIEWS, N_TRACKS, 30)
# Phase 6: the testbench's matrix at its default width, and the noise sweep
TESTBENCH_WIDTH = 320
TESTBENCH_LIMIT_DEG = 1.0
SWEEP_LIMITS_DEG = {0.0: 0.01, 1.0: 0.25, 10.0: 3.0}
BENCH_VIEWS, BENCH_WIDTH = 16, 512
# Phase 7: the JAX package's homography test scene
# (tests/test_full_pipeline.py:107)
HOMOGRAPHY_LIMIT_DEG = 3.0


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


def host_ms(fn, n=20):
    """Mean host time of fn() over n calls, none of which waits on the card:
    the enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return t


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
    once, each output written once; K4 lm_accept reads the summed cost and
    a state slot and writes the other."""
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
    # K4 alone: the summed cost and a state slot in, the other slot out
    k4 = (0.0, 4 + 2 * 32)
    return {"schur_assemble": k1, "camera_solve": k3, "point_update_cost": k2, "lm_accept": k4}


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


def k2_stage(kind, inputs, opt, rot_c, camp_c, plain, split=False):
    """K2 with its accept tail (or its plain version; or in split mode) on
    LM buffers whose half 0 holds the current cameras and points and half 1
    the candidate cameras."""
    from orthosfm_torch.solvers import ba_kernels as bk

    p2, obsT, maskT, r2, c2, free = lm_inputs(inputs)
    r2[1], c2[1] = rot_c, camp_c
    return bk.PointUpdateCost(kind, p2, obsT, maskT, r2, c2, free, 1.0, opt,
                              bk.LMConfig(*LM_CFG_ARGS), plain=plain, split=split), (p2, r2, c2)


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
        # K2 in split mode, then K4 lm_accept on its cost: the folded tail's bits
        split, (p_s, r_s, c_s) = k2_stage(kind, inputs, opt, rot_c, camp_c, False, split=True)
        s_s = torch.zeros_like(s_in)
        bk.lm_accept(split(s_in, None, delta), s_in, s_s, bk.LMConfig(*LM_CFG_ARGS))
        require(torch.equal(s_s, s_k) and torch.equal(p_s, p_k),
                f"K2 split + lm_accept {label} {kind} opt={opt}: not the folded tail's bits")
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


def check_many_views(device, errs, rels):
    """K1 and K2 at BA_SHAPE_MANY, past shared memory, against their plain
    versions (K2 on the plain step of each lambda), and the three kernels
    timed there."""
    from orthosfm_torch.solvers import ba_kernels as bk

    num_views, n_tracks = BA_SHAPE_MANY
    label = f"{num_views}x{n_tracks}"
    inputs = stage_inputs("quat", device, num_views, n_tracks)
    pT, obsT, maskT, rot, camp, free = inputs
    args = ("quat", *lm_inputs(inputs), bk.new_state(1e-3, device), 1.0, True)
    S, dU, rhs = bk.schur_assemble(*args)
    S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
    e = max(rel_err(S, S_r), rel_err(rhs, rhs_r), rel_err(dU, dU_r))
    print(f"  schur_assemble   {label} quat  opt=True  rel err {e:.3e}")
    require(e < TOL_SCHUR_REL, f"schur_assemble {label}: {e}")
    rels["schur_assemble"] = max(rels["schur_assemble"], e)
    errs["schur_assemble"] = max(errs["schur_assemble"], max_err(S, S_r), max_err(rhs, rhs_r),
                                 max_err(dU, dU_r))
    for lam in SOLVE_LAMBDAS:
        step = camera_step(bk.camera_solve_ref, "quat", S_r, dU_r, rhs_r, free, lam, rot, camp)
        check_point_update_cost("quat", inputs, True, lam, step, errs, rels, label)
    return time_ba_kernels(inputs)


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
    n = 30 if maskT.shape[0] <= N_VIEWS else 10 if maskT.shape[0] <= 64 else 5
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
    split, _ = k2_stage("quat", inputs, True, rot_c, camp_c, False, split=True)
    cost = split(s_in, None, delta)
    cfg = bk.LMConfig(*LM_CFG_ARGS)
    b_ms, b_by = bound(*work["lm_accept"])
    # K4's own launch (the sharded LM's accept) and the rule folded into
    # K2's last CTA (K2's time less K2's without the tail)
    out["lm_accept"] = {"ms": cuda_ms(lambda: bk.lm_accept(cost, s_in, s_out, cfg), n),
                        "tail_ms": out["point_update_cost"]["ms"] - no_tail,
                        "point_update_cost_without_tail_ms": no_tail,
                        "plain_ms": cuda_ms(lambda: bk.lm_accept_ref(*acc_args), n),
                        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    return out


def k3_system(device, num_views):
    """The plain reduced camera system of the standard problem at lambda
    1e-3 (num_views x K3_TRACKS), its LM buffers and its f64 solve."""
    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk

    inputs = stage_inputs("quat", device, num_views, K3_TRACKS)
    lm = lm_inputs(inputs)
    state = bk.new_state(1e-3, device)
    S, dU, rhs = bk.normal_eq_schur_ref("quat", *lm, state, 1.0, True)
    free = inputs[5]
    d64 = ba._solve_camera_system(S.double(), dU.double(), rhs.double(), free,
                                  torch.tensor(1e-3, dtype=torch.float64, device=device))
    return (S, dU, rhs, free, state, lm[3], lm[4]), inputs, d64


def check_k3_routes(device, errs, rels):
    """K3's grid route at K3_GRID_VIEWS and the cluster against it at the
    crossover: each held to the f64 solve (no further from it than twice
    the plain f32 LU is, plus 1e-6) and timed beside the plain version,
    torch.linalg.solve_ex on the same prepared system and the bound
    (n^3 / 6 + n^2 FMA). Returns {views: {route: times}}."""
    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk

    out = {}
    for num_views in (K3_CROSSOVER_VIEWS, *K3_GRID_VIEWS):
        sargs, inputs, d64 = k3_system(device, num_views)
        S, dU, rhs, free, state, r2, c2 = sargs
        rot, camp = inputs[3], inputs[4]
        n = 6 * num_views

        def rel64(d):
            return float((d.double() - d64).abs().max() / d64.abs().max())

        delta_r, rot_cr, camp_cr = camera_step(bk.camera_solve_ref, "quat", S, dU, rhs, free, 1e-3,
                                               rot, camp)
        S_s, b, _ = ba.prepare_camera_system(S, dU, rhs, free, state[bk.LAM])
        n_time = 10 if num_views <= K3_GRID_TIMED else 5
        shared = {"solve_ex_ms": cuda_ms(lambda: torch.linalg.solve_ex(S_s, b), n_time),
                  "plain_rel_err_f64": rel64(delta_r)}
        if num_views == K3_GRID_TIMED:
            shared["plain_ms"] = cuda_ms(lambda: bk.camera_solve_ref("quat", *sargs), n_time)
        b_ms, b_by = bound(2 * (n ** 3 / 6 + n * n), 4 * (n * n + 3 * n) + 32 + 72 * num_views)
        out[num_views] = {"bound_ms": b_ms, "bound_by": b_by, **shared}
        for route in (("cluster", "grid") if num_views == K3_CROSSOVER_VIEWS else ("grid",)):
            solve = lambda *a, r=route: bk.camera_solve(*a, route=r)  # noqa: E731
            delta, rot_c, camp_c = camera_step(solve, "quat", S, dU, rhs, free, 1e-3, rot, camp)
            e64 = rel64(delta)
            ms = cuda_ms(lambda: solve("quat", *sargs), n_time)
            out[num_views][route] = {"ms": ms, "rel_err_f64": e64,
                                     "rel_err_plain": rel_err(delta, delta_r)}
            print(f"  camera_solve {route:7s} {num_views}x{K3_TRACKS} (n = {n}): {ms:.4f} ms, "
                  f"solve_ex {shared['solve_ex_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"rel err to f64 {e64:.3e} (plain LU {shared['plain_rel_err_f64']:.3e})")
            require(e64 <= 2.0 * shared["plain_rel_err_f64"] + 1e-6,
                    f"camera_solve {route} at {num_views} views: {e64} from the f64 solve")
            if route == "grid":
                errs["camera_solve_grid"] = max(errs["camera_solve_grid"], max_err(delta, delta_r),
                                                max_err(rot_c, rot_cr), max_err(camp_c, camp_cr))
                rels["camera_solve_grid"] = max(rels["camera_solve_grid"],
                                                rel_err(delta, delta_r))
    return out


def check_kernels(device):
    """Phase 2: every kernel against its plain version on the card."""
    errs = {name: 0.0 for name in (*BA_KERNELS, "camera_solve_grid")}  # max abs error, all cases
    rels = {name: 0.0 for name in errs}         # max relative error over all cases
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
    # past shared memory: K1 and K2 read global tables (K3, timed here, is
    # held to the f64 solve at this size by tests/test_torch_cuda.py)
    label = "x".join(map(str, BA_SHAPE_MANY))
    shapes[label] = check_many_views(device, errs, rels)
    for name, t in shapes[label].items():
        print(f"  {name:18s} {label:8s} kernel {t['ms']:.4f} ms   plain {t['plain_ms']:.4f} ms"
              f"   bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    shapes["near_fit"] = near_fit_witness(device)
    shapes["k3_routes"] = check_k3_routes(device, errs, rels)
    times = dict(shapes[f"{N_VIEWS}x{N_TRACKS}"])
    grid = shapes["k3_routes"][K3_GRID_TIMED]
    times["camera_solve_grid"] = {"ms": grid["grid"]["ms"], "plain_ms": grid["plain_ms"],
                                  "library_ms": grid["solve_ex_ms"], "bound_ms": grid["bound_ms"],
                                  "bound_by": grid["bound_by"]}
    return errs, rels, times, shapes


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


def ba_rate(device, num_views, n_tracks, iterations=30):
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
        cfg = BundleAdjustConfig(max_iterations=iterations, function_tolerance=0.0,
                                 min_lambda=1e-12, impl=impl)
        ba.run(cams, points, obs, mask, True, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ba.run(cams, points, obs, mask, True, cfg)
        t_enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        iters = int(r.iterations)
        require(iters == iterations, f"{impl}: {iters} iterations")
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


def top2_pairs(device, counts):
    """(bi, bj, ci, cj) on the card: every pair i < j of len(counts) views."""
    import torch

    n = len(counts)
    bi = np.array([i for i in range(n) for j in range(i + 1, n)])
    bj = np.array([j for i in range(n) for j in range(i + 1, n)])
    return [torch.as_tensor(np.asarray(a, np.int32), device=device)
            for a in (bi, bj, counts[bi], counts[bj])]


def random_top2_set(device, D, n=8192):
    """Phase 2's random unit descriptors, 11 views x n rows x D, and its 8
    pairs: exact ties (every database row of view 3 twice, view 2's queries
    equal to duplicated rows, view 1 against itself with repeated rows), a
    ragged pair, databases of 0 and 1 valid rows and a short query side."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0 if D == 128 else 1)
    stack = torch.randn((11, n, D), generator=gen, device=device)
    stack /= torch.linalg.vector_norm(stack, dim=-1, keepdim=True)
    stack[3, n // 2:] = stack[3, :n // 2]
    stack[2, :n // 4] = stack[3, :n // 4]
    stack[1, n - 100:] = stack[1, 100:200]
    pairs = [(0, 1, n, n), (2, 3, n, n), (4, 5, n - 37, n - 100), (6, 7, n, 0),
             (8, 9, n, 1), (1, 1, n, n), (10, 2, n // 8, n), (3, 0, n, n // 2 + 1)]
    return stack, [torch.tensor(c, dtype=torch.int32, device=device) for c in zip(*pairs)]


def feature_stacks(features, device):
    """{"sift": (stack, cols), "surf": ...}: the (16, N, D) descriptor stacks
    of phase 5's views and all their pairs, as match_all_pairs stacks them."""
    from orthosfm_torch.pipeline import matching as matching_mod

    out = {}
    for kind in ("sift", "surf"):
        descs = [f.sift_desc if kind == "sift" else f.surf_desc for f in features]
        stack, counts = matching_mod._stack_descriptors(descs, max(d.shape[0] for d in descs))
        out[kind] = (stack, top2_pairs(device, counts))
    return out


def front_end_stacks(device):
    """feature_stacks of phase 5's scene, rendered and extracted anew."""
    from orthosfm_torch.config import ReconstructionConfig
    from orthosfm_torch.pipeline import matching as matching_mod

    _, views = front_end_views(device)
    features = matching_mod.extract_all_view_features(views, ReconstructionConfig(), device)
    return feature_stacks(features, device)


def top2_work(stack, ci, cj):
    """(flops, bytes) of one product per pair, both directions' outputs: 2 D
    FMA operations per (query, database) pair of valid rows; each valid
    descriptor read once, the six (pairs, N) outputs written once."""
    N, D = stack.shape[1:]
    ci, cj = ci.double().cpu(), cj.double().cpu()
    return (2.0 * float((ci * cj).sum()) * D,
            4.0 * (float((ci + cj).sum()) * D + 6 * ci.shape[0] * N))


def check_top2(name, stack, cols, n_time):
    """The two-way top2 kernel against top2_ref on one batch of pairs, in
    both directions (d2 to TOL_TOP2, indices outside near ties); against
    itself bit for bit (a second run, the swapped pair table); and timed
    beside the plain version and torch.bmm of the gathered stacks (the
    product alone). Returns (max abs d2 error, relative, near-tie rows of
    each pair in either direction, times)."""
    import torch

    from orthosfm_torch.ops import matching_kernels as mk

    bi, bj, ci, cj = cols
    out = mk.top2(stack, *cols, impl="kernel")
    again = mk.top2(stack, *cols, impl="kernel")
    swapped = mk.top2(stack, bj, bi, cj, ci, impl="kernel")
    ref = mk.top2_ref(stack, *cols)
    torch.cuda.synchronize()
    err, rel, bad, near_rows = 0.0, 0.0, 0, 0
    iota = torch.arange(stack.shape[1], device=stack.device)[None, :]
    for k, counts in ((0, ci), (3, cj)):
        (kb, ks, ki), (rb, rs, ri) = out[k:k + 3], ref[k:k + 3]
        err = max(err, max_err(kb, rb), max_err(ks, rs))
        rel = max(rel, rel_err(kb, rb), rel_err(ks, rs))
        near = ((rs - rb) <= TOL_TOP2) & (iota < counts[:, None])
        bad += int(((ki != ri) & ~near).sum())
        near_rows = near_rows + near.sum(dim=1)
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    swap = all(torch.equal(a, b) for a, b in zip(out[3:] + out[:3], swapped))
    print(f"  top2 {name} ({bi.shape[0]} pairs x {stack.shape[1]} x {stack.shape[2]}): max |d2 "
          f"err| {err:.3e} both ways, index mismatches outside near ties {bad}, near-tie rows "
          f"{int(near_rows.sum())}; second run identical {same}, swapped pairs bit-equal {swap}")
    require(err < TOL_TOP2 and bad == 0, f"top2 {name}: {err} {bad}")
    require(same and swap, f"top2 {name}: not bit-stable ({same}, {swap})")
    qa, qb = stack[bi.long()], stack[bj.long()].transpose(1, 2)
    b_ms, b_by = bound(*top2_work(stack, ci, cj))
    call = lambda: mk.top2(stack, *cols, impl="kernel")  # noqa: E731
    t = {"ms": cuda_ms(call, n_time), "host_ms": host_ms(call, n_time),
         "plain_ms": cuda_ms(lambda: mk.top2_ref(stack, *cols), n_time),
         "bmm_ms": cuda_ms(lambda: torch.bmm(qa, qb), n_time),
         "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    print(f"  top2 {name}: kernel {t['ms']:.4f} ms (host {t['host_ms']:.4f} ms a call), plain "
          f"{t['plain_ms']:.4f} ms, bmm alone {t['bmm_ms']:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}, one product a pair)")
    return err, rel, near_rows, t


def check_top2_random(device):
    """Phase 2, top2: the random sets at D = 128 and 64."""
    err_all, rel_all, times = 0.0, 0.0, {}
    for D in (128, 64):
        stack, cols = random_top2_set(device, D)
        err, rel, _, times[f"top2_random_{D}"] = check_top2(f"random D={D}", stack, cols, 5)
        err_all, rel_all = max(err_all, err), max(rel_all, rel)
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


def front_end_views(device):
    """Phase 5's scene: (ground-truth cameras, 16 sphere views of 2048^2
    rendered on the card), the views holding host arrays, as images loaded
    from files do."""
    from orthosfm_torch.data.views import View
    from orthosfm_torch.testbench import render

    gt, images, _ = render.make_scene_views(FRONT_VIEWS, FRONT_WIDTH, FRONT_WIDTH,
                                            seed=FRONT_SEED, ring_degrees=FRONT_RING_DEG,
                                            device=device)
    return gt, [View(i, f"view_{i:02d}.png", FRONT_WIDTH, FRONT_WIDTH, pixels=img.cpu().numpy())
                for i, img in enumerate(images)]


def run_front_end(device):
    """Phase 5: the image front end and pose estimation at reference scale,
    through the functions reconstruct() calls, in its order."""
    import torch

    from orthosfm_torch.config import ReconstructionConfig, SolverType
    from orthosfm_torch.ops import ransac_f
    from orthosfm_torch.pipeline import incremental, track_utils
    from orthosfm_torch.pipeline import matching as matching_mod
    from orthosfm_torch.testbench import metrics

    t0 = time.perf_counter()
    gt, views = front_end_views(device)
    torch.cuda.synchronize()
    print(f"  rendered {FRONT_VIEWS} views of {FRONT_WIDTH}^2 on the card in "
          f"{time.perf_counter() - t0:.2f} s")
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
    phase 5 (all 120 pairs, both directions), with the cross-checked match
    counts per pair held to their near-tie allowance."""
    from orthosfm_torch.ops import matching as match_ops

    err_all, rel_all, times = 0.0, 0.0, {}
    for kind, (stack, cols) in feature_stacks(features, device).items():
        ratio = cfg.matching.lowe_ratio if kind == "sift" else cfg.matching.surf_lowe_ratio
        err, rel, near, times[f"top2_{kind}"] = check_top2(f"{kind} stack", stack, cols, 20)
        m_k = match_ops.match_pairs_batched(stack, *cols, lowe_ratio=ratio, impl="kernel")
        m_t = match_ops.match_pairs_batched(stack, *cols, lowe_ratio=ratio, impl="torch")
        # a pair's cross-checked matches may differ by its near-tie rows
        diff = np.abs((m_k >= 0).sum(dim=1).cpu().numpy() - (m_t >= 0).sum(dim=1).cpu().numpy())
        over = int((diff > near.cpu().numpy()).sum())
        print(f"  top2 {kind}: cross-checked matches kernel {int((m_k >= 0).sum())} plain "
              f"{int((m_t >= 0).sum())}, per-pair difference max {int(diff.max())}, pairs over "
              f"their near-tie allowance {over}")
        require(over == 0, f"top2 {kind}: match counts differ")
        err_all, rel_all = max(err_all, err), max(rel_all, rel)
    return err_all, rel_all, times


def top2_turns(parent):
    """scripts/torch_top2_turns.py on the parent tree and this one, in turns
    (parent, this, this, parent): its JSON runs."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "turns.json")
        proc = subprocess.run([sys.executable, os.path.join(here, "scripts", "torch_top2_turns.py"),
                               parent, here, here, parent, "--json", out],
                              capture_output=True, text=True, timeout=900)
        print("\n".join("  " + ln for ln in proc.stdout.splitlines()))
        require(proc.returncode == 0, f"top2 turns failed:\n{proc.stderr[-4000:]}")
        with open(out) as f:
            return json.load(f)["runs"]


def read_results_csv(path):
    """{(metric, dataset, config): value} of a results.csv in the reference's
    Metric;Dataset;configs... schema (empty cells left out)."""
    with open(path) as f:
        rows = [ln.rstrip("\n").split(";") for ln in f if ln.strip()]
    configs = rows[0][2:]
    return {(r[0], r[1], c): float(v) for r in rows[1:] for c, v in zip(configs, r[2:]) if v}


def read_sweep_csv(path):
    """{(dataset, solver, noise_px): mean angular error} of a sweep CSV."""
    with open(path) as f:
        rows = [ln.strip().split(",") for ln in f if ln.strip()][1:]
    return {(r[0], r[1], float(r[2])): float(r[3]) for r in rows}


def run_testbench(device, root):
    """Phase 6, the slice's main path: the testbench CLI over the whole
    dataset matrix on the card, with the launch counts of every kernel over
    it; then the noise sweep and the pipeline bench."""
    import torch

    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench import bench_pipeline, synthetic_tests
    from orthosfm_torch.testbench import run as tb_run

    here = os.path.dirname(os.path.abspath(__file__))
    proj, data = os.path.join(root, "proj"), os.path.join(root, "data")
    log = io.StringIO()
    bk.reset_launch_counts()
    mk.top2.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = tb_run.main([proj, data, "--generate", "--solvers", "all", "--repetitions", "1",
                          "--width", str(TESTBENCH_WIDTH)])
    torch.cuda.synchronize()
    t_matrix = time.perf_counter() - t0
    launches = {**bk.launch_counts(), "top2": mk.top2.launches}
    lines = log.getvalue().splitlines()
    for ln in lines:
        if ln.startswith("Run failed"):
            print("  " + ln)
    require(rc == 0, f"testbench.run.main returned {rc}")
    got = read_results_csv(os.path.join(proj, "results.csv"))
    ref = read_results_csv(os.path.join(here, "docs", "results.csv"))
    cells = [(row[0], tb_run.SOLVER_NAMES[s]) for row in tb_run.dataset_matrix(TESTBENCH_WIDTH)
             for s in row[7]]
    print(f"  testbench matrix: {len(cells)} cells in {t_matrix:.2f} s, launches {launches}")
    print(f"  {'dataset':20s} {'solver':24s} {'mean err deg':>12s} {'JAX docs':>9s} "
          f"{'std deg':>9s} {'runtime s':>9s} {'pose s':>8s}")
    table = {}
    for ds, cfg in cells:
        key = ("Mean Angular Error [deg]", ds, cfg)
        err = got.get(key, float("nan"))
        table[f"{ds}/{cfg}"] = {
            "mean_angular_error_deg": err, "jax_docs_deg": ref.get(key),
            "std_angular_error_deg": got.get(("Std Angular Error [deg]", ds, cfg)),
            "mean_position_error": got.get(("Mean Position Error", ds, cfg)),
            "runtime_s": got.get(("Mean Runtime [s]", ds, cfg)),
            "pose_runtime_s": got.get(("Mean Pose Runtime [s]", ds, cfg))}
        t = table[f"{ds}/{cfg}"]
        print(f"  {ds:20s} {cfg:24s} {err:12.6f} {ref.get(key, float('nan')):9.6f} "
              f"{t['std_angular_error_deg'] or float('nan'):9.6f} "
              f"{t['runtime_s'] or float('nan'):9.3f} {t['pose_runtime_s'] or float('nan'):8.3f}")
    # where a run's time goes: the phases of every run's time_measurements.txt
    from orthosfm_torch.io import timing

    phases = {"init": 0.0, "track_building": 0.0, "pose_estimation": 0.0, "total": 0.0}
    for run_dir in sorted(os.listdir(proj)):
        path = os.path.join(proj, run_dir, "time_measurements.txt")
        if os.path.isfile(path):
            m = timing.load_runtimes(path)
            for key, v in zip(phases, (m.init_time, m.track_building_time,
                                       m.pose_estimation_time, m.total_time)):
                phases[key] += v
    print("  the matrix's runs, summed over their time_measurements.txt: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    missing = [c for c in cells if ("Mean Angular Error [deg]", *c) not in got]
    if missing:
        print("\n".join("  | " + ln for ln in lines[-40:]))
    require(not missing, f"testbench: cells missing from results.csv: {missing}")
    worst = max(t["mean_angular_error_deg"] for t in table.values())
    require(worst < TESTBENCH_LIMIT_DEG, f"testbench: a cell's mean angular error is {worst}")
    for name in (*UNSHARDED_BA, "top2"):
        require(launches[name] > 0, f"{name} was not launched on the testbench's path")

    t0 = time.perf_counter()
    sweep = synthetic_tests.run_noise_sweep(noise_levels=tuple(SWEEP_LIMITS_DEG), verbose=False,
                                            device=device)
    t_sweep = time.perf_counter() - t0
    ref_sweep = read_sweep_csv(os.path.join(here, "docs", "synthetic_results_r5.csv"))
    print(f"  noise sweep: {len(sweep)} entries in {t_sweep:.2f} s")
    for e in sweep:
        jax_deg = ref_sweep.get((e.dataset, e.solver, e.noise_px), float("nan"))
        print(f"  {e.dataset:8s} {e.solver:20s} sigma {e.noise_px:5.1f} px: "
              f"{e.mean_angular_error_deg:.6g} deg (limit {SWEEP_LIMITS_DEG[e.noise_px]}; JAX "
              f"docs {jax_deg:.6g}), std {e.std_angular_error_deg:.6g}, failed {e.failed}")
        require(not e.failed and e.mean_angular_error_deg < SWEEP_LIMITS_DEG[e.noise_px],
                f"noise sweep {e}")

    t0 = time.perf_counter()
    bench = bench_pipeline.run_benchmark(BENCH_VIEWS, BENCH_WIDTH, device=device)
    print(f"  bench_pipeline ({time.perf_counter() - t0:.2f} s with its warm-up run):")
    print("  " + json.dumps(bench))
    require(bench["views_placed"] == BENCH_VIEWS, f"bench_pipeline placed {bench['views_placed']}")
    return launches, {"matrix_s": t_matrix, "run_phases_s": phases, "cells": table,
                      "sweep_s": t_sweep,
                      "sweep": [dataclasses.asdict(e) for e in sweep], "bench_pipeline": bench}


def run_homography(device, features):
    """Phase 7: reconstruct with the homography engine at 10000 hypotheses,
    then RANSAC-H timed on phase 5's real candidate pairs."""
    import torch

    from orthosfm_torch.config import ReconstructionConfig, SolverType
    from orthosfm_torch.io import project as project_io
    from orthosfm_torch.pipeline import matching as matching_mod
    from orthosfm_torch.pipeline.reconstruct import reconstruct
    from orthosfm_torch.testbench import metrics, render

    with tempfile.TemporaryDirectory() as tmp:
        images, proj = os.path.join(tmp, "images"), os.path.join(tmp, "project")
        gt = render.make_image_dataset(images, num_views=5, width=224, height=224, seed=3,
                                       ring_degrees=100, device=device)
        project_io.create_project(proj)
        base = ReconstructionConfig(project_folder=proj, image_folder=images,
                                    solver=SolverType.ORTHO_QUATERNION)
        cfg = dataclasses.replace(base, matching=dataclasses.replace(
            base.matching, pair_verification="homography"))
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res, _ = reconstruct(cfg, verbose=True, device=device)
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t0
    ang, _ = metrics.pose_errors(res.cameras, gt)
    pairs = [ln.strip() for ln in log.getvalue().splitlines() if ln.startswith("Pair (")]
    print(f"  reconstruct (homography, {cfg.matching.homography_iterations} hypotheses, 5 x "
          f"224^2): {t_rec:.2f} s, views placed {int(res.present.sum())}/5, angular error mean "
          f"{float(np.mean(ang)):.4f} max {float(np.max(ang)):.4f} deg (limit "
          f"{HOMOGRAPHY_LIMIT_DEG}); pairs: {pairs}")
    require(bool(res.present.all()), "homography engine: a view was not placed")
    require(float(np.max(ang)) < HOMOGRAPHY_LIMIT_DEG, f"homography engine: {np.max(ang)}")

    # the pipeline's RANSAC-H stage on phase 5's real candidates (16 views
    # of 2048^2): host copies in, the chunked device work, the pull back
    front = ReconstructionConfig()
    front = dataclasses.replace(front, matching=dataclasses.replace(
        front.matching, pair_verification="homography"))
    m = front.matching
    cands = matching_mod.candidate_pairs(features, front, verbose=False)
    P = len(cands)
    M = max(len(c[2]) for c in cands)
    chunk = max(1, matching_mod.RANSAC_H_BLOCK_ELEMS // (m.homography_iterations * M))
    nums, _ = matching_mod._verify_homography(cands, features, front, device)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        matching_mod._verify_homography(cands, features, front, device)
        walls.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.mean(walls))
    block_gb = 4.0 * min(chunk, P) * m.homography_iterations * M / 1e9
    print(f"  RANSAC-H stage (pipeline.matching._verify_homography) on phase 5's candidates: "
          f"{P} pairs, M {M}, chunk {chunk} ({-(-P // chunk)} calls, one (chunk, "
          f"{m.homography_iterations}, M) block {block_gb:.3f} GB), wall {ms:.2f} ms (mean of "
          f"3: {[round(1e3 * w, 3) for w in walls]}); inliers {nums.tolist()}; pairs over "
          f"{m.homography_min_inliers}: {int((nums >= m.homography_min_inliers).sum())}")
    return {"reconstruct_s": t_rec, "max_angular_error_deg": float(np.max(ang)),
            "mean_angular_error_deg": float(np.mean(ang)),
            "ransac_h_real_pairs": {"pairs": P, "M": M, "chunk": chunk, "wall_ms": ms,
                                    "inliers": nums.tolist()}}


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def tk_group(device):
    """A TK problem of phase 3's scene: the first 3 views of the 16-view
    blob (7800 tracks), and its draws' seed."""
    import torch

    from orthosfm_torch.data import synthetic

    ds = synthetic.generate_dataset(synthetic.blob_cloud(7800), num_views=N_VIEWS, seed=0,
                                    width=int(WIDTH), height=int(WIDTH), device=device)
    cols = torch.arange(3, device=device)
    obs = ds.tracks.obs[:, cols].contiguous()
    valid = ds.tracks.alive & torch.all(ds.tracks.obs_mask[:, cols], dim=1)
    return obs, valid, 0


def run_sharded(device, features, cfg):
    """Phase 8, the slice's main path: the sharded BA, TK and matching on a
    process group of one rank over NCCL, each bit for bit against one
    device (whose runs come first and do not count), with the launch counts
    of every kernel over the sharded runs; then two ranks on this card over
    gloo and --devices past the cards present."""
    import torch
    import torch.distributed as dist

    from orthosfm_torch.config import BundleAdjustConfig, RansacConfig
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.parallel import ba_sharded, mesh as mesh_mod, tk_sharded
    from orthosfm_torch.pipeline import matching as pipe
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.solvers import tomasi_kanade as tk
    from orthosfm_torch.testbench.problems import make_problem

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    problems = []
    for num_views, n_tracks, iterations in SHARDED_BA_SHAPES:
        args = make_problem("quat", device, num_views, n_tracks, WIDTH)
        bcfg = BundleAdjustConfig(max_iterations=iterations, function_tolerance=0.0,
                                  min_lambda=1e-12)
        ref, t_ref = timed(lambda: ba.run(*args, True, bcfg))
        problems.append((f"{num_views}x{n_tracks}", args, bcfg, ref, t_ref))
    obs, valid, seed = tk_group(device)
    rcfg = RansacConfig()
    tk_ref = tk.robust_factorization(obs, valid, WIDTH, WIDTH, rcfg,
                                     generator=torch.Generator(device).manual_seed(seed))
    m_ref = pipe.match_all_pairs(features, cfg, verbose=False)

    mesh = mesh_mod.init_distributed(f"tcp://localhost:{free_port()}", 1, 0, "nccl")
    try:
        mesh.all_reduce(torch.zeros(1, device=device))  # NCCL's communicator, set up once
        torch.cuda.synchronize()
        bk.reset_launch_counts()
        mk.top2.launches = 0
        sharded = []
        for label, args, bcfg, ref, t_ref in problems:
            padded, _ = ba_sharded.pad_tracks(list(args[1:]), mesh.size)
            shards = ba_sharded.shard_track_arrays(mesh, padded)
            run = ba_sharded.make_sharded_ba(mesh, True, bcfg)
            res, t_sh = timed(lambda: run(args[0], *shards))
            sharded.append((label, res, t_sh))
        tk_res = tk_sharded.make_sharded_tk(mesh, rcfg)(
            obs, valid, WIDTH, WIDTH, generator=torch.Generator(device).manual_seed(seed))
        m_sh = pipe.match_all_pairs(features, cfg, verbose=False, mesh=mesh)
        torch.cuda.synchronize()
        launches = {**bk.launch_counts(), "top2": mk.top2.launches}
        routes = bk.route_launches()
    finally:
        dist.destroy_process_group()
    launches["camera_solve_grid"] = routes["grid"]
    print(f"  launches {launches}, camera_solve by route {routes}")
    out = {"launches": launches, "camera_solve_routes": routes, "ba": {}}
    for (label, _, bcfg, ref, t_ref), (_, res, t_sh) in zip(problems, sharded):
        same = (torch.equal(res.cams.rot, ref.cams.rot) and torch.equal(res.points, ref.points)
                and float(res.cost) == float(ref.cost))
        print(f"  sharded BA {label}, {bcfg.max_iterations} iterations: {t_sh * 1e3:.2f} ms "
              f"({t_sh * 1e3 / bcfg.max_iterations:.2f} ms/it) against ba.run's "
              f"{t_ref * 1e3:.2f} ms; cost {float(res.cost):.6e}, bit for bit: {same}")
        require(same, f"sharded BA {label} at world size 1 is not ba.run's bits")
        out["ba"][label] = {"sharded_ms_per_it": t_sh * 1e3 / bcfg.max_iterations,
                            "ba_run_ms_per_it": t_ref * 1e3 / bcfg.max_iterations,
                            "cost": float(res.cost), "initial_cost": float(res.initial_cost)}
    same_tk = (bool(tk_res.found) == bool(tk_ref.found)
               and int(tk_res.num_inliers) == int(tk_ref.num_inliers)
               and torch.equal(tk_res.model1, tk_ref.model1)
               and torch.equal(tk_res.model2, tk_ref.model2))
    same_m = [(i, j) for i, j, _, _ in m_sh] == [(i, j) for i, j, _, _ in m_ref] and all(
        np.array_equal(a, c) and np.array_equal(b, d)
        for (_, _, a, b), (_, _, c, d) in zip(m_sh, m_ref))
    print(f"  sharded TK ({int(tk_res.num_inliers)} inliers) bit for bit: {same_tk}; sharded "
          f"matching ({len(m_sh)} pairs) identical: {same_m}")
    require(same_tk and same_m, "sharded TK or matching differs from one device")
    for name in (*BA_KERNELS, "camera_solve_grid", "top2"):
        require(launches[name] > 0, f"{name} was not launched on the sharded path")
    out["gloo"] = gloo_ranks(problems[0])
    out["devices_past_cards"] = devices_past_cards()
    return out


def gloo_ranks(problem):
    """Two ranks on this card over gloo, each a process of its own running
    this script with --gloo-rank: the sharded BA of `problem` (the
    make_problem() shape), against one device's ba.run (the same optimum:
    the two ranks sum in another order), where gloo takes CUDA tensors for
    all_reduce and all_gather; else what it said."""
    import torch

    from orthosfm_torch.core import quaternions as quat

    label, _, bcfg, ref, _ = problem
    port = free_port()
    with tempfile.TemporaryDirectory() as work:
        procs, logs = [], []
        for rank in range(2):
            logs.append(open(os.path.join(work, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--gloo-rank", str(rank), "--port",
                 str(port), "--out", work], stdout=logs[-1], stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(300 - (time.perf_counter() - t0), 1))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        texts = [open(os.path.join(work, f"rank{r}.log")).read() for r in range(2)]
        for rank, p in enumerate(procs):
            require(p.returncode == 0, f"gloo rank {rank} failed:\n{texts[rank][-3000:]}")
        results = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(2)]
    if not results[0]["gloo_cuda"]:
        print(f"  two gloo ranks on one card: gloo does not take CUDA tensors here: "
              f"{results[0]['error']}")
        return results[0]
    rots = [torch.tensor(r["rot"], device=ref.cams.rot.device) for r in results]
    dots = (quat.normalize(rots[0]) * quat.normalize(ref.cams.rot)).sum(-1).abs()
    err = float((dots - 1).abs().max())
    agree = results[0]["rot"] == results[1]["rot"]
    print(f"  two gloo ranks on one card, sharded BA {label}: {results[0]['ms_per_it']:.2f} ms/it, "
          f"cost {results[0]['cost']:.6e} (one device {float(ref.cost):.6e}), quaternions "
          f"within {err:.2e} of one device's, ranks agree: {agree}")
    require(agree, "the gloo ranks disagree")
    require(err < 1e-4 and results[0]["cost"] < results[0]["initial_cost"] * 1e-2,
            "the gloo ranks' BA is not one device's")
    return {**results[0], "quat_dot_err": err}


def gloo_rank(rank, port, out):
    """One of gloo_ranks' two processes: rank `rank` on cuda:0."""
    import torch
    import torch.distributed as dist

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.parallel import ba_sharded, mesh as mesh_mod
    from orthosfm_torch.testbench.problems import make_problem

    device = torch.device("cuda:0")
    mesh = mesh_mod.init_distributed(f"tcp://localhost:{port}", 2, rank, "gloo", device=device)
    try:
        try:
            x = mesh.all_reduce(torch.ones(4, device=device))
            g = mesh.all_gather(torch.full((2,), float(rank), device=device))
            torch.cuda.synchronize()
            ok = x.tolist() == [2.0] * 4 and g.tolist() == [0.0, 0.0, 1.0, 1.0]
            result = {"gloo_cuda": ok, "error": "" if ok else f"wrong sums {x} {g}"}
        except (RuntimeError, ValueError) as e:
            result = {"gloo_cuda": False, "error": repr(e)}
        if result["gloo_cuda"]:
            num_views, n_tracks, iterations = GLOO_SHAPE
            cams, points, obs, mask = make_problem("quat", device, num_views, n_tracks, WIDTH)
            bcfg = BundleAdjustConfig(max_iterations=iterations, function_tolerance=0.0,
                                      min_lambda=1e-12)
            padded, _ = ba_sharded.pad_tracks([points, obs, mask], mesh.size)
            shards = ba_sharded.shard_track_arrays(mesh, padded)
            run = ba_sharded.make_sharded_ba(mesh, True, bcfg)
            run(cams, *shards)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(cams, *shards)
            torch.cuda.synchronize()
            result.update(ms_per_it=(time.perf_counter() - t0) * 1e3 / iterations,
                          cost=float(res.cost), initial_cost=float(res.initial_cost),
                          rot=res.cams.rot.tolist())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def devices_past_cards():
    """The CLI's --devices past the cards present raises before it writes
    anything."""
    import torch

    from orthosfm_torch import app

    n = torch.cuda.device_count() + 1
    with tempfile.TemporaryDirectory() as d:
        images, proj = os.path.join(d, "images"), os.path.join(d, "proj")
        os.makedirs(images)
        try:
            app.main([proj, images, "--devices", str(n)])
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        wrote = os.path.exists(proj)
    print(f"  --devices {n} on {n - 1} card(s): raised {raised!r}")
    require(raised and not wrote, f"--devices {n} did not raise before writing")
    return raised


def main() -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="Smoke check of the PyTorch + CUDA port on one GPU")
    p.add_argument("--parent", default="",
                   help="a checkout of the parent commit: time top2 against it in turns")
    p.add_argument("--gloo-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.gloo_rank is not None:  # one of phase 8's two gloo ranks
        return gloo_rank(args.gloo_rank, args.port, args.out)
    device = torch.device("cuda:0")
    t_all = time.perf_counter()

    from orthosfm_torch import kernel_build
    from orthosfm_torch.io import tracks_io
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.pipeline import tracks_build
    from orthosfm_torch.solvers import ba_kernels as bk

    print("== phase 1: card and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = (bk.SOURCE, mk.SOURCE, tracks_build.SOURCE, tracks_io.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(kernel_build.build, sources))
    for lib in (bk.library, mk.library, tracks_build.library, tracks_io.library):
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
    launches_slice = dict(launches)
    slice_ba = recorder.summary()
    print(f"  launches {launches}")
    require(launches["lm_accept"] == 0, f"K4 launched on the unsharded path: {launches}")
    print(f"  BA: {slice_ba['ba_calls']} calls, {slice_ba['iterations_worked']} of "
          f"{slice_ba['iterations_launched']} iterations did work; host enqueue "
          f"{slice_ba['enqueue_ms_per_it']:.4f} ms per iteration")
    for name in UNSHARDED_BA:
        require(launches[name] > 0, f"{name} was not launched on the main path")
    print(f"  phase 3 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 4: BA iterations/s (quat)")
    t0 = time.perf_counter()
    rates = {}
    for num_views, n_tracks in BA_SHAPES:
        print(f"  {num_views} views x {n_tracks} tracks")
        r = ba_rate(device, num_views, n_tracks)
        rates[f"{num_views}x{n_tracks}"] = r
        print(f"  kernel path {r['kernel']:.1f} it/s, plain torch path {r['torch']:.1f} it/s")
    for num_views, n_tracks in BA_RUN_SHAPES_MANY:
        print(f"  {num_views} views x {n_tracks} tracks, {BA_RUN_ITERATIONS_MANY} iterations "
              "(past shared memory)")
        r = ba_rate(device, num_views, n_tracks, BA_RUN_ITERATIONS_MANY)
        rates[f"{num_views}x{n_tracks}"] = r
        print(f"  kernel path {r['kernel']:.2f} it/s ({1e3 / r['kernel']:.1f} ms/it), plain "
              f"torch path {r['torch']:.2f} it/s ({1e3 / r['torch']:.1f} ms/it)")
        # which stage sets each route's pace there
        r["stages"] = time_ba_kernels(stage_inputs("quat", device, num_views, n_tracks))
        for name in UNSHARDED_BA:
            t = r["stages"][name]
            lib = "" if t["library_ms"] is None else f", solve_ex {t['library_ms']:.3f} ms"
            print(f"    {name:18s} kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms{lib}")
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
    require(all(front_ba[name] > 0 for name in UNSHARDED_BA),
            "a BA kernel was not launched in phase 5")
    err, rel, real_times = check_top2_real(device, features, cfg)
    errs["top2"], rels["top2"] = max(errs["top2"], err), max(rels["top2"], rel)
    times["top2"] = real_times["top2_sift"]
    print(f"  phase 5 wall time {time.perf_counter() - t0:.2f} s")

    print(f"== phase 6: the testbench on the card (dataset matrix at {TESTBENCH_WIDTH}, noise "
          "sweep, pipeline bench)")
    t0 = time.perf_counter()
    phase_launches = {"phase3": launches_slice, "phase5": {**front_ba, "top2": launches["top2"]}}
    with tempfile.TemporaryDirectory() as root:
        phase_launches["phase6"], testbench = run_testbench(device, root)
    print(f"  phase 6 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 7: RANSAC-H (pair_verification=\"homography\")")
    t0 = time.perf_counter()
    homography = run_homography(device, features)
    print(f"  phase 7 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 8: the multi-device path (parallel/) on one rank over NCCL, two over gloo")
    t0 = time.perf_counter()
    sharded = run_sharded(device, features, cfg)
    phase_launches["phase8"] = sharded["launches"]
    print(f"  phase 8 wall time {time.perf_counter() - t0:.2f} s")
    if args.parent:
        print(f"== top2 in turns against {args.parent}")
        real_times["turns"] = top2_turns(args.parent)
    print(f"total wall time {time.perf_counter() - t_all:.2f} s")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches: the slice's main path, phase 8 (the sharded BA, TK and
    # matching); each earlier phase's are in launches_by_phase
    main_path = phase_launches["phase8"]
    kernels = [{"name": name, "route": "cuda", "source": SOURCE_OF[name],
                "replaces": REPLACES[name], "launches": main_path[name],
                "max_abs_err": errs[name], "max_rel_err": rels[name],
                **{k: times[name][k] for k in keys}}
               for name in REPLACES]
    for k in kernels:
        if k["name"] == "camera_solve":
            k["routes"] = sharded["camera_solve_routes"]
        if k["name"] == "lm_accept":
            k["tail_ms"] = times["lm_accept"]["tail_ms"]
    print(json.dumps({"kernels": kernels, "launches_by_phase": phase_launches,
                      "ba_shapes": shapes, "ba_iter_per_s": rates,
                      "ba_main_path": {"phase3": slice_ba, "phase5": front_iters},
                      "top2_ms": {**top2_times, **real_times}, "testbench": testbench,
                      "homography": homography, "sharded": sharded}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
