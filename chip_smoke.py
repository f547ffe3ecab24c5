#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (orthosfm_torch) on one GPU.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit, and the build of the native sources
     of orthosfm_torch/csrc/ (the BA kernels, the top-2 matching kernel, the
     TK kernels, the outlier filter's kernel, the union-find and the
     tracks.txt reader), one compiler
     each, all started together;
  2. each kernel against its plain PyTorch version on the card: the BA
     kernels (schur_assemble, camera_solve, and point_update_cost with the
     accept rule of lm_accept in its last CTA, held against
     point_update_cost_ref then lm_accept_ref, for a step accepted and one
     rejected) at the shapes of the standard BA problem (16 views x 8192
     sphere tracks, 2048^2, cameras perturbed by up to 1 degree), for
     quaternion and Euler cameras, with points optimized and fixed; each
     also at 3 views x 7800 tracks (the local BA) and 64 x 4096, and at
     phase 9's shapes, 3 and 64 views x 50 000 tracks (its local and global
     BAs; K1 splits its sum over the tracks at 64 views), with points
     optimized and fixed, and timed at all five beside its plain version,
     its bound and, for camera_solve, torch.linalg.solve_ex alone on the
     same prepared system, and point_update_cost also without its tail
     (the difference is the time the accept rule adds, lm_accept's row);
     the kernels line gives phase 9's two shapes' times as
     main_path_shapes; at 1100 views x 300 tracks,
     where K1 and K2 read their per-view tables from global memory (past
     shared memory), K1 and K2 checked the same way and all three timed
     (K3 there runs its cluster from a global scratch); top2 (both
     directions from one launch) on random unit descriptors, 8 pairs x
     8192 rows x 128 and x 64, with duplicated rows (exact ties), repeated
     views and databases
     of 0 and 1 valid rows, against its plain version, a second run and
     the swapped pair table (bit for bit), timed beside its plain version,
     with the host's time a call; then lm_fused, the whole LM solve in one
     cooperative launch (ba.run's route up to FUSED_MAX_VIEWS views; from
     38 views in clusters of 8 CTAs, its camera solve on the first; from
     the crossover, GRID_MIN_V in the CUDA source, its camera solve K3's
     grid route on every CTA), against the per-iteration kernels bit for
     bit (cameras, points, cost, initial cost, iterations) at 3 x 7800,
     16 x 8192, 3 x 50 000, 37 x 2048, 38 x 2048, 64 x 4096, 119 x 1024,
     64 x 50 000, 120 x 1024, 128 x 1024, 192 x 4096 (phase 11's shape) and
     FUSED_MAX_VIEWS x 2000, both camera kinds, points optimized and fixed,
     camera 0 fixed, with the main path's BA config and in a run with
     rejected steps; against lm_solve_ref (one iteration at the JAX
     package's tolerances for its fused kernel, and to convergence), and
     all three timed to convergence at each shape, with the ms of a working
     iteration of lm_fused and of the per-iteration kernels;
  3. pose estimation from tracks (run_pose_estimation with the kernels) on
     the 16-view 2048^2 blob scene (7800 tracks), solvers 0 and 3,
     noise-free (mean angular error < 0.01 deg) and with sigma = 1 px pixel
     noise (< 0.25 deg), with the launch counts of the BA kernels over this
     phase (one lm_fused launch a BA, no per-iteration kernel), the LM
     iterations run by route, and the port's writers producing cameras.txt,
     sparse_cloud.ply, tracks.txt and time_measurements.txt;
  4. the BA bench (orthosfm_torch/bench.py, the JAX system's bench.py) on
     the standard problem: its JSON line, with vs_baseline (the same solver
     on the host CPU, one repeat of 2 calls), every repeat's rates, and
     the checks that every route ran 30 iterations, that value lies at or
     under the device bound (30 over one 30-iteration lm_fused solve's
     device time, by CUDA events), and that the "auto" calls launched
     lm_fused only and the "pallas" calls K1, K3 and K2 only; then BA
     iterations/s of the fused route, the per-iteration kernels and the
     plain PyTorch path on a 64-view problem (64 x 4096 tracks), 30
     iterations each, in turns, and the host's time per iteration;
  5. the image front end at reference scale: 16 sphere views of 2048^2
     rendered on the card (seed 7, a 200 degree ring), then SIFT + SURF,
     pair matching through top2, RANSAC-F, union-find tracks and pose
     estimation (quaternion solver, kernels on), with the time of each
     stage, the counts of features, pairs and tracks, and the launch counts
     of top2 and the BA kernels over this phase (one lm_fused a BA); every
     view must be placed with a mean angular
     error < 1 deg. Then top2 against its plain version on the real SIFT and
     SURF stacks of this run, both directions, with the cross-checked match
     counts per pair, timed beside the plain version and torch.bmm of the
     gathered stacks (the product alone);
  6. the testbench on the card: testbench.run.main with --generate
     --solvers all --repetitions 1 at width 320, the whole dataset_matrix
     (10 rendered datasets, 21 (dataset, solver) cells, in process), every
     cell's mean angular error < 1 deg, printed beside the JAX package's
     docs/results.csv, with the launch counts of lm_fused (one a BA) and
     top2 over the run (the testbench's path); then
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
     one rank over NCCL: the sharded BA (K1 on the
     shard, one all_reduce of S, dU and rhs, K3, K2 in split mode, the
     all_reduce of the cost, K4 lm_accept) on make_problem() and on
     2000 views x 2000 tracks (K3 by its grid route), the sharded TK and
     match_all_pairs(mesh=) on phase 5's features, each bit for bit against
     one device, with the launch counts of every kernel over this phase
     (lm_accept's and K3's grid route's counts in the kernels line), and
     the JAX package's multi-device dry run (parallel/dryrun.py: 6 views of
     224^2 from images through the sharded matching and pose estimation);
     then two ranks on the one card over gloo (the sharded BA against one
     device), where gloo takes CUDA tensors, and the CLI's --devices past
     the cards present, which must raise;
  9. the many-view reconstruction, the main path of the kernels line
     (testbench/scale_demo.py, the JAX package's scripts/scale_demo.py):
     64 views x 50 000 blob tracks at 1 px through run_pose_estimation
     with the kernels (62 local BAs of 3 views and 21 global BAs over all
     64 cameras, one lm_fused launch each, the global ones on its cluster
     route, and no launch of K1, K3 or K2), every view placed with a mean
     angular error < 0.05 deg and a max < 0.1 deg, with the launches of
     lm_fused, K1, K3 (by route) and K2, the BAs run by route and their
     LM iterations, TK's peak device memory and the share of each stage;
     then profile_matching at 16 x 2048^2 (the front end's stage table,
     top2's launches). Its counts are the kernels line's launches of
     lm_fused and top2; K1, K3 and K2, which this path runs only inside
     lm_fused, give phase 8's, where the sharded BA launches them, and so
     does K3's grid route, which phase 11 runs only inside lm_fused
     (launches_phase names the phase of each kernel's count);
 10. the single-device entry point (orthosfm_torch/entry.py, the JAX
     system's __graft_entry__.entry()): fn(*example_args) twice on the card
     (16 views x 2048 tracks, 5 iterations), bit for bit, one lm_fused
     launch a call and no K1, K3 or K2, held against the same fn on the
     plain route (impl="torch") on the card at the tolerances of lm_fused
     against its plain version, each call timed to a synchronize;
 11. the main path past 119 views: testbench/scale_demo.py at 192 views x
     4096 blob tracks, 1 px, through run_pose_estimation with the kernels:
     every BA one lm_fused launch (254 of them; PR 12 ran 190 so and its
     64 global BAs over all 192 cameras an iteration at a time), those of
     GRID_MIN_V views or more with K3's grid route inside the launch, no
     launch of K1, K3 or K2, and the LM iterations launched equal to those
     that worked; 192/192 views placed at a mean angular error under
     0.25 deg (the repo's bar at 1 px), with the global-BA stage time
     beside PR 12's 1.150 s, and the BAs and their working iterations by
     route.

 12. the Tomasi-Kanade initialization's kernels (orthosfm_torch/csrc/
     tk_kernels.cu: K5 tk_factorize, every hypothesis's factorization,
     metric upgrade and validity in one launch; K6 tk_score, every
     hypothesis's triangulation and consensus score in one launch) against
     their plain versions at phase 11's group shape (241 hypotheses x 4096
     tracks) and phase 9's (x 50 000), K5 also as the fallback over every
     valid track, each timed beside its plain version and bound; a whole
     robust_factorization timed, and run under torch's sync debug mode
     ("error": a call that waits on the card raises) through K5 twice and
     K6 once; then TK per group (the pose/tk stage over the groups) of
     phases 5, 9 and 11 beside the plain TK route's earlier runs on an
     H100 80GB HBM3 at 700 W. Phases 3, 5, 6, 8, 9
     and 11 require TK on the kernels (K6 once a group, K5 twice), and the
     kernels line gives their launches by phase.
 13. the outlier filter's neighbour search (orthosfm_torch/csrc/
     outlier_kernels.cu: outlier_nn, one launch a filter call) against its
     plain version (the chunked PyTorch sweep) at phase 3's track count
     (7800) and phase 9's (50 000), blob points with every 13th track
     without a point: bit for bit, timed by CUDA events (a call: its
     squared norms, its scratch's zero fill and the kernel) beside the plain
     sweep and its bound, with each route's peak device memory. Phases 3,
     6, 9 and 11 require one launch a filter_outlier_tracks call (20 a
     64-view run in phase 9), and the kernels line gives its launches and
     the filter's calls by phase and ptxas's registers and spills.

Phase 2 also runs K3's grid route at 128, 192 (phase 11's shape, n =
1152: the kernels line's times for the grid route), 700, 1100 and 2000
views (n = 4200, 6600, 12000) and the cluster against it at the
crossover (GRID_MIN_V), beside the library's Cholesky (cholesky_ex + cholesky_solve,
the kernels line's library_ms for the grid route) and
torch.linalg.solve_ex, held to an f64 solve (no further from it than
twice the plain f32 LU is), with its bound (its 3xTF32 products on the
tensor cores), its three floors (f32 FMA, 3xTF32, the panels' bytes) and
its kernel launches a solve (at most 10); phase 4 also runs ba.run both ways at
700, 1100 and 2000 views x 2000 tracks, 10 iterations, with each stage's
time there.

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
TK_SOURCE = "orthosfm_torch/csrc/tk_kernels.cu"
OUTLIER_SOURCE = "orthosfm_torch/csrc/outlier_kernels.cu"
REPLACES = {
    "lm_fused": "orthosfm_tpu/solvers/ba_fused.py:545",
    "schur_assemble": "orthosfm_tpu/solvers/ba_pallas.py:394",
    "camera_solve": "orthosfm_tpu/solvers/ba_fused.py:545",
    "camera_solve_grid": "orthosfm_tpu/solvers/ba_fused.py:545",
    "point_update_cost": "orthosfm_tpu/solvers/ba_pallas.py:447",
    "lm_accept": "orthosfm_tpu/solvers/ba_fused.py:545",
    "top2": "orthosfm_tpu/ops/matching_pallas.py:87",
}
# The TK kernels port no Pallas kernel: the JAX package runs TK as one
# jitted program (tomasi_kanade.py:193), whose functions they replace
TK_REPLACES = {
    "tk_factorize": "orthosfm_tpu/solvers/tomasi_kanade.py:49",
    "tk_score": "orthosfm_tpu/solvers/tomasi_kanade.py:112",
}
SOURCE_OF = {name: BA_SOURCE for name in REPLACES}
SOURCE_OF["top2"] = MATCH_SOURCE
SOURCE_OF.update(dict.fromkeys(TK_REPLACES, TK_SOURCE))
# Nor does the outlier filter's neighbour search: the JAX package's
# nearest_neighbor_distances is an XLA program
OUTLIER_REPLACES = {"outlier_nn": "orthosfm_tpu/ops/outliers.py:24"}
SOURCE_OF["outlier_nn"] = OUTLIER_SOURCE
BA_KERNELS = ("schur_assemble", "camera_solve", "point_update_cost", "lm_accept")
# The unsharded BA (ba.run, phases 3 to 7, 9 and 11) launches lm_fused once
# a BA of up to FUSED_MAX_VIEWS views (every BA of those phases), and K1, K3
# and K2 an iteration for larger ones (phase 4's 700 to 2000 views); K4
# lm_accept's rule runs there in K2's last CTA (and in lm_fused), and as a
# launch of its own only in the sharded BA (phase 8), whose count the
# kernels line gives it, as it gives K1's, K3's (its grid route's too) and
# K2's. The kernels line's launches of lm_fused are the wrapper's,
# lm_solve.
UNSHARDED_BA = ("schur_assemble", "camera_solve", "point_update_cost")
LAUNCH_KEY = {"lm_fused": "lm_solve"}
# Phase 11: the main path past 119 views (testbench/scale_demo.py at 192
# views): its global BAs over all 192 cameras and its final BA run on
# lm_fused with K3's grid route inside the launch; the repo's bar at 1 px,
# and PR 12's global-BA stage (1.150 s, an iteration at a time) to print
# beside this run's
GRID_PATH_VIEWS, GRID_PATH_TRACKS, GRID_PATH_NOISE_PX = 192, 4096, 1.0
GRID_PATH_LIMIT_MEAN_DEG = 0.25
GRID_PATH_GLOBAL_BA_S_PR12 = 1.150
# K3's grid route (camera_solve_grid in the kernels line): phase 2 at these
# views of K3_TRACKS tracks, the kernels line's times at K3_GRID_TIMED,
# phase 11's shape (n = 1152); the crossover with the cluster (GRID_MIN_V
# in the CUDA source)
K3_GRID_VIEWS = (128, GRID_PATH_VIEWS, 700, 1100, 2000)
K3_GRID_TIMED = GRID_PATH_VIEWS
K3_CROSSOVER_VIEWS = 120
K3_TRACKS = 300
K3_GRID_MAX_LAUNCHES = 10  # a solve: grid_init, one cooperative grid_solve, grid_finish
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
# Phase 4: the bench (orthosfm_torch/bench.py) runs the standard problem;
# the routes run in turns here
BA_SHAPES = ((64, 4096),)
# Phase 9: the JAX package's many-view run (scripts/scale_demo.py, its
# docs/scale_demo.json: 64/64 views at 0.007 / 0.013 deg), held to these
# bars; then the front end's stage profile at phase 5's scale
MANY_VIEWS, MANY_TRACKS, MANY_NOISE_PX = 64, 50000, 1.0
MANY_LIMIT_MEAN_DEG, MANY_LIMIT_MAX_DEG = 0.05, 0.1
# lm_fused (the whole LM solve in one launch) against the per-iteration
# kernels, bit for bit, at the local BA (3 views) of phase 3 and of phase 9,
# the standard problem, the one-CTA camera solve's edge (37 views), the
# cluster's first (38) and 119 views, 64 x 4096, phase 9's global BA (64 x
# 50 000), past 119 views on K3's grid route inside the launch at 120 and
# 128 views, phase 11's global BA (192 x 4096) and the launch's last size
# (ba_kernels.FUSED_MAX_VIEWS x LM_FUSED_BOUND_TRACKS); and against its
# plain version after one iteration at the JAX package's tolerances for its
# fused kernel (tests/test_ba_fused.py:54-72: f32 both, other sum orders
# and another solve; the cost sits in a sharp valley)
LM_FUSED_SHAPES = ((3, 7800), (16, 8192), (3, 50000), (37, 2048), (38, 2048), (64, 4096),
                   (119, 1024), (MANY_VIEWS, MANY_TRACKS), (120, 1024), (128, 1024),
                   (GRID_PATH_VIEWS, GRID_PATH_TRACKS))
LM_FUSED_BOUND_TRACKS = 2000
# timed at those, the last size and phase 3's size (16 views x 7800 tracks)
LM_FUSED_TIMED = (*LM_FUSED_SHAPES, (N_VIEWS, 7800))
# the rejecting run: every free camera's scale 2.5 times too large (pinned,
# so no step can repair it) and lambda_0 = 1e-8, whose near Gauss-Newton
# steps overshoot, for 30 iterations at function tolerance 0, so that it
# also reaches its cost's f32 floor, where steps are rejected at every
# shape (in 10 iterations from lambda_0 alone 120 x 1024 rejected none)
LM_REJECT_SCALE, LM_REJECT_LAMBDA0, LM_REJECT_ITERATIONS = 2.5, 1e-8, 30
TOL_LM_INIT_COST_REL = 1e-5
TOL_LM_COST_REL = 1e-3
TOL_LM_ROT_REL, TOL_LM_ROT_ABS = 1e-4, 2e-6
TOL_LM_OFFSET_ABS = 1e-5
TOL_LM_POINTS_REL, TOL_LM_POINTS_ABS = 1e-3, 1e-5
# Phase 10: after entry()'s 5 iterations the cost sits at its f32 floor,
# where every residual is the rounding of a pixel coordinate below 2048
# (half an f32 ulp, 1.2e-4 px); two sum orders part by tens of percent
# there, so the cost is held to TOL_LM_COST_REL beside that floor,
# 0.5 * 2 * observations * (1.2e-4)^2, under which both must lie
ENTRY_FLOOR_PX = float(np.spacing(np.float32(WIDTH))) / 2
# K1, K3 and K2 are checked and timed at the main paths' shapes: the local
# BA of a 3-view group (n = 18) at phase 3's 7800 tracks and at phase 9's
# 50 000, the global BA (make_problem(), n = 96), and many views (n = 384)
# at 4096 tracks and at phase 9's 50 000 (the global BA there, where K1
# splits its sum over the tracks by schur_plan(V, T))
MAIN_PATH_SHAPES = ((3, MANY_TRACKS), (MANY_VIEWS, MANY_TRACKS))
BA_SHAPES_TIMED = ((3, 7800), (N_VIEWS, N_TRACKS), (64, 4096), *MAIN_PATH_SHAPES)
TOL_POINTS_ABS = 1e-5     # retracted unit points, abs
TOL_COST_REL = 1e-4       # robust cost, relative
TOL_STATE_REL = 1e-5      # LM scalar state after accept but its cost, relative
# top2: the kernel sums each dot product in one FMA chain, the plain
# version by cuBLAS's f32 GEMM in another order; d2 = 2 - 2 sim of unit
# vectors differs by a few 1e-7. Indices must agree, in both directions,
# except on rows whose best and second d2 (plain version) lie within this of
# each other.
TOL_TOP2 = 1e-5
# Phase 5: the JAX package's reference-scale run
# (testbench/bench_pipeline.py --views 16 --width 2048: profile_matching's
# scene, seed 7 on a 200 degree ring)
FRONT_VIEWS = 16
FRONT_WIDTH = 2048
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
# Phase 12: TK's kernels at the group shapes of phase 11 (4096 tracks) and
# phase 9 (50 000), 241 hypotheses of 3 views, 1 px of noise. K5 is held to
# its plain version given the plain version's RStar (models 1e-4, the
# validity heuristic equal) and its own RStar to the SVD's up to column
# signs (1e-4); K6 on K5's models: scores 1e-3 and consensus counts equal
# except tracks within TK_NEAR_PX of the 3 px threshold (f32 pixel
# coordinates near 2048 round to 1.2e-4 px; the kernel and the plain
# version may round a coordinate either way), exempted and counted as top2's
# near ties are. TK per group (the pose/tk stage over the groups) in phases
# 5, 9 and 11, printed beside the plain TK route's (its LM a host loop),
# measured by this script on an H100 80GB HBM3 at 700 W before the kernels
TK_SHAPES = (GRID_PATH_TRACKS, MANY_TRACKS)
TK_NOISE_PX = 1.0
TOL_TK_MODEL, TOL_TK_SCORE, TK_NEAR_PX = 1e-4, 1e-3, 2.5e-4
TK_EARLIER = {"phase5": "52% of 2.375 s over 14 groups, ~88 ms a group",
              "phase9": "6.012 s over 62 groups, ~97 ms a group",
              "phase11": "16.535 s over 190 groups, ~87 ms a group"}
# Phase 13: the outlier filter's neighbour search at phase 3's and phase 9's
# track counts, bit for bit with the plain sweep (it takes the sweep's
# squared norms and rounds its dots as the f32 GEMM does). The phases whose
# pose estimation must call the filter, each call one launch
OUTLIER_SHAPES = (7800, MANY_TRACKS)
OUTLIER_PHASES = ("phase3", "phase6", "phase9", "phase11")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def rel_err(a, b):
    return max_err(a, b) / max(float(b.double().abs().max()), 1e-30)


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def require_routes(launches, ba_calls, what):
    """The routes ba.run took over a phase (launches: ba_kernels'
    launch_counts(); ba_calls: its BARecorder's summary()): every BA of up to
    FUSED_MAX_VIEWS views one lm_fused launch and nothing else, every larger
    one K1, K3 and K2 for each of its max_iterations iterations, none on
    the plain route."""
    from orthosfm_torch.solvers import ba_kernels as bk

    routes = ba_calls["by_route"]
    small = sum(r["ba_calls"] for v, r in ba_calls["by_views"].items()
                if int(v) <= bk.FUSED_MAX_VIEWS)
    fused = routes.get("fused", {}).get("ba_calls", 0)
    per_it = routes.get("kernel", {"ba_calls": 0, "iterations_launched": 0})
    its = per_it["iterations_launched"]
    print(f"  {what}: {ba_calls['ba_calls']} BAs, {small} of up to {bk.FUSED_MAX_VIEWS} views; "
          f"lm_fused launches {launches['lm_solve']} ({fused} fused BAs), per-iteration BAs "
          f"{per_it['ba_calls']} ({its} iterations: K1 {launches['schur_assemble']}, K3 "
          f"{launches['camera_solve']}, K2 {launches['point_update_cost']})")
    require(small > 0 and launches["lm_solve"] == fused == small and "torch" not in routes,
            f"{what}: lm_fused launches {launches['lm_solve']} for {small} BAs of up to "
            f"{bk.FUSED_MAX_VIEWS} views ({routes})")
    require(launches["schur_assemble"] == launches["camera_solve"] == its
            and launches["point_update_cost"] == its + per_it["ba_calls"]
            and launches.get("lm_accept", 0) == 0,
            f"{what}: per-iteration launches {launches} for {per_it}")


def require_tk(launches, what):
    """TK ran through its kernels over a phase (launches: tk_kernels'
    launch_counts() form, from the wrappers' counts where TK was called
    directly, else from the profiler's kernel records, since the pose
    estimation on a card replays TK from CUDA graphs): K6 once a group and
    K5 twice (the hypotheses, then the fallback), at least one group."""
    print(f"  {what}: TK on the kernels: tk_factorize {launches['tk_factorize']}, tk_score "
          f"{launches['tk_score']} launches")
    require(launches["tk_score"] > 0 and launches["tk_factorize"] == 2 * launches["tk_score"],
            f"{what}: TK launches {launches['tk_factorize']} K5, {launches['tk_score']} K6")


@contextlib.contextmanager
def counting_outlier_filter():
    """Over the enclosed phase: the outlier filter's calls
    (outliers.filter_outlier_tracks, which the pose estimation calls through
    its module) and the launches of its neighbour-search kernel, filled in
    as the block ends."""
    from orthosfm_torch.ops import outlier_kernels as okern
    from orthosfm_torch.ops import outliers

    real = outliers.filter_outlier_tracks
    out = {"filter_calls": 0, "outlier_nn": 0}

    def counted(*args, **kwargs):
        out["filter_calls"] += 1
        return real(*args, **kwargs)

    start = okern.outlier_nn.launches
    outliers.filter_outlier_tracks = counted
    try:
        yield out
    finally:
        outliers.filter_outlier_tracks = real
        out["outlier_nn"] = okern.outlier_nn.launches - start


def require_outlier_nn(counts, what):
    """One outlier_nn launch a filter call over a phase, and in the phases
    of OUTLIER_PHASES at least one call (no call on the plain route)."""
    print(f"  {what}: outlier filter calls {counts['filter_calls']}, outlier_nn launches "
          f"{counts['outlier_nn']}")
    require(counts["outlier_nn"] == counts["filter_calls"]
            and (counts["filter_calls"] > 0 or what not in OUTLIER_PHASES),
            f"{what}: {counts['outlier_nn']} outlier_nn launches for "
            f"{counts['filter_calls']} filter calls")


def check_schur_and_solve(kind, inputs, opt, errs, rels, label):
    """K1 and K3 against their plain versions on one problem; returns the
    plain step and candidate cameras of each lambda of SOLVE_LAMBDAS."""
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import camera_step, lm_inputs

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


def check_point_update_cost(kind, inputs, opt, lam, step, errs, rels, label):
    """K2 with its accept tail against point_update_cost_ref then
    lm_accept_ref (point_update_accept_ref), for the plain step of lambda
    `lam` held to a higher previous cost (accepted: state[CUR] flips) and to
    a lower one (rejected)."""
    import torch

    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import LM_CFG_ARGS, k2_stage

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
    from orthosfm_torch.utils.kernel_bench import camera_step, k2_stage, lm_inputs, stage_inputs

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
    from orthosfm_torch.utils.kernel_bench import (camera_step, lm_inputs, stage_inputs,
                                                   time_ba_kernels)

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


def same_result(a, b):
    """Two BAResults bit for bit: cameras, points, costs, iterations."""
    import torch

    return (torch.equal(a.cams.rot, b.cams.rot) and torch.equal(a.cams.offset, b.cams.offset)
            and torch.equal(a.cams.scale, b.cams.scale) and torch.equal(a.points, b.points)
            and float(a.cost) == float(b.cost) and float(a.initial_cost) == float(b.initial_cost)
            and int(a.iterations) == int(b.iterations))


def rejecting(cams):
    """Every free camera's scale LM_REJECT_SCALE times too large (scale is
    pinned, so no step repairs it): from LM_REJECT_LAMBDA0 some LM steps are
    rejected (check_lm_fused counts them)."""
    scale = cams.scale.clone()
    scale[1:] *= LM_REJECT_SCALE
    return cams.replace(scale=scale)


def check_lm_fused(device):
    """lm_fused (ba.run's fused route) against the per-iteration kernels,
    bit for bit (cameras, points, cost, initial cost, iterations) at
    LM_FUSED_SHAPES, both camera kinds, points optimized and fixed (camera 0
    fixed, as make_problem fixes it), with the main path's BA config and in
    a run with rejected steps; against lm_solve_ref at each shape: one
    iteration to the JAX package's tolerances for its fused kernel
    (TOL_LM_*), and the main path's config converging like it; then all
    three timed at LM_FUSED_TIMED (kernel_bench.time_lm_solve); both lists
    end with the launch's last size (FUSED_MAX_VIEWS views). Returns
    (max abs error of the one-iteration cameras and points, max relative
    error of its cost, {shape: times}, {shape: bit-for-bit cases})."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench.problems import make_problem
    from orthosfm_torch.utils.kernel_bench import time_lm_solve

    cfg = BundleAdjustConfig()
    reject_cfg = dataclasses.replace(cfg, initial_lambda=LM_REJECT_LAMBDA0,
                                     max_iterations=LM_REJECT_ITERATIONS, function_tolerance=0.0)
    err, rel, times, cases = 0.0, 0.0, {}, {}
    last = (bk.FUSED_MAX_VIEWS, LM_FUSED_BOUND_TRACKS)
    for num_views, n_tracks in (*LM_FUSED_SHAPES, last):
        label = f"{num_views}x{n_tracks}"
        cases[label] = []
        for kind in ("quat", "euler"):
            cams, points, obs, mask = make_problem(kind, device, num_views, n_tracks, WIDTH)
            runs = [(opt, cams, cfg, "") for opt in (True, False)]
            runs.append((True, rejecting(cams), reject_cfg, " with rejected steps"))
            for opt, c, config, note in runs:
                bk.reset_launch_counts()
                r_f = ba.run(c, points, obs, mask, opt, dataclasses.replace(config, impl="fused"))
                launched = bk.launch_counts()
                r_k = ba.run(c, points, obs, mask, opt, dataclasses.replace(config, impl="kernel"))
                same = same_result(r_f, r_k)
                cases[label].append({"kind": kind, "opt": opt, "rejecting": bool(note),
                                     "iterations": int(r_f.iterations), "bit_for_bit": same})
                print(f"  lm_fused {label} {kind:5s} opt={opt!s:5s}{note}: {int(r_f.iterations)} "
                      f"iterations, cost {float(r_f.initial_cost):.6g} -> {float(r_f.cost):.6g}; "
                      f"bit for bit with the per-iteration kernels: {same}")
                require(same, f"lm_fused {label} {kind} opt={opt}{note}: not the per-iteration "
                        f"kernels' bits ({float(r_f.cost)} / {float(r_k.cost)}, "
                        f"{int(r_f.iterations)} / {int(r_k.iterations)} iterations)")
                require(launched["lm_solve"] == 1 and launched["schur_assemble"] == 0,
                        f"lm_fused {label}: launches {launched}")
                if note:  # the costs after 1, 2, ... iterations: a repeat is a rejected step
                    costs = [float(r_f.initial_cost)] + [
                        float(ba.run(c, points, obs, mask, opt, dataclasses.replace(
                            config, impl="fused", max_iterations=k)).cost)
                        for k in range(1, config.max_iterations + 1)]
                    rejected = sum(a == b for a, b in zip(costs, costs[1:]))
                    cases[label][-1]["rejected_steps"] = rejected
                    print(f"    steps rejected: {rejected} of {config.max_iterations}")
                    require(rejected > 0, f"lm_fused {label} {kind}: no step was rejected")
        # against the plain version: one iteration, then the main path's config
        cams, points, obs, mask = make_problem("quat", device, num_views, n_tracks, WIDTH)
        one = BundleAdjustConfig(max_iterations=1, function_tolerance=0.0, min_lambda=1e-12)
        r_f, r_p = (ba.run(cams, points, obs, mask, True, dataclasses.replace(one, impl=i))
                    for i in ("fused", "torch"))
        e_i = rel_err(r_f.initial_cost, r_p.initial_cost)
        e_c = rel_err(r_f.cost, r_p.cost)
        e_r = max_err(r_f.cams.rot, r_p.cams.rot)
        e_o = max_err(r_f.cams.offset, r_p.cams.offset)
        e_p = max_err(r_f.points, r_p.points)
        ok = (e_i < TOL_LM_INIT_COST_REL and e_c < TOL_LM_COST_REL
              and bool(torch.allclose(r_f.cams.rot, r_p.cams.rot, rtol=TOL_LM_ROT_REL,
                                      atol=TOL_LM_ROT_ABS))
              and e_o < TOL_LM_OFFSET_ABS
              and bool(torch.allclose(r_f.points, r_p.points, rtol=TOL_LM_POINTS_REL,
                                      atol=TOL_LM_POINTS_ABS)))
        f_full, p_full = (ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl=i))
                          for i in ("fused", "torch"))
        like = (float(f_full.cost) < float(f_full.initial_cost) * 1e-2
                and float(f_full.cost) < float(p_full.cost) * 1.5 + 1e-6)
        print(f"  lm_fused {label} quat against lm_solve_ref, one iteration: initial cost rel "
              f"{e_i:.3e}, cost rel {e_c:.3e}, rot {e_r:.3e}, offset {e_o:.3e}, points {e_p:.3e}; "
              f"to convergence {int(f_full.iterations)} / {int(p_full.iterations)} iterations, "
              f"cost {float(f_full.cost):.6g} / {float(p_full.cost):.6g}")
        require(ok and like, f"lm_fused {label}: not within tolerance of lm_solve_ref")
        err, rel = max(err, e_r, e_o, e_p), max(rel, e_c)
    for num_views, n_tracks in (*LM_FUSED_TIMED, last):
        label = f"{num_views}x{n_tracks}"
        t = times[label] = time_lm_solve("quat", device, num_views, n_tracks)
        working = t["per_iteration_ms_per_working_iteration"]
        t["ratio_per_working_iteration"] = t["ms_per_iteration"] / working
        print(f"  lm_fused {label}: {t['iterations']} iterations in {t['ms']:.4f} ms "
              f"({t['ms_per_iteration']:.4f} ms/it, wall {t['wall_ms']:.4f} ms); per-iteration "
              f"kernels {t['per_iteration_ms']:.4f} ms device, {t['per_iteration_wall_ms']:.4f} ms "
              f"wall ({t['max_iterations']} enqueued; {working:.4f} ms a working iteration, "
              f"lm_fused / that {t['ratio_per_working_iteration']:.3f}); plain "
              f"{t['plain_ms']:.2f} ms; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
              f"stages' bounds {t['stages_bound_ms']:.5f} ms")
    return err, rel, times, cases


def k3_system(device, num_views):
    """The plain reduced camera system of the standard problem at lambda
    1e-3 (num_views x K3_TRACKS), its LM buffers and its f64 solve."""
    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import lm_inputs, stage_inputs

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
    the plain f32 LU is, plus 1e-6) and timed beside the plain version, the
    library's Cholesky (torch.linalg.cholesky_ex then torch.cholesky_solve:
    the call that computes the same function) and torch.linalg.solve_ex on
    the same prepared system, and each route's bound: the cluster's n^3 / 6
    + n^2 FMA on the f32 CUDA cores, the grid route's its 3xTF32 products on
    the tensor cores (grid_route_bound), with its three floors (f32 FMA,
    3xTF32, its panels' bytes) and its kernel launches a solve
    (torch.profiler). Returns {views: {route: times}}."""
    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import camera_step, cuda_ms, kernel_launches
    from orthosfm_torch.utils.roofline import (bound, camera_solve_work, grid_route_bound,
                                               grid_route_bounds)

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
        n_time = 10 if num_views <= 1100 else 5

        def cholesky():
            L, _ = torch.linalg.cholesky_ex(S_s)
            return torch.cholesky_solve(b[:, None], L)

        shared = {"solve_ex_ms": cuda_ms(lambda: torch.linalg.solve_ex(S_s, b), n_time),
                  "cholesky_ms": cuda_ms(cholesky, n_time),
                  "plain_rel_err_f64": rel64(delta_r)}
        if num_views == K3_GRID_TIMED:
            shared["plain_ms"] = cuda_ms(lambda: bk.camera_solve_ref("quat", *sargs), n_time)
        out[num_views] = {"grid_bounds_ms": grid_route_bounds(num_views), **shared}
        for route in (("cluster", "grid") if num_views == K3_CROSSOVER_VIEWS else ("grid",)):
            solve = lambda *a, r=route: bk.camera_solve(*a, route=r)  # noqa: E731
            delta, rot_c, camp_c = camera_step(solve, "quat", S, dU, rhs, free, 1e-3, rot, camp)
            e64 = rel64(delta)
            ms = cuda_ms(lambda: solve("quat", *sargs), n_time)
            b_ms, b_by = (grid_route_bound(num_views) if route == "grid"
                          else bound(*camera_solve_work(num_views)))
            out[num_views][route] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                                     "rel_err_f64": e64, "rel_err_plain": rel_err(delta, delta_r)}
            print(f"  camera_solve {route:7s} {num_views}x{K3_TRACKS} (n = {n}): {ms:.4f} ms, "
                  f"Cholesky {shared['cholesky_ms']:.4f} ms, solve_ex {shared['solve_ex_ms']:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}); rel err to f64 {e64:.3e} (plain LU "
                  f"{shared['plain_rel_err_f64']:.3e})")
            if route == "grid":
                kernels = kernel_launches(lambda: solve("quat", *sargs))
                per_solve = {k: d["launches"] for k, d in kernels.items() if "grid_" in k}
                out[num_views][route]["launches_per_solve"] = sum(per_solve.values())
                floors = out[num_views]["grid_bounds_ms"]
                print(f"    {sum(per_solve.values()):g} launches a solve ("
                      + ", ".join(f"{re.search(r'grid_[a-z_]+', k).group(0)} {v:g}"
                                  for k, v in per_solve.items())
                      + "); floors " + ", ".join(f"{k} {v:.4f} ms" for k, v in floors.items()))
                require(0 < sum(per_solve.values()) <= K3_GRID_MAX_LAUNCHES,
                        f"grid route at {num_views} views: {per_solve} launches a solve")
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
    from orthosfm_torch.utils.kernel_bench import stage_inputs, time_ba_kernels

    errs = {name: 0.0 for name in (*BA_KERNELS, "camera_solve_grid")}  # max abs error, all cases
    rels = {name: 0.0 for name in errs}         # max relative error over all cases
    # the main paths' shapes: the local BA (3 views, n = 18, K3 in one
    # warp), the global BA and make_problem() (16 views, n = 96), and many
    # views (64, n = 384, where K3's matrix leaves shared memory), at phase
    # 3's track counts and at phase 9's; both camera kinds, points optimized
    # and fixed, at the standard shape
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
    grid = shapes["k3_routes"][K3_GRID_TIMED]  # phase 11's shape
    times["camera_solve_grid"] = {"ms": grid["grid"]["ms"], "plain_ms": grid["plain_ms"],
                                  "library_ms": grid["cholesky_ms"],
                                  "bound_ms": grid["grid"]["bound_ms"],
                                  "bound_by": grid["grid"]["bound_by"]}
    return errs, rels, times, shapes


def run_slice(device, project):
    """Phase 3: the main path, pose estimation from tracks with the kernels."""
    import torch

    from orthosfm_torch.config import ReconstructionConfig, SolverType
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
            cfg = ReconstructionConfig(solver=SolverType(solver))  # ba.impl "auto"
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
    """Phase 4: BA iterations/s of each route, in turns (the fused route
    where it serves; the per-iteration kernels and the plain versions
    everywhere), and the host's time per iteration until ba.run returns
    (before the final sync; the whole solve's launch on the fused route)."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    from orthosfm_torch.solvers import ba_kernels as bk

    cams, points, obs, mask = make_problem("quat", device, num_views, n_tracks, WIDTH)
    fused = bk.fused_fits(num_views, n_tracks, device)
    order = ("kernel", "fused", "torch", "torch", "fused", "kernel") if fused else (
        "kernel", "torch", "torch", "kernel")
    rates = {impl: [] for impl in order}
    enqueue = {impl: [] for impl in order}
    for impl in order:
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


def run_bench(device):
    """Phase 4's bench: orthosfm_torch.bench.measure() on the card (the JAX
    system's bench.py by its method), its JSON line printed, then the checks
    on its routes: 30 iterations each, value at or under the device bound,
    and each route's kernel launches over all its calls."""
    from orthosfm_torch import bench
    from orthosfm_torch.solvers import ba_kernels as bk

    line, detail = bench.measure(device)
    for key, d in detail.items():
        print(f"  {key}: {json.dumps(d)}")
    print(json.dumps(line))
    for key in ("value", "pallas_iter_per_s", "xla_iter_per_s", "euler_iter_per_s",
                "cpu_baseline"):
        require(detail[key]["iterations"] == bench.ITERATIONS,
                f"bench {key}: {detail[key]['iterations']} iterations")
    bound = detail["device_bound"]
    print(f"  value {line['value']} it/s; device bound {bound['iter_per_s']:.1f} it/s "
          f"({bound['solve_ms']:.4f} ms a 30-iteration lm_fused solve)")
    require(bound["value_within"],
            f"bench value {line['value']} it/s above its device bound {bound['iter_per_s']} it/s")
    none = dict.fromkeys(bk.launch_counts(), 0)
    it = bench.ITERATIONS
    for key, per_call in (
            ("value", {**none, "lm_solve": 1}), ("euler_iter_per_s", {**none, "lm_solve": 1}),
            ("pallas_iter_per_s", {**none, "schur_assemble": it, "camera_solve": it,
                                   "point_update_cost": it + 1}),
            ("xla_iter_per_s", none), ("cpu_baseline", none)):
        want = {k: v * detail[key]["calls"] for k, v in per_call.items()}
        require(detail[key]["launches"] == want,
                f"bench {key}: launches {detail[key]['launches']}, not {want}")
    return {"line": line, "detail": detail}


def run_entry(device):
    """Phase 10: entry()'s fn on its example_args twice (bit for bit, one
    lm_fused launch a call, each timed to a synchronize), then against the
    same fn on the plain route on the card. Returns (launches, results)."""
    import torch

    from orthosfm_torch import entry as entry_mod
    from orthosfm_torch.solvers import ba_kernels as bk

    fn, args = entry_mod.entry()
    plain, _ = entry_mod.entry(device, impl="torch")

    def timed(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    bk.reset_launch_counts()
    (a, a_ms), (b, b_ms) = timed(fn), timed(fn)
    launches = bk.launch_counts()
    print(f"  launches {launches}; calls {a_ms:.3f} ms and {b_ms:.3f} ms to a synchronize "
          "(the first builds nothing: phase 1 built the kernels)")
    require(launches == {**dict.fromkeys(launches, 0), "lm_solve": 2},
            f"entry(): launches {launches} over two calls, not one lm_fused each")
    require(all(torch.equal(x, y) for x, y in zip(a, b)), "entry(): two calls differ")
    ref, plain_ms = timed(plain)
    floor = 0.5 * 2 * int(args[3].sum()) * ENTRY_FLOOR_PX ** 2
    cost, ref_cost = float(a[0]), float(ref[0])
    rot_err, pts_err = max_err(a[1], ref[1]), max_err(a[2], ref[2])
    print(f"  cost {cost:.6e} (plain route {ref_cost:.6e}, f32 floor {floor:.3e}); max |rot - "
          f"plain| {rot_err:.3e}, max |points - plain| {pts_err:.3e}; plain route {plain_ms:.3f} "
          "ms to a synchronize")
    require(0.0 < cost < floor and 0.0 < ref_cost < floor,
            f"entry(): costs {cost}, {ref_cost} not under the f32 floor {floor}")
    require(abs(cost - ref_cost) <= TOL_LM_COST_REL * abs(ref_cost) + floor,
            f"entry(): cost {cost} against the plain route's {ref_cost}")
    for x, y, rtol, atol, what in ((a[1], ref[1], TOL_LM_ROT_REL, TOL_LM_ROT_ABS, "rotations"),
                                   (a[2], ref[2], TOL_LM_POINTS_REL, TOL_LM_POINTS_ABS, "points")):
        require(bool(((x - y).abs() <= atol + rtol * y.abs()).all()),
                f"entry(): {what} against the plain route")
    return launches, {"call_ms": [a_ms, b_ms], "plain_call_ms": plain_ms, "cost": cost,
                      "plain_cost": ref_cost, "cost_floor": floor, "max_abs_err_rot": rot_err,
                      "max_abs_err_points": pts_err}


def top2_pairs(device, counts):
    """(bi, bj, ci, cj) on the card: every pair i < j of len(counts) views."""
    import torch

    n = len(counts)
    bi = np.array([i for i in range(n) for j in range(i + 1, n)])
    bj = np.array([j for i in range(n) for j in range(i + 1, n)])
    return [torch.as_tensor(np.asarray(a, np.int32), device=device)
            for a in (bi, bj, counts[bi], counts[bj])]


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


def check_top2(name, stack, cols, n_time):
    """The two-way top2 kernel against top2_ref on one batch of pairs, in
    both directions (d2 to TOL_TOP2, indices outside near ties); against
    itself bit for bit (a second run, the swapped pair table); and timed
    beside the plain version and torch.bmm of the gathered stacks (the
    product alone). Returns (max abs d2 error, relative, near-tie rows of
    each pair in either direction, times)."""
    import torch

    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.utils.kernel_bench import cuda_ms, host_ms
    from orthosfm_torch.utils.roofline import bound, top2_work

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
    from orthosfm_torch.utils.kernel_bench import random_top2_set

    err_all, rel_all, times = 0.0, 0.0, {}
    for D in (128, 64):
        stack, cols = random_top2_set(device, D)
        err, rel, _, times[f"top2_random_{D}"] = check_top2(f"random D={D}", stack, cols, 5)
        err_all, rel_all = max(err_all, err), max(rel_all, rel)
    return err_all, rel_all, times


def front_end_views(device):
    """Phase 5's scene: (ground-truth cameras, 16 sphere views of 2048^2
    rendered on the card), the views holding host arrays, as images loaded
    from files do (profile_matching's scene)."""
    from orthosfm_torch.testbench import profile_matching

    return profile_matching.scene_views(FRONT_VIEWS, FRONT_WIDTH, device=device)


def run_front_end(device):
    """Phase 5: the image front end and pose estimation at reference scale,
    through the functions reconstruct() calls, in its order."""
    import torch

    from orthosfm_torch.config import ReconstructionConfig, SolverType
    from orthosfm_torch.ops import ransac_f
    from orthosfm_torch.pipeline import incremental, track_utils
    from orthosfm_torch.pipeline import matching as matching_mod
    from orthosfm_torch.testbench import metrics
    from orthosfm_torch.utils import profiling
    from orthosfm_torch.utils.kernel_bench import cuda_ms

    t0 = time.perf_counter()
    gt, views = front_end_views(device)
    torch.cuda.synchronize()
    print(f"  rendered {FRONT_VIEWS} views of {FRONT_WIDTH}^2 on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg = ReconstructionConfig(solver=SolverType.ORTHO_QUATERNION)
    stages = {}
    t_all = time.perf_counter()
    with profiling.collect_stages(stages, device, trace=False):
        features = matching_mod.extract_all_view_features(views, cfg, device)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            pair_matches = matching_mod.match_all_pairs(features, cfg, verbose=True)
        tracks = matching_mod.tracks_from_matches(views, features, pair_matches, device=device)
        with profiling.stage("masks_colors"):
            tracks = track_utils.propagate_colors(
                track_utils.filter_tracks_with_masks(tracks, views), views)
        wh = np.full(FRONT_VIEWS, float(FRONT_WIDTH), np.float32)
        with profiling.stage("pose_estimation"):
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
    print("  stage ms: " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in stages.items()))
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
          f"{stages['match/verify_ransac'] * 1e3:.1f} ms")
    ang, pos = metrics.pose_errors(res.cameras, gt)
    mean_ang = float(np.mean(ang))
    print(f"  views placed {int(res.present.sum())}/{FRONT_VIEWS}; mean angular error "
          f"{mean_ang:.4f} deg (limit {FRONT_LIMIT_DEG}), max {float(np.max(ang)):.4f} deg, "
          f"mean position error {float(np.mean(pos)):.5f}")
    require(bool(res.present.all()), "front end: a view was not placed")
    require(mean_ang < FRONT_LIMIT_DEG, f"front end: mean angular error {mean_ang}")
    return features, cfg, stages


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
    """Phase 6, the testbench's path: the testbench CLI over the whole
    dataset matrix on the card, with the launch counts of every kernel over
    it; then the noise sweep and the pipeline bench."""
    import torch

    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.solvers import tk_kernels as tkk
    from orthosfm_torch.testbench import bench_pipeline, synthetic_tests
    from orthosfm_torch.testbench import run as tb_run
    from orthosfm_torch.utils.profiling import BARecorder, kernel_runs

    here = os.path.dirname(os.path.abspath(__file__))
    proj, data = os.path.join(root, "proj"), os.path.join(root, "data")
    log = io.StringIO()
    bk.reset_launch_counts()
    mk.top2.launches = 0
    recorder = BARecorder()
    t0 = time.perf_counter()
    with (contextlib.redirect_stdout(log), recorder.recording(),
          kernel_runs(tkk.KERNEL_NAMES) as tk_ran):
        rc = tb_run.main([proj, data, "--generate", "--solvers", "all", "--repetitions", "1",
                          "--width", str(TESTBENCH_WIDTH)])
        torch.cuda.synchronize()
    t_matrix = time.perf_counter() - t0
    launches = {**bk.launch_counts(), "top2": mk.top2.launches, **tk_ran}
    ba_calls = recorder.summary()
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
    require(launches["top2"] > 0, "top2 was not launched on the testbench's path")
    require_routes(launches, ba_calls, "phase 6 (the testbench matrix)")
    require_tk(launches, "phase 6 (the testbench matrix)")

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
                      "ba": ba_calls,
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
    """Phase 8, the multi-device path: the sharded BA, TK and matching on a
    process group of one rank over NCCL, each bit for bit against one
    device (whose runs come first and do not count), with the launch counts
    of every kernel over the sharded runs; then two ranks on this card over
    gloo and --devices past the cards present."""
    import torch
    import torch.distributed as dist

    from orthosfm_torch.config import BundleAdjustConfig, RansacConfig
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.parallel import ba_sharded, dryrun, mesh as mesh_mod, tk_sharded
    from orthosfm_torch.pipeline import matching as pipe
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.solvers import tk_kernels as tkk
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
        tkk.reset_launch_counts()
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
        launches = {**bk.launch_counts(), "top2": mk.top2.launches, **tkk.launch_counts()}
        routes = bk.route_launches()
        # the JAX package's multi-device dry run, from images through the
        # sharded matching and pose estimation, on this rank
        dry = dryrun.dryrun_multichip(mesh)
    finally:
        dist.destroy_process_group()
    launches["camera_solve_grid"] = routes["grid"]
    print(f"  launches {launches}, camera_solve by route {routes}")
    out = {"launches": launches, "camera_solve_routes": routes, "ba": {},
           "dryrun_multichip": {k: v for k, v in dry.items() if k != "rot"}}
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
    require_tk(launches, "phase 8 (the sharded TK)")
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


def run_many_views(device):
    """Phase 9, the kernels line's main path: the many-view reconstruction
    (testbench.scale_demo, one timed run with the BA kernels' launches, then
    TK's peak memory and a run under the stage barriers) at MANY_VIEWS x
    MANY_TRACKS with MANY_NOISE_PX of noise, held to the accuracy bars; then
    profile_matching at FRONT_VIEWS x FRONT_WIDTH^2 with top2's
    launches. Returns (launches, K3's launches by route, results)."""
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.testbench import profile_matching, scale_demo

    t0 = time.perf_counter()
    many = scale_demo.run_scale_demo(MANY_VIEWS, MANY_TRACKS, noise_px=MANY_NOISE_PX, runs=1,
                                     device=device)
    many["phase_s"] = time.perf_counter() - t0
    launches, routes = dict(many["launches"]), many["camera_solve_routes"]
    ba_calls = many["ba"]
    print(f"  {MANY_VIEWS} views x {MANY_TRACKS} tracks, {MANY_NOISE_PX} px: pose estimation "
          f"{many['wall_s']:.3f} s (under the stage barriers {many['staged_wall_s']:.3f} s); "
          f"views placed {many['views_placed']}/{MANY_VIEWS}, angular error mean "
          f"{many['mean_angular_error_deg']:.6f} max {many['max_angular_error_deg']:.6f} deg "
          f"(limits {MANY_LIMIT_MEAN_DEG} / {MANY_LIMIT_MAX_DEG}; the JAX package "
          f"{many['jax_package']['mean_angular_error_deg']} / "
          f"{many['jax_package']['max_angular_error_deg']})")
    print(f"  launches {launches}, camera_solve by route {routes}; BA: {ba_calls['ba_calls']} "
          f"calls ({ba_calls['global_ba_calls']} global), {ba_calls['iterations_worked']} of "
          f"{ba_calls['iterations_launched']} LM iterations did work, host enqueue "
          f"{ba_calls['enqueue_ms_per_it']:.4f} ms per iteration")
    print(f"  peak device memory {many['peak_bytes'] / 1e9:.3f} GB; TK on one group "
          f"({many['tk']['hypotheses']} hypotheses x {many['tk']['tracks']} tracks) "
          f"{many['tk']['tk_peak_bytes'] / 1e9:.3f} GB above its base")
    print("  stage shares: " + ", ".join(f"{k} {v:.3f}" for k, v in many["stage_shares"].items()))
    require(many["views_placed"] == MANY_VIEWS, f"many views: {many['views_placed']} placed")
    require(many["mean_angular_error_deg"] < MANY_LIMIT_MEAN_DEG
            and many["max_angular_error_deg"] < MANY_LIMIT_MAX_DEG,
            f"many views: angular error {many['mean_angular_error_deg']} / "
            f"{many['max_angular_error_deg']}")
    require_routes(launches, ba_calls, "phase 9")
    launches.update(many["tk_launches"])
    require_tk(launches, "phase 9")
    require(ba_calls["global_ba_calls"] > 0 and all(launches[name] == 0 for name in UNSHARDED_BA)
            and ba_calls["iterations_launched"] == ba_calls["iterations_worked"],
            f"phase 9: the 64-view global BAs did not all run on lm_fused: {launches}, "
            f"{ba_calls['by_route']}")

    mk.top2.launches = 0
    prof = profile_matching.profile_matching(FRONT_VIEWS, FRONT_WIDTH, device=device)
    launches["top2"] = mk.top2.launches
    print("\n".join("  " + ln for ln in profile_matching.format_table(prof).splitlines()))
    print(f"  top2 launches {launches['top2']} (the warm-up pass and the profiled one)")
    require(launches["top2"] > 0 and prof["num_tracks"] > 0,
            f"profile_matching: top2 {launches['top2']}, tracks {prof['num_tracks']}")
    return launches, routes, {"scale_demo": many, "matching_profile": prof}


def run_grid_path(device):
    """Phase 11: the main path past 119 views, testbench.scale_demo's
    reconstruction at GRID_PATH_VIEWS x GRID_PATH_TRACKS with
    GRID_PATH_NOISE_PX of noise (one timed run, with the BA kernels'
    launches, then a run under the stage barriers): every view placed, the
    mean angular error under GRID_PATH_LIMIT_MEAN_DEG, every BA one
    lm_fused launch, those over all cameras with K3's grid route inside it,
    no launch of K1, K3 or K2, and no LM iteration launched that did not
    work. Returns (launches, lm_fused's launches by the route of its camera
    solve, results)."""
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench import scale_demo

    t0 = time.perf_counter()
    out = scale_demo.run_scale_demo(GRID_PATH_VIEWS, GRID_PATH_TRACKS,
                                    noise_px=GRID_PATH_NOISE_PX, runs=1, device=device)
    out["phase_s"] = time.perf_counter() - t0
    launches, fused_routes, ba_calls = dict(out["launches"]), out["lm_fused_routes"], out["ba"]
    big = {int(v): r for v, r in ba_calls["by_views"].items()
           if bk.camera_solve_route(int(v)) == "grid"}
    global_s = {k: v for k, v in out["stages_s"].items() if "global" in k}
    print(f"  {GRID_PATH_VIEWS} views x {GRID_PATH_TRACKS} tracks, {GRID_PATH_NOISE_PX} px: pose "
          f"estimation {out['wall_s']:.3f} s (under the stage barriers "
          f"{out['staged_wall_s']:.3f} s); views placed {out['views_placed']}/{GRID_PATH_VIEWS}, "
          f"angular error mean {out['mean_angular_error_deg']:.6f} max "
          f"{out['max_angular_error_deg']:.6f} deg (limit {GRID_PATH_LIMIT_MEAN_DEG})")
    print("  global BA stage " + ", ".join(f"{k} {v:.3f} s" for k, v in global_s.items())
          + f" (PR 12, an iteration at a time: {GRID_PATH_GLOBAL_BA_S_PR12} s); BA: "
          f"{ba_calls['ba_calls']} calls, {ba_calls['iterations_worked']} of "
          f"{ba_calls['iterations_launched']} LM iterations did work; by route "
          + ", ".join(f"{r}: {d['ba_calls']} calls, {d['iterations_worked']} of "
                      f"{d['iterations_launched']} iterations worked"
                      for r, d in ba_calls["by_route"].items()))
    print(f"  BAs on K3's grid route inside lm_fused: {sum(r['ba_calls'] for r in big.values())} "
          f"calls at {sorted(big)} views, {sum(r['iterations_worked'] for r in big.values())} "
          f"working iterations; launches {launches}, lm_fused by the route of its camera solve "
          f"{fused_routes} (PR 12: 190 lm_fused launches and 64 BAs an iteration at a time)")
    print("  stage shares: " + ", ".join(f"{k} {v:.3f}" for k, v in out["stage_shares"].items()))
    require(out["views_placed"] == GRID_PATH_VIEWS, f"phase 11: {out['views_placed']} placed")
    require(out["mean_angular_error_deg"] < GRID_PATH_LIMIT_MEAN_DEG,
            f"phase 11: mean angular error {out['mean_angular_error_deg']}")
    require(big and fused_routes["grid"] == sum(r["ba_calls"] for r in big.values()) > 0,
            f"phase 11: the grid route inside lm_fused ran {fused_routes['grid']} times for "
            f"{sorted(big)} views")
    require_routes(launches, ba_calls, "phase 11")
    launches.update(out["tk_launches"])
    require_tk(launches, "phase 11")
    require(launches["lm_solve"] == ba_calls["ba_calls"]
            and all(launches[name] == 0 for name in UNSHARDED_BA)
            and ba_calls["iterations_launched"] == ba_calls["iterations_worked"],
            f"phase 11: not every BA one lm_fused launch: {launches}, {ba_calls['by_route']}")
    return launches, fused_routes, out


def rstar_err(a, b):
    """max |a - b s|, s each column's sign of agreement (RStar's columns are
    defined up to sign)."""
    s = (a * b).sum(dim=-2, keepdim=True).sign()
    return max_err(a, b * s)


def run_tk(device):
    """Phase 12: TK's kernels against their plain versions on the card at
    TK_SHAPES (241 hypotheses of 3 views; K5 also as the fallback over every
    valid track, its Gram a torch.matmul), each timed beside its plain
    version and bound; a whole robust_factorization timed to a synchronize
    and run once more under torch's sync debug mode ("error": a call that
    waits on the card raises), through K5 twice and K6 once, with its peak
    device memory. Returns (errors, times, per-shape results)."""
    import torch

    from orthosfm_torch.config import RansacConfig
    from orthosfm_torch.solvers import tk_kernels as tkk
    from orthosfm_torch.solvers import tomasi_kanade as tk
    from orthosfm_torch.utils.kernel_bench import cuda_ms, tk_inputs
    from orthosfm_torch.utils.roofline import bound, tk_factorize_work, tk_score_work

    cfg = RansacConfig()
    thr = cfg.max_inlier_reprojection_error_px
    w = torch.full((3,), WIDTH, device=device)
    errs = {"tk_factorize": 0.0, "tk_score": 0.0}
    shapes = {}
    for n_tracks in TK_SHAPES:
        obs, valid, samp, q0, q0f = tk_inputs(device, n_tracks, TK_NOISE_PX)
        H, S = samp.shape
        n_valid = int(valid.sum())
        o, fb = obs[samp], (obs[None], valid[None], q0f[None])
        ref = tkk.tk_factorize_ref(o, None, q0, cfg)
        own = tkk.tk_factorize(o, None, q0, cfg)
        given = tkk.tk_factorize(o, None, q0, cfg, rstar=ref[3].contiguous())
        fb_ref = tkk.tk_factorize_ref(*fb, cfg)
        fb_own = tkk.tk_factorize(*fb, cfg)
        fb_given = tkk.tk_factorize(*fb, cfg, rstar=fb_ref[3].contiguous())
        k5 = {"models": max(max_err(given[0], ref[0]), max_err(given[1], ref[1])),
              "rstar_up_to_signs": rstar_err(own[3], ref[3]),
              "fallback_models": max(max_err(fb_given[0], fb_ref[0]),
                                     max_err(fb_given[1], fb_ref[1])),
              "fallback_rstar_up_to_signs": rstar_err(fb_own[3], fb_ref[3]),
              "usable_equal": torch.equal(given[2], ref[2]),
              "usable": int(own[2].sum())}
        score, n_con = tkk.tk_score(own[0], own[2], obs, valid, w, w, samp, cfg)
        score_ref, n_ref = tkk.tk_score_ref(own[0], own[2], obs, valid, w, w, samp, cfg)
        _, err = tkk._triangulate_and_errors(own[0], obs, valid, w, w)
        gap = (err - thr).abs().amin(dim=2).masked_fill(~valid[None], float("inf"))
        n_near = (gap < TK_NEAR_PX).sum(dim=1)
        clean = n_near == 0
        fin = torch.isfinite(score_ref) & clean
        k6 = {"score": max_err(score[fin], score_ref[fin]) if bool(fin.any()) else 0.0,
              "finite_equal": torch.equal(torch.isfinite(score)[clean],
                                          torch.isfinite(score_ref)[clean]),
              "consensus_within_near": bool(((n_con - n_ref).abs() <= n_near).all()),
              "consensus_differs": int((n_con != n_ref).sum()),
              "near_tracks": int(n_near.sum()), "finite_scores": int(torch.isfinite(score).sum())}
        print(f"  {H} hypotheses x {n_tracks} tracks ({n_valid} valid): K5 models "
              f"{k5['models']:.3e} given the plain RStar (fallback {k5['fallback_models']:.3e}), "
              f"RStar up to signs {k5['rstar_up_to_signs']:.3e} (fallback "
              f"{k5['fallback_rstar_up_to_signs']:.3e}), usable equal {k5['usable_equal']} "
              f"({k5['usable']} usable); K6 scores {k6['score']:.3e}, consensus counts differ at "
              f"{k6['consensus_differs']} hypotheses with {k6['near_tracks']} tracks within "
              f"{TK_NEAR_PX} px of the threshold; {k6['finite_scores']} finite scores")
        require(k5["models"] <= TOL_TK_MODEL and k5["fallback_models"] <= TOL_TK_MODEL
                and k5["rstar_up_to_signs"] <= TOL_TK_MODEL
                and k5["fallback_rstar_up_to_signs"] <= TOL_TK_MODEL and k5["usable_equal"],
                f"K5 against its plain version at {H} x {n_tracks}: {k5}")
        require(k6["score"] <= TOL_TK_SCORE and k6["finite_equal"] and k6["consensus_within_near"]
                and k6["finite_scores"] > 0, f"K6 against its plain version at {n_tracks}: {k6}")
        errs["tk_factorize"] = max(errs["tk_factorize"], k5["models"], k5["fallback_models"])
        errs["tk_score"] = max(errs["tk_score"], k6["score"])

        t5 = cuda_ms(lambda: tkk.tk_factorize(o, None, q0, cfg))
        t5_plain = cuda_ms(lambda: tkk.tk_factorize_ref(o, None, q0, cfg), 3)
        t5_fb = cuda_ms(lambda: tkk.tk_factorize(*fb, cfg))
        t5_fb_plain = cuda_ms(lambda: tkk.tk_factorize_ref(*fb, cfg), 3)
        t6 = cuda_ms(lambda: tkk.tk_score(own[0], own[2], obs, valid, w, w, samp, cfg))
        t6_plain = cuda_ms(lambda: tkk.tk_score_ref(own[0], own[2], obs, valid, w, w, samp,
                                                    cfg), 3)
        b5 = bound(*tk_factorize_work(H, S, 3))
        b5_fb = bound(*tk_factorize_work(1, n_tracks, 3, gram_given=True))
        b6 = bound(*tk_score_work(H, n_tracks, n_valid, 3, S))

        def tk_call(gen):
            return tk.robust_factorization(obs, valid, WIDTH, WIDTH, cfg, generator=gen)

        calls = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tk_call(torch.Generator(device).manual_seed(i))
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        tkk.reset_launch_counts()
        gen = torch.Generator(device).manual_seed(0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = tk_call(gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = tkk.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - base
        print(f"  K5 {t5:.4f} ms (plain {t5_plain:.3f}, bound {b5[0]:.6f} by {b5[1]}); K5 "
              f"fallback with its Gram {t5_fb:.4f} ms (plain {t5_fb_plain:.3f}); K6 {t6:.4f} ms "
              f"(plain {t6_plain:.3f}, bound {b6[0]:.6f} by {b6[1]}); robust_factorization "
              f"{min(calls):.3f}-{max(calls):.3f} ms a call to a synchronize, under the sync "
              f"debug mode with {launches}: {int(res.num_inliers)} inliers, peak "
              f"{peak / 1e6:.3f} MB above its base")
        require(launches == {"tk_factorize": 2, "tk_score": 1} and bool(res.found)
                and bool(torch.isfinite(res.model1).all()),
                f"robust_factorization at {n_tracks}: {launches}, found {bool(res.found)}")
        shapes[f"{H}x{n_tracks}"] = {
            "k5": k5, "k6": k6, "valid_tracks": n_valid,
            "tk_factorize": {"ms": t5, "plain_ms": t5_plain, "bound_ms": b5[0],
                             "bound_by": b5[1], "library_ms": None},
            "tk_factorize_fallback": {"ms": t5_fb, "plain_ms": t5_fb_plain, "bound_ms": b5_fb[0],
                                      "bound_by": b5_fb[1], "library_ms": None},
            "tk_score": {"ms": t6, "plain_ms": t6_plain, "bound_ms": b6[0], "bound_by": b6[1],
                         "library_ms": None},
            "robust_factorization_ms": calls, "tk_peak_bytes": peak}
    main_shape = f"{cfg.max_iterations}x{MANY_TRACKS}"  # phase 9's groups
    times = {name: shapes[main_shape][name] for name in TK_REPLACES}
    return errs, times, shapes


def run_outlier_nn(device):
    """Phase 13: outlier_nn against the plain sweep at OUTLIER_SHAPES tracks
    (blob points, w = 1, every 13th track without a point), each timed by
    CUDA events (the wrapper's call: the squared norms, the scratch's zero
    fill and the kernel) beside the plain sweep and the bound, with each
    route's peak device memory above its base. Returns (largest
    |nn - plain nn|, per-shape results)."""
    import torch

    from orthosfm_torch.data import synthetic
    from orthosfm_torch.ops import outlier_kernels as okern
    from orthosfm_torch.ops import outliers
    from orthosfm_torch.utils.kernel_bench import cuda_ms
    from orthosfm_torch.utils.roofline import bound, outlier_nn_work

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(device) - base

    worst, shapes = 0.0, {}
    for T in OUTLIER_SHAPES:
        pts = torch.ones((T, 4), device=device)
        pts[:, :3] = torch.as_tensor(synthetic.blob_cloud(T), dtype=torch.float32, device=device)
        has = torch.ones((T,), dtype=torch.bool, device=device)
        has[::13] = False
        ref = outliers.nearest_neighbor_distances(pts, has, impl="torch")
        got = okern.outlier_nn(pts, has)
        err = max_err(got, ref)
        zeros = bool((got[~has] == 0).all())
        require(torch.equal(got, ref) and zeros, f"outlier_nn at {T} tracks: {err} from the "
                                                 f"plain sweep, unpointed tracks zero {zeros}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: okern.outlier_nn(pts, has))
        plain_ms = cuda_ms(lambda: outliers.nearest_neighbor_distances(pts, has, impl="torch"), 3)
        b = bound(*outlier_nn_work(T, int(has.sum())))
        mem = {"kernel": peak(lambda: okern.outlier_nn(pts, has)),
               "plain": peak(lambda: outliers.nearest_neighbor_distances(pts, has, impl="torch"))}
        print(f"  {T} tracks: bit for bit with the plain sweep; outlier_nn {ms:.4f} ms a call "
              f"(bound {b[0]:.4f} ms by {b[1]}, {100 * b[0] / ms:.1f}% of it), plain sweep "
              f"{plain_ms:.3f} ms; peak memory above base {mem['kernel'] / 1e6:.3f} MB, plain "
              f"{mem['plain'] / 1e6:.1f} MB; {-(-T // okern.launch_plan(T))} shares x "
              f"{-(-T // okern.QUERIES)} query blocks")
        shapes[str(T)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                          "library_ms": None, "peak_bytes": mem, "chunk": okern.launch_plan(T)}
    return worst, shapes


def tk_per_group(results):
    """TK per group: each phase's pose/tk stage (under its stage barriers)
    over its groups (K6's launches, one a group), measured in this run; the
    text line sets the plain TK route's earlier times beside it."""
    out = {}
    for phase, (stage_s, groups) in results.items():
        out[phase] = {"pose_tk_s": stage_s, "groups": groups,
                      "ms_per_group": 1e3 * stage_s / groups}
        print(f"  {phase}: pose/tk {stage_s:.3f} s over {groups} groups, "
              f"{out[phase]['ms_per_group']:.2f} ms a group (the plain TK route, "
              f"before the kernels: {TK_EARLIER[phase]})")
    return out


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
    from orthosfm_torch.ops import outlier_kernels as okern
    from orthosfm_torch.pipeline import tracks_build
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.solvers import tk_kernels as tkk
    from orthosfm_torch.utils.kernel_bench import stage_inputs, time_ba_kernels
    from orthosfm_torch.utils.profiling import BARecorder, kernel_runs

    print("== phase 1: card and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = (bk.SOURCE, mk.SOURCE, tkk.SOURCE, okern.SOURCE, tracks_build.SOURCE,
               tracks_io.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(kernel_build.build, sources))
    for lib in (bk.library, mk.library, tkk.library, okern.library, tracks_build.library,
                tracks_io.library):
        lib()
    outlier_ptxas = kernel_build.ptxas_usage(built[sources.index(okern.SOURCE)][1],
                                             "outlier_nn_kernel")
    print(f"  built {', '.join(os.path.relpath(p) for p, _ in built)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for _, log in built:
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry",
                                       "Function properties")):
                print("  " + line.strip())

    print("== phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    errs, rels, times, shapes = check_kernels(device)
    errs["top2"], rels["top2"], top2_times = check_top2_random(device)
    errs["lm_fused"], rels["lm_fused"], lm_times, lm_cases = check_lm_fused(device)
    times["lm_fused"] = lm_times[f"{N_VIEWS}x{N_TRACKS}"]
    shapes["lm_fused"] = {"times": lm_times, "bit_for_bit_cases": lm_cases}
    print(f"  phase 2 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 3: pose estimation from tracks (16 views x 7800 tracks, 2048^2)")
    t0 = time.perf_counter()
    recorder = BARecorder()
    bk.reset_launch_counts()
    with (tempfile.TemporaryDirectory() as project, recorder.recording(),
          counting_outlier_filter() as outlier_slice, kernel_runs(tkk.KERNEL_NAMES) as tk_slice):
        run_slice(device, project)
    launches = bk.launch_counts()
    launches_slice = {**launches, **tk_slice, **outlier_slice}
    slice_ba = recorder.summary()
    print(f"  launches {launches}")
    print(f"  BA: {slice_ba['ba_calls']} calls, {slice_ba['iterations_worked']} of "
          f"{slice_ba['iterations_launched']} iterations did work; by route "
          f"{slice_ba['by_route']}")
    require_routes(launches, slice_ba, "phase 3")
    require_tk(launches_slice, "phase 3")
    require_outlier_nn(outlier_slice, "phase3")
    print(f"  phase 3 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 4: the BA bench (orthosfm_torch/bench.py), then BA iterations/s (quat)")
    t0 = time.perf_counter()
    rates = {f"{N_VIEWS}x{N_TRACKS}": run_bench(device)}
    for num_views, n_tracks in BA_SHAPES:
        print(f"  {num_views} views x {n_tracks} tracks")
        r = ba_rate(device, num_views, n_tracks)
        rates[f"{num_views}x{n_tracks}"] = r
        print(f"  fused {r['fused']:.1f} it/s, kernel path {r['kernel']:.1f} it/s, plain torch "
              f"path {r['torch']:.1f} it/s")
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
    with (recorder.recording(), counting_outlier_filter() as outlier_front,
          kernel_runs(tkk.KERNEL_NAMES) as tk_front):
        features, cfg, front_stages = run_front_end(device)
    launches["top2"] = mk.top2.launches
    front_ba = {**bk.launch_counts(), **tk_front}
    front_iters = recorder.summary()
    print(f"  launches top2 {launches['top2']}, BA {front_ba}")
    print(f"  BA: {front_iters['ba_calls']} calls, {front_iters['iterations_worked']} of "
          f"{front_iters['iterations_launched']} iterations did work; by route "
          f"{front_iters['by_route']}")
    require(launches["top2"] > 0, "top2 was not launched on the front end's path")
    require_routes(front_ba, front_iters, "phase 5")
    require_tk(front_ba, "phase 5")
    require_outlier_nn(outlier_front, "phase5")
    err, rel, real_times = check_top2_real(device, features, cfg)
    errs["top2"], rels["top2"] = max(errs["top2"], err), max(rels["top2"], rel)
    times["top2"] = real_times["top2_sift"]
    print(f"  phase 5 wall time {time.perf_counter() - t0:.2f} s")

    print(f"== phase 6: the testbench on the card (dataset matrix at {TESTBENCH_WIDTH}, noise "
          "sweep, pipeline bench)")
    t0 = time.perf_counter()
    phase_launches = {"phase3": launches_slice,
                      "phase5": {**front_ba, "top2": launches["top2"], **outlier_front}}
    with tempfile.TemporaryDirectory() as root, counting_outlier_filter() as outlier_counts:
        phase_launches["phase6"], testbench = run_testbench(device, root)
    phase_launches["phase6"].update(outlier_counts)
    require_outlier_nn(outlier_counts, "phase6")
    print(f"  phase 6 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 7: RANSAC-H (pair_verification=\"homography\")")
    t0 = time.perf_counter()
    homography = run_homography(device, features)
    print(f"  phase 7 wall time {time.perf_counter() - t0:.2f} s")

    print("== phase 8: the multi-device path (parallel/) on one rank over NCCL, two over gloo")
    t0 = time.perf_counter()
    with counting_outlier_filter() as outlier_counts:
        sharded = run_sharded(device, features, cfg)
    phase_launches["phase8"] = {**sharded["launches"], **outlier_counts}
    require_outlier_nn(outlier_counts, "phase8")
    print(f"  phase 8 wall time {time.perf_counter() - t0:.2f} s")
    print(f"== phase 9: the many-view reconstruction ({MANY_VIEWS} views x {MANY_TRACKS} "
          f"tracks, {MANY_NOISE_PX} px) and the front end's stage profile")
    t0 = time.perf_counter()
    with counting_outlier_filter() as outlier_counts:
        many_launches, many_routes, many_views = run_many_views(device)
    many_launches.update(outlier_counts)
    phase_launches["phase9"] = {**many_launches, "camera_solve_routes": many_routes}
    require_outlier_nn(outlier_counts, "phase9")
    per_run = many_views["scale_demo"]["outlier_nn_launches"]
    print(f"  phase 9: outlier_nn launches in one 64-view run {per_run}")
    require(per_run == 20, f"phase 9: {per_run} outlier_nn launches in one 64-view run, not 20")
    print(f"  phase 9 wall time {time.perf_counter() - t0:.2f} s")
    print("== phase 10: the single-device entry point (orthosfm_torch/entry.py)")
    t0 = time.perf_counter()
    tkk.reset_launch_counts()
    phase_launches["phase10"], entry_run = run_entry(device)
    phase_launches["phase10"].update(tkk.launch_counts())
    print(f"  phase 10 wall time {time.perf_counter() - t0:.2f} s")
    print(f"== phase 11: the main path past 119 views ({GRID_PATH_VIEWS} views x "
          f"{GRID_PATH_TRACKS} tracks, {GRID_PATH_NOISE_PX} px): every BA on lm_fused, the "
          "global ones with K3's grid route inside")
    t0 = time.perf_counter()
    with counting_outlier_filter() as outlier_counts:
        grid_launches, fused_routes, grid_path = run_grid_path(device)
    phase_launches["phase11"] = {**grid_launches, **outlier_counts,
                                 "lm_fused_routes": fused_routes}
    require_outlier_nn(outlier_counts, "phase11")
    print(f"  phase 11 wall time {time.perf_counter() - t0:.2f} s")
    print("== phase 12: TK's kernels (K5 tk_factorize, K6 tk_score) against their plain "
          "versions, a TK call with no host sync, TK per group")
    t0 = time.perf_counter()
    tk_errs, tk_times, tk_shapes = run_tk(device)
    errs.update(tk_errs)
    rels.update(dict.fromkeys(tk_errs))
    times.update(tk_times)
    tk_groups = tk_per_group({
        "phase5": (front_stages["pose/tk"], front_ba["tk_score"]),
        "phase9": (many_views["scale_demo"]["stages_s"]["pose/tk"], many_launches["tk_score"]),
        "phase11": (grid_path["stages_s"]["pose/tk"], grid_launches["tk_score"])})
    print(f"  phase 12 wall time {time.perf_counter() - t0:.2f} s")
    print("== phase 13: the outlier filter's neighbour search (outlier_nn) against its plain "
          "version")
    t0 = time.perf_counter()
    errs["outlier_nn"], outlier_shapes = run_outlier_nn(device)
    rels["outlier_nn"] = None
    times["outlier_nn"] = outlier_shapes[str(MANY_TRACKS)]
    print(f"  outlier_nn_kernel: {outlier_ptxas}")
    print(f"  phase 13 wall time {time.perf_counter() - t0:.2f} s")
    if args.parent:
        print(f"== top2 in turns against {args.parent}")
        real_times["turns"] = top2_turns(args.parent)
    print(f"total wall time {time.perf_counter() - t_all:.2f} s")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches: the main path, phase 9 (the many-view run's lm_fused,
    # profile_matching's top2); K1, K3 and K2 run there and in phase 11
    # only inside lm_fused, and lm_accept's own launch is not on it: they
    # give phase 8's (the sharded BA, which launches them), and so does K3's
    # grid route, which phase 11 runs inside lm_fused only. Each earlier
    # phase's counts are in launches_by_phase.
    def main_path(name):
        key = LAUNCH_KEY.get(name, name)
        return ("phase9", many_launches[key]) if many_launches.get(key) else (
            "phase8", phase_launches["phase8"][key])

    kernels = [{"name": name, "route": "cuda", "source": SOURCE_OF[name],
                "replaces": {**REPLACES, **TK_REPLACES, **OUTLIER_REPLACES}[name],
                "launches": main_path(name)[1],
                "launches_phase": main_path(name)[0],
                "max_abs_err": errs[name], "max_rel_err": rels[name],
                **{k: times[name][k] for k in keys}}
               for name in (*REPLACES, *TK_REPLACES, *OUTLIER_REPLACES)]
    for k in kernels:
        if k["name"] == "camera_solve_grid":  # its own launches: the sharded BA's
            k["launches"], k["launches_phase"] = phase_launches["phase8"][k["name"]], "phase8"
            k["inside_lm_fused_phase11"] = fused_routes["grid"]
        if k["name"] == "camera_solve":
            k["routes"] = (many_routes if k["launches_phase"] == "phase9"
                           else sharded["camera_solve_routes"])
            k["routes_phase9"] = many_routes
        if k["name"] == "lm_accept":
            k["tail_ms"] = times["lm_accept"]["tail_ms"]
        if k["name"] == "lm_fused":  # phase 9's local BA, and every shape timed
            k["main_path_shapes"] = {"3x50000": lm_times["3x50000"]}
            k["shapes"] = lm_times
        if k["name"] in TK_REPLACES:  # phase 12's shapes; launches in every phase
            k["shapes"] = {label: r[k["name"]] for label, r in tk_shapes.items()}
            k["launches_by_phase"] = {phase: counts.get(k["name"], 0)
                                      for phase, counts in phase_launches.items()}
        if k["name"] in OUTLIER_REPLACES:  # phase 13's shapes; launches and calls by phase
            k["shapes"] = outlier_shapes
            k["ptxas"] = outlier_ptxas
            k["launches_by_phase"] = {phase: {key: counts.get(key, 0)
                                              for key in ("outlier_nn", "filter_calls")}
                                      for phase, counts in phase_launches.items()}
        if k["name"] in UNSHARDED_BA:
            # the same kernel at the shapes phase 9 gives it
            k["main_path_shapes"] = {
                f"{v}x{t}": {key: shapes[f"{v}x{t}"][k["name"]][key]
                             for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
                for v, t in MAIN_PATH_SHAPES}
    print(json.dumps({"kernels": kernels, "launches_by_phase": phase_launches,
                      "ba_shapes": shapes, "ba_iter_per_s": rates,
                      "ba_main_path": {"phase3": slice_ba, "phase5": front_iters},
                      "top2_ms": {**top2_times, **real_times}, "testbench": testbench,
                      "homography": homography, "sharded": sharded,
                      "many_views": many_views, "entry": entry_run, "grid_path": grid_path,
                      "tk": {"shapes": tk_shapes, "per_group": tk_groups}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
