"""Device timers and the kernels' standard inputs on the card: what
chip_smoke.py's kernel checks and the kernel scripts (scripts/
torch_roofline.py, torch_k3_routes.py, torch_ba_kernel_turns.py,
torch_top2_turns.py) time with and time on, so that each times the same
thing the same way. The work counts beside these times are
orthosfm_torch/utils/roofline.py's.

This module imports nothing of orthosfm_torch at its top: the scripts that
time another tree in turns load this file by its path and import that
tree's package.
"""

from __future__ import annotations

import time

import torch

# cuda_ms's sleep: cycles of torch.cuda._sleep per second (above the H100's
# 1.98 GHz boost clock, so the sleep lasts at least as long as asked)
SLEEP_CYCLES_PER_S = 2.0e9
# The LM rule of the standard problem's steps: lambda_0, function tolerance,
# lambda up and down factors, lambda's floor and ceiling
LM_CFG_ARGS = (1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)


def cuda_ms(fn, n=20):
    """Mean device time of fn() over n launches, by CUDA events. The card
    first sleeps while the host enqueues all n calls, so the events time the
    device's work and not the host's pace (the wrappers' Python takes tens
    of microseconds a call, more than several kernels run)."""
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


def kernel_launches(fn, n=3):
    """{kernel name: {"launches", "ms"}} a call of fn(): the kernels the card
    ran over n calls and their device time (torch.profiler's CUDA events),
    divided by n."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        if e.count:
            out[e.key] = {"launches": e.count / n, "ms": us / 1e3 / n}
    return out


def host_ms(fn, n=20):
    """Mean host time of fn() over n calls, none of which waits on the card:
    the enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return t


def stage_inputs(kind, device, num_views, n_tracks, width=2048.0):
    """The standard problem's (pT, obsT, maskT, rot, camp, free) at a size
    (testbench.problems.make_problem, ba.prepare)."""
    from orthosfm_torch.core import cameras as cam_mod
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    cams, points, obs, mask = make_problem(kind, device, num_views, n_tracks, width)
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


def k2_stage(kind, inputs, opt, rot_c, camp_c, plain, split=False):
    """K2 with its accept tail (or its plain version; or in split mode) on
    LM buffers whose half 0 holds the current cameras and points and half 1
    the candidate cameras."""
    from orthosfm_torch.solvers import ba_kernels as bk

    p2, obsT, maskT, r2, c2, free = lm_inputs(inputs)
    r2[1], c2[1] = rot_c, camp_c
    return bk.PointUpdateCost(kind, p2, obsT, maskT, r2, c2, free, 1.0, opt,
                              bk.LMConfig(*LM_CFG_ARGS), plain=plain, split=split), (p2, r2, c2)


def time_ba_kernels(inputs):
    """K1, K3 and K2 with its accept tail at one shape (quat, points
    optimized, lambda 1e-3): kernel, plain and, for K3,
    torch.linalg.solve_ex alone on the same prepared system, with each one's
    bound from this problem's mask; and the tail alone (lm_accept): K2's
    time less K2's without the tail, beside lm_accept_ref."""
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.roofline import ba_work, bound

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
    n = 30 if maskT.shape[0] <= 16 else 10 if maskT.shape[0] <= 64 else 5
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
                     "plain_host_ms": host_ms(plain_fn, n),
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


def wall_ms(fn, n=5):
    """Mean host time of fn() to a torch.cuda.synchronize() after it, over n
    calls: what a caller that waits for the result pays."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total * 1e3 / n


def time_lm_solve(kind, device, num_views, n_tracks, config=None, opt=True, n=10):
    """The whole LM solve on make_problem() at a size with `config` (the
    main path's BundleAdjustConfig() by default: function tolerance 1e-6,
    up to 100 iterations), three ways from the same LM buffers: lm_solve
    (lm_fused, one launch), the per-iteration kernels (lm_iterate, which
    enqueues max_iterations iterations) and the plain version lm_solve_ref
    (its stages stop at the done flag, a host sync an iteration). Each
    call first restores the buffers (three copies, timed alone as
    reset_ms and taken off the device times). Returns each one's device
    time a solve (CUDA events; the plain version's is its wall time), the
    wall time a solve to a synchronize, the iterations that worked, ms per
    iteration that worked (the per-iteration kernels' from a run enqueuing
    only those iterations, so no converged no-op counts), and
    lm_solve_work's bound for this run's iterations."""
    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.roofline import bound, lm_solve_work

    config = BundleAdjustConfig() if config is None else config
    pT, obsT, maskT, rot, camp, free = stage_inputs(kind, device, num_views, n_tracks)
    p0, r0, c0 = bk.lm_buffers(pT, rot, camp)
    p2, r2, c2 = p0.clone(), r0.clone(), c0.clone()
    cfg = bk.LMConfig.of(config)
    args = (kind, p2, obsT, maskT, r2, c2, free, float(config.huber_delta), opt, cfg,
            config.max_iterations)

    def reset():
        p2.copy_(p0)
        r2.copy_(r0)
        c2.copy_(c0)

    def fused():
        reset()
        return bk.lm_solve(*args)

    def per_iteration():
        reset()
        return bk.lm_iterate(*args, plain=False, stop_at_done=False)

    def plain():
        reset()
        return bk.lm_solve_ref(*args)

    iterations = int(fused()[bk.ITERS])

    def per_iteration_working():
        reset()
        return bk.lm_iterate(*args[:-1], iterations, plain=False, stop_at_done=False)

    reset_ms = cuda_ms(reset, n)
    ms = cuda_ms(fused, n) - reset_ms
    flops, nbytes, stages_ms = lm_solve_work(maskT, opt, iterations)
    b_ms, b_by = bound(flops, nbytes)
    out = {"views": num_views, "tracks": n_tracks, "iterations": iterations,
           "max_iterations": config.max_iterations, "ms": ms,
           "ms_per_iteration": ms / max(iterations, 1), "wall_ms": wall_ms(fused, n),
           "per_iteration_ms": cuda_ms(per_iteration, n) - reset_ms,
           "per_iteration_wall_ms": wall_ms(per_iteration, n),
           "plain_ms": wall_ms(plain, max(1, n // 5)), "reset_ms": reset_ms,
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "stages_bound_ms": stages_ms}
    out["per_iteration_ms_per_iteration"] = out["per_iteration_ms"] / max(iterations, 1)
    out["per_iteration_ms_per_working_iteration"] = (
        cuda_ms(per_iteration_working, n) - reset_ms) / max(iterations, 1)
    return out


def lm_fused_split(kind, device, num_views, n_tracks, config, opt=True, n=5, lib=None):
    """Where lm_fused's time goes, from its timing build
    (ba_kernels.timing_library: %globaltimer stamps at every stage
    boundary): lm_solve on make_problem() at a size with `config`, n runs,
    and per iteration that worked the mean ms of each stage (K1 blocks,
    product, reduce, K3 solve, K2: from the previous barrier's release, or
    the iteration's start, to the last CTA's arrival at the stage's
    barrier; accept: from the last release to the iteration's end), of each
    barrier's own wait (the last CTA's arrival to the release) and of the
    whole iteration. A stage whose barrier the launch does not take is
    reported as None and its time counts in the next stage's. Also the
    timing build's and the main build's device ms a solve (the stamps'
    cost) and the smallest step of the timer seen. ``lib``: another timing
    build in place of ba_kernels.timing_library()."""
    from orthosfm_torch.solvers import ba_kernels as bk

    pT, obsT, maskT, rot, camp, free = stage_inputs(kind, device, num_views, n_tracks)
    p0, r0, c0 = bk.lm_buffers(pT, rot, camp)
    p2, r2, c2 = p0.clone(), r0.clone(), c0.clone()
    args = (kind, p2, obsT, maskT, r2, c2, free, float(config.huber_delta), opt,
            bk.LMConfig.of(config), config.max_iterations)
    lib = lib or bk.timing_library()
    stamps = torch.zeros((bk.FUSED_STAMP_HEAD + bk.FUSED_STAMP_SLOTS * config.max_iterations,),
                         dtype=torch.int64, device=device)

    def run(timed, build=lib):
        p2.copy_(p0)
        r2.copy_(r0)
        c2.copy_(c0)
        stamps.zero_()
        lib.osfm_lm_fused_stamps(stamps.data_ptr() if timed else None)
        return bk.lm_solve(*args, lib=build)

    names = (*bk.FUSED_BARRIERS, "accept")
    stage = {k: [] for k in names}
    wait = {k: [] for k in bk.FUSED_BARRIERS}
    total, steps = [], []
    iterations = 0
    run(True)
    for _ in range(n):
        iterations = int(run(True)[bk.ITERS])
        st = stamps.cpu().tolist()
        for it in range(iterations):
            b = st[bk.FUSED_STAMP_HEAD + bk.FUSED_STAMP_SLOTS * it:][:bk.FUSED_STAMP_SLOTS]
            prev = b[0]
            for k, name in enumerate(bk.FUSED_BARRIERS):
                arrive, release = b[1 + 2 * k], b[2 + 2 * k]
                if not arrive:
                    continue
                stage[name].append(arrive - prev)
                wait[name].append(release - arrive)
                prev = release
            stage["accept"].append(b[-1] - prev)
            total.append(b[-1] - b[0])
        flat = sorted(set(x for x in st if x))
        steps += [y - x for x, y in zip(flat, flat[1:])]

    def mean_ms(xs):
        return sum(xs) / len(xs) / 1e6 if xs else None

    # a solve of each build, the buffers' reset included in both
    timing_ms = cuda_ms(lambda: run(True), n)
    main_ms = cuda_ms(lambda: run(False, bk.library()), n)
    return {"views": num_views, "tracks": n_tracks, "iterations": iterations,
            "stage_ms": {k: mean_ms(v) for k, v in stage.items()},
            "barrier_wait_ms": {k: mean_ms(v) for k, v in wait.items()},
            "barriers_per_iteration": sum(len(v) for v in wait.values()) / max(len(total), 1),
            "iteration_ms": mean_ms(total), "timing_build_ms": timing_ms,
            "main_build_ms": main_ms, "timer_step_ns": min(steps) if steps else None}


def random_top2_set(device, D, n=8192):
    """Random unit descriptors, 11 views x n rows x D, and 8 pairs of them
    (bi, bj, counts i, counts j): exact ties (every database row of view 3
    twice, view 2's queries equal to duplicated rows, view 1 against itself
    with repeated rows), a ragged pair, databases of 0 and 1 valid rows and
    a short query side."""
    gen = torch.Generator(device=device).manual_seed(0 if D == 128 else 1)
    stack = torch.randn((11, n, D), generator=gen, device=device)
    stack /= torch.linalg.vector_norm(stack, dim=-1, keepdim=True)
    stack[3, n // 2:] = stack[3, :n // 2]
    stack[2, :n // 4] = stack[3, :n // 4]
    stack[1, n - 100:] = stack[1, 100:200]
    pairs = [(0, 1, n, n), (2, 3, n, n), (4, 5, n - 37, n - 100), (6, 7, n, 0),
             (8, 9, n, 1), (1, 1, n, n), (10, 2, n // 8, n), (3, 0, n, n // 2 + 1)]
    return stack, [torch.tensor(c, dtype=torch.int32, device=device) for c in zip(*pairs)]


def tk_inputs(device, n_tracks, noise_px=1.0, seed=0):
    """A Tomasi-Kanade group: the first 3 of 6 views of the blob of
    n_tracks tracks (2048^2) with noise_px of Gaussian pixel noise (numpy,
    seeded), obs (T, 3, 2) and its full-size mask (T,); then its RANSAC
    draws (tomasi_kanade.draw_hypotheses, a generator seeded `seed`):
    (obs, valid, samp_idx (241, 10), q0 (241, 9), q0_fallback (9,))."""
    import numpy as np

    from orthosfm_torch.config import RansacConfig
    from orthosfm_torch.data import synthetic
    from orthosfm_torch.solvers import tomasi_kanade as tk

    ds = synthetic.generate_dataset(synthetic.blob_cloud(n_tracks, seed=seed), num_views=6,
                                    seed=seed, width=2048, height=2048, device=device)
    tracks = synthetic.add_observation_noise(ds.tracks, noise_px, np.random.default_rng(seed))
    cols = torch.arange(3, device=device)
    obs = tracks.obs[:, cols].contiguous()
    valid = tracks.alive & torch.all(tracks.obs_mask[:, cols], dim=1)
    draws = tk.draw_hypotheses(valid, RansacConfig(), torch.Generator(device).manual_seed(seed))
    return (obs, valid, *draws)
