"""The port's CUDA kernels (orthosfm_torch/csrc/ba_kernels.cu,
match_kernels.cu and outlier_kernels.cu) against their plain PyTorch versions, on the card. Every test is marked `cuda` and skips
where torch.cuda.is_available() is false.

This file imports neither jax nor the JAX package, so it runs on a machine
with a GPU and no JAX; tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the kernels sum over tracks in per-chunk and per-split partials
and solve the camera system by a Cholesky factorization, the plain versions
sum in torch's order and solve by LU; both are f32. Relative 1e-4 on sums of ~1e4
terms, 1e-5 on the solve (measured: ~1e-6), which a solve that mishandles the
damping fails at both lambdas checked, 1e-5 on unit-norm points. top2: d2
within 1e-5 absolute in both directions (the kernel's FMA chain and
cuBLAS's GEMM sum in different orders) and the same index except on rows
whose best and second d2 lie within 1e-5 of each other; the kernel against
itself (a swapped pair table, a second run) bit for bit.

outlier_nn: bit for bit with the plain version on the card (it takes the
plain version's squared norms and rounds its dots as the f32 GEMM does), for
points in rows and in columns of memory, each squared distance so also
within OUTLIER_TOL_ULPS ulp of |p_i|² + max_j |p_j|² of it (the expansion's
own rounding, the bound the CPU tests hold the host build to), and the
outlier filter's kept tracks identical to the plain route's on the
benchmark's cells' inputs and chip_smoke.py phase 9's blob, one launch a
filter call.

The last tests run the BA bench's routes (orthosfm_torch/bench.py) by their
launches, entry() at its real size, and ba.run's host side: no call that
waits on the card, and no kernel with use_pallas=False; then TK's CUDA graphs
(pipeline/tk_graphs.py) against the eager code, bit for bit, with the
generator's state, and a second run of one shape that captures nothing.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from orthosfm_torch import kernel_build
from orthosfm_torch.config import BundleAdjustConfig, SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.ops import matching as match_ops
from orthosfm_torch.ops import matching_kernels as mk
from orthosfm_torch.pipeline import matching as pipeline_matching
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import ba_kernels as bk
from orthosfm_torch.testbench.problems import make_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _stage_inputs(kind, dev, num_views, n_points):
    cams, points, obs, mask = make_problem(kind, dev, num_views, n_points)
    pT, obsT, maskT = ba.prepare(points, obs, mask)
    return (pT, obsT, maskT, cams.rot.contiguous(), ba.pack_camp(cams),
            cam_mod.free_mask(cams).float().contiguous())


def _lm(inputs):
    """The stage inputs with the points and cameras as fresh LM buffers."""
    pT, obsT, maskT, rot, camp, free = inputs
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    return p2, obsT, maskT, r2, c2, free


def _camera_step(kind, solve, S, dU, rhs, free, lam, rot, camp):
    """One camera solve (K3 or its plain version) at lambda `lam` from fresh
    LM buffers of rot and camp: (delta, candidate rot, candidate camp). The
    current half is never written."""
    r2, c2 = bk.lm_buffers(rot, camp)
    delta = solve(kind, S, dU, rhs, free, bk.new_state(lam, rot.device), r2, c2)
    assert torch.equal(r2[0], rot) and torch.equal(c2[0], camp)
    return delta, r2[1], c2[1]


# K2 is held to its plain version at both: lambda 1e-3 is the size of step
# the main path takes (from lambda_0 = 1e-4 downward), lambda 1 a damped one.
K2_LAMBDAS = (1e-3, 1.0)


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("optimize_points", [True, False])
@pytest.mark.parametrize("shape", [(3, 7800), (8, 1000), (16, 3000), (64, 3000), (120, 1000),
                                   (200, 600), (256, 600), (400, 500)])
def test_stages_match_plain_versions(dev, kind, optimize_points, shape):
    """K1-K3 against their plain versions, K2 with its accept tail (once K4)
    included; 7800, 1000, 3000, 600 and 500
    tracks are ragged against every chunk and k-tile. K1 writes X and Y to
    its scratch at every size and sums the per-view blocks in one [V][27]
    buffer of shared memory, up to 400 views here. The camera solve runs in
    one warp at 3 views (n = 18, the local BA), in one CTA with its matrix in
    shared memory at 8 and 16 views (n = 48, 96), on a cluster of 8 CTAs
    with its rows in their shared memory at 64 views (n = 384), and on the
    cluster with its rows and panel in a global scratch buffer at 120 to 400
    views (n = 720 to 2400). K2 takes the plain step of each lambda."""
    inputs = _stage_inputs(kind, dev, *shape)
    pT, obsT, maskT, rot, camp, free = inputs
    args = (kind, *_lm(inputs), bk.new_state(1e-3, dev), 1.0, optimize_points)
    S, dU, rhs = bk.schur_assemble(*args)
    S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
    assert max(_rel(S, S_r), _rel(dU, dU_r), _rel(rhs, rhs_r)) < 1e-4

    for lam in K2_LAMBDAS:
        sargs = (kind, S_r, dU_r, rhs_r, free, lam, rot, camp)
        delta, rot_c, _ = _camera_step(kind, bk.camera_solve, *sargs[1:])
        delta_r, rot_cr, camp_cr = _camera_step(kind, bk.camera_solve_ref, *sargs[1:])
        assert _rel(delta, delta_r) < 1e-5, lam
        assert float((rot_c - rot_cr).abs().max()) < 1e-5
        _check_point_update_cost(kind, inputs, optimize_points, lam, delta_r, rot_cr, camp_cr)


@pytest.mark.parametrize("shape", [(3, 7800), (16, 3000), (64, 3000)])
def test_schur_and_solve_follow_the_current_half(dev, shape):
    """K1 reads the half of the LM buffers that state[CUR] names and K3
    writes its candidate into the other one: with the halves swapped and
    CUR 1, the same bits as with CUR 0."""
    kind = "euler"
    pT, obsT, maskT, rot, camp, free = _stage_inputs(kind, dev, *shape)
    state = bk.new_state(1e-3, dev)
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    S, dU, rhs = bk.schur_assemble(kind, p2, obsT, maskT, r2, c2, free, state, 1.0, True)
    delta = bk.camera_solve(kind, S, dU, rhs, free, state, r2, c2)
    # half 0 is never read
    q2, s2, d2 = (torch.stack([torch.full_like(x, float("nan")), x]) for x in (pT, rot, camp))
    state[bk.CUR] = 1.0
    got = bk.schur_assemble(kind, q2, obsT, maskT, s2, d2, free, state, 1.0, True)
    for a, b in zip(got, (S, dU, rhs)):
        assert torch.equal(a, b)
    d_1 = bk.camera_solve(kind, S, dU, rhs, free, state, s2, d2)
    assert torch.equal(d_1, delta) and torch.equal(s2[0], r2[1]) and torch.equal(d2[0], c2[1])
    assert torch.equal(s2[1], rot) and torch.equal(d2[1], camp)


CFG = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)


def _fused_stage(kind, inputs, opt, rot_c, camp_c, plain):
    """K2 with its accept tail (or its plain version) on LM buffers whose
    half 0 holds the current cameras and points and half 1 the candidate
    cameras."""
    p2, obsT, maskT, r2, c2, free = _lm(inputs)
    r2[1], c2[1] = rot_c, camp_c
    return bk.PointUpdateCost(kind, p2, obsT, maskT, r2, c2, free, 1.0, opt, CFG,
                              plain=plain), (p2, r2, c2)


def _check_point_update_cost(kind, inputs, opt, lam, delta, rot_c, camp_c, check_cost=True):
    """K2 with its accept tail against point_update_cost_ref + lm_accept_ref
    (point_update_accept_ref), for the step `delta` taken at lambda `lam`
    that lowers the cost (accepted) and the same step held to a lower
    previous cost (rejected): points within 1e-5, cost (with check_cost)
    within 1e-4 relative, the rest of the state and the selected buffers
    exact."""
    dev = inputs[0].device
    _, parts_r = bk.point_update_cost_ref(kind, *inputs, bk.new_state(lam, dev), delta, rot_c,
                                          camp_c, 1.0, opt)
    for factor, accepted in ((2.0, True), (0.5, False)):
        s_in = bk.new_state(lam, dev)
        s_in[bk.COST] = parts_r.sum() * factor
        outs = []
        for plain in (False, True):
            stage, bufs = _fused_stage(kind, inputs, opt, rot_c, camp_c, plain)
            s_out = torch.zeros_like(s_in)
            parts = stage(s_in, s_out, delta)
            outs.append((s_out, parts, bufs))
        (s_k, parts_k, (p_k, r_k, c_k)), (s_p, parts_p, (p_p, r_p, c_p)) = outs
        assert float(s_k[bk.CUR]) == float(accepted)
        if check_cost:
            np.testing.assert_allclose(float(parts_k.sum()), float(parts_p.sum()), rtol=1e-4)
            np.testing.assert_allclose(float(s_k[bk.COST]), float(s_p[bk.COST]), rtol=1e-4)
        keep = [i for i in range(bk.STATE_SIZE) if i != bk.COST]
        assert torch.equal(s_k[keep], s_p[keep])
        assert float(s_k[bk.ITERS]) == 1.0
        assert float((p_k[1] - p_p[1]).abs().max()) < 1e-5
        assert torch.equal(p_k[0], p_p[0]) and torch.equal(r_k, r_p) and torch.equal(c_k, c_p)


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_ba_run_kernel_path_converges_like_plain(dev, kind):
    cams, points, obs, mask = make_problem(kind, dev, 16, 4000)
    cfg = BundleAdjustConfig(max_iterations=15, function_tolerance=0.0, min_lambda=1e-12)
    bk.reset_launch_counts()
    r_k = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="kernel"))
    counts = bk.launch_counts()
    r_t = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    # three wrapper calls an iteration and one for the initial cost; no
    # separate accept kernel
    assert counts == {"lm_solve": 0, "schur_assemble": 15, "camera_solve": 15,
                      "point_update_cost": 16, "lm_accept": 0}, counts
    np.testing.assert_allclose(float(r_k.initial_cost), float(r_t.initial_cost), rtol=1e-5)
    assert float(r_k.cost) < float(r_k.initial_cost) * 1e-2
    assert float(r_k.cost) < float(r_t.cost) * 1.5 + 1e-6
    assert r_k.cams.rot.is_cuda and r_k.points.is_cuda
    # the fixed camera 0 is only renormalized
    torch.testing.assert_close(r_k.cams.rot[0], cams.rot[0], rtol=0.0, atol=2e-7)


@pytest.mark.parametrize("num_views", [200, 256, 520])
def test_ba_run_at_many_views(dev, num_views):
    """Global BA over more than 200 views: every kernel launches (K1's
    per-view sums, K2's camera tables and K3's matrix must fit their memory
    at this size; 520 views is past K2's ceiling before its tables shrank)
    and the kernel path converges like the plain one."""
    cams, points, obs, mask = make_problem("quat", dev, num_views, 1000)
    cfg = BundleAdjustConfig(max_iterations=15, function_tolerance=0.0, min_lambda=1e-12)
    bk.reset_launch_counts()
    r_k = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="kernel"))
    counts = bk.launch_counts()
    r_t = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    assert all(counts[k] > 0 for k in ("schur_assemble", "camera_solve", "point_update_cost"))
    np.testing.assert_allclose(float(r_k.initial_cost), float(r_t.initial_cost), rtol=1e-5)
    assert float(r_k.cost) < float(r_k.initial_cost) * 1e-2
    assert float(r_k.cost) < float(r_t.cost) * 1.5 + 1e-6


def _done_flag_runs(dev, sigma):
    """The kernel path allowed 50 iterations, the kernel path allowed exactly
    the iterations that run used, and the plain path; after convergence the
    launched iterations must be no-ops, so the first two end bit-identical."""
    cams, points, obs, mask = make_problem("quat", dev, 8, 2000)
    if sigma:
        noise = np.random.default_rng(1).normal(0.0, sigma, tuple(obs.shape)).astype(np.float32)
        obs = obs + torch.as_tensor(noise, device=dev)
    cfg = BundleAdjustConfig(max_iterations=50, function_tolerance=1e-2, impl="kernel")
    r_50 = ba.run(cams, points, obs, mask, True, cfg)
    iters = int(r_50.iterations)
    assert iters < 50
    r_n = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, max_iterations=iters))
    assert int(r_n.iterations) == iters
    torch.testing.assert_close(r_50.points, r_n.points, rtol=0.0, atol=0.0)
    torch.testing.assert_close(r_50.cams.rot, r_n.cams.rot, rtol=0.0, atol=0.0)
    assert float(r_50.cost) == float(r_n.cost)
    r_t = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    return r_50, r_t


def test_done_flag_stops_the_loop_on_the_device(dev):
    """Noise-free: two iterations take the cost from ~5e4 to ~2e-5, the f32
    rounding floor of the residuals, and both paths stop only after that.
    From there each step changes the cost by rounding noise of up to ~40%, so
    the iteration at which an accepted step first falls under the 1% of
    function_tolerance is chance, and the kernel and plain paths, which
    round their sums differently, may stop many iterations apart (PERF.md,
    Open questions). Their costs both stay at the floor."""
    r_50, r_t = _done_flag_runs(dev, 0.0)
    assert min(int(r_50.iterations), int(r_t.iterations)) >= 3
    for r in (r_50, r_t):
        assert float(r.cost) < float(r.initial_cost) * 1e-2


def test_done_flag_stops_the_loop_with_noise(dev):
    """Half a pixel of noise keeps the minimum cost (~6% of the initial one)
    far above f32 rounding, so the plain path on the card, which runs the
    same loop, stops within one iteration of the kernel path (one apart at
    the tolerance's edge) at the same cost."""
    r_50, r_t = _done_flag_runs(dev, 0.5)
    assert abs(int(r_t.iterations) - int(r_50.iterations)) <= 1
    assert float(r_50.cost) < float(r_50.initial_cost) * 0.1
    np.testing.assert_allclose(float(r_50.cost), float(r_t.cost), rtol=1e-3)


@pytest.mark.parametrize("shape", [(3, 7800), (16, 8192), (200, 600)])
def test_schur_assemble_is_bit_stable(dev, shape):
    """No float atomics: two launches on the same inputs give the same bits
    (the done-flag tests rely on it)."""
    args = ("quat", *_lm(_stage_inputs("quat", dev, *shape)), bk.new_state(1e-3, dev), 1.0, True)
    first = bk.schur_assemble(*args)
    second = bk.schur_assemble(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    S = first[0]
    assert torch.equal(S, S.T)


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("shape", [(3, 7800), (16, 3000), (64, 3000)])
def test_schur_assemble_with_unobserved_entries(dev, kind, shape):
    """K1 skips masked (track, view) entries and tracks no view observes,
    as the local BAs' masks have them."""
    pT, obsT, maskT, rot, camp, free = _stage_inputs(kind, dev, *shape)
    rng = np.random.default_rng(1)
    keep = torch.as_tensor(rng.random(maskT.shape) > 0.4, device=dev)
    keep[:, : shape[1] // 5] = False
    lm = _lm((pT, obsT, (maskT * keep).contiguous(), rot, camp, free))
    for opt in (True, False):
        args = (kind, *lm, bk.new_state(1e-3, dev), 1.0, opt)
        S, dU, rhs = bk.schur_assemble(*args)
        S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
        assert max(_rel(S, S_r), _rel(dU, dU_r), _rel(rhs, rhs_r)) < 1e-4


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("shape", [(3, 7800), (16, 3000), (64, 3000)])
def test_point_update_cost_with_unobserved_entries(dev, kind, shape):
    """K2 skips masked (track, view) entries and tracks no view observes (a
    fifth of them here, and those left with one view), as the local BAs'
    masks have them, in both passes, at both lambdas, on the noise-free
    observations and with 1 px of noise. A track seen by one view has a
    point block of rank 2, whose damped inverse turns f32 rounding into
    ~1e-4 of point; the pipeline's BAs have no such track (a local BA's
    tracks are seen by all its views, a global BA's are triangulated from
    two or more)."""
    pT, obsT, maskT, rot, camp, free = _stage_inputs(kind, dev, *shape)
    rng = np.random.default_rng(1)
    keep = torch.as_tensor(rng.random(maskT.shape) > 0.4, device=dev)
    keep[:, : shape[1] // 5] = False
    keep[:, (keep & (maskT != 0)).sum(dim=0) < 2] = False
    maskT = (maskT * keep).contiguous()
    noise = torch.as_tensor(rng.normal(0.0, 1.0, tuple(obsT.shape)).astype(np.float32), device=dev)
    for obs in (obsT, (obsT + noise).contiguous()):
        inputs = (pT, obs, maskT, rot, camp, free)
        for opt in (True, False):
            for lam in K2_LAMBDAS:
                S, dU, rhs = bk.normal_eq_schur_ref(kind, *_lm(inputs), bk.new_state(lam, dev), 1.0,
                                                    opt)
                step = _camera_step(kind, bk.camera_solve_ref, S, dU, rhs, free, lam, rot, camp)
                # noise-free, the step of lambda 1e-3 takes the cost to ~1e-4 of
                # what it was; near this exact fit the f32 roundings of the
                # cost pass move the cost by up to ~1e-3 relative (on an H100
                # K2's is 1.1e-3 from the plain version run in f64, the f32
                # plain version's 3.5e-4: chip_smoke.py phase 2 prints all
                # three), so only the points, the state but its cost and the
                # selection are compared there
                near_fit = obs is obsT and lam == 1e-3
                _check_point_update_cost(kind, inputs, opt, lam, *step, check_cost=not near_fit)


@pytest.mark.parametrize("views", [520, 600])
def test_point_update_cost_at_many_views(dev, views):
    """K2's shared tables (208 bytes a view) fit 520 and 600 views, past the
    ~548 its two 200-byte Cam tables and the step took before."""
    inputs = _stage_inputs("euler", dev, views, 500)
    pT, obsT, maskT, rot, camp, free = inputs
    for lam in K2_LAMBDAS:
        S, dU, rhs = bk.normal_eq_schur_ref("euler", *_lm(inputs), bk.new_state(lam, dev), 1.0,
                                            True)
        step = _camera_step("euler", bk.camera_solve_ref, S, dU, rhs, free, lam, rot, camp)
        _check_point_update_cost("euler", inputs, True, lam, *step)


@pytest.mark.parametrize("shape", [(3, 7800), (16, 8192), (64, 4096)])
def test_point_update_cost_is_bit_stable(dev, shape):
    """Partials summed in a fixed order and no float atomics: two launches of
    K2 with its accept tail give the same bits, the state included, and
    leave the ticket at 0."""
    inputs = _stage_inputs("quat", dev, *shape)
    pT, obsT, maskT, rot, camp, free = inputs
    S, dU, rhs = bk.normal_eq_schur_ref("quat", *_lm(inputs), bk.new_state(1e-3, dev), 1.0, True)
    delta, rot_c, camp_c = _camera_step("quat", bk.camera_solve_ref, S, dU, rhs, free, 1e-3, rot,
                                        camp)
    stage, (p2, _, _) = _fused_stage("quat", inputs, True, rot_c, camp_c, False)
    s_in = bk.new_state(1e-3, dev)
    s_in[bk.COST] = 1e30
    runs = []
    for _ in range(2):
        s_out = torch.zeros_like(s_in)
        parts = stage(s_in, s_out, delta).clone()
        runs.append((s_out, parts, p2[1].clone()))
        assert int(stage.ticket) == 0
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert float(runs[0][0][bk.CUR]) == 1.0


def test_camera_solve_rejects_an_indefinite_system(dev):
    """The Cholesky of K3 meets a negative pivot on -S': the step comes out
    non-finite, K2's cost with it is not below the current one, and K2's
    last CTA rejects the step, raises lambda and leaves the current half
    named; ba.run, whose every system is made indefinite, leaves the cameras
    and points as they were."""
    kind = "quat"
    pT, obsT, maskT, rot, camp, free = _stage_inputs(kind, dev, 8, 1000)
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    s0 = torch.zeros(bk.STATE_SIZE, device=dev)
    stage = bk.PointUpdateCost(kind, p2, obsT, maskT, r2, c2, free, 1.0, True, CFG)
    stage(None, s0)  # the initial cost
    s0[bk.LAM] = 1e-3
    S, dU, rhs = bk.schur_assemble(kind, p2, obsT, maskT, r2, c2, free, s0, 1.0, True)
    delta = bk.camera_solve(kind, -S, dU, rhs, free, s0, r2, c2)
    assert not bool(torch.isfinite(delta).all())
    s1 = torch.zeros_like(s0)
    stage(s0, s1, delta)
    assert float(s1[bk.LAM]) == pytest.approx(1e-3 * 4.0)
    assert float(s1[bk.COST]) == float(s0[bk.COST])
    assert float(s1[bk.ITERS]) == 1.0 and float(s1[bk.CUR]) == 0.0
    for buf, orig in ((r2, rot), (c2, camp), (p2, pT)):
        assert torch.equal(bk.current(buf, s1), orig)

    cams, points, obs, mask = make_problem(kind, dev, 8, 1000)
    assemble = bk.schur_assemble

    def negated(*args):
        S, dU, rhs = assemble(*args)
        return -S, dU, rhs

    negated.launches = 0  # launch_counts() reads the wrapper under its module name

    cfg = BundleAdjustConfig(max_iterations=3, impl="kernel")
    try:
        bk.schur_assemble = negated
        res = ba.run(cams, points, obs, mask, True, cfg)
    finally:
        bk.schur_assemble = assemble
    assert int(res.iterations) == 3
    assert float(res.cost) == float(res.initial_cost)
    assert torch.equal(res.cams.rot, cams.rot)
    assert torch.equal(res.points, ba.prepare(points, obs, mask)[0].T)


def test_wrappers_reject_bad_inputs(dev):
    pT, obsT, maskT, rot, camp, free = _stage_inputs("quat", dev, 4, 300)
    state = bk.new_state(1e-3, dev)
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    with pytest.raises(ValueError, match="dtype"):
        bk.schur_assemble("quat", p2.double(), obsT, maskT, r2, c2, free, state, 1.0, True)
    with pytest.raises(ValueError, match="device"):
        bk.schur_assemble("quat", p2, obsT, maskT.cpu(), r2, c2, free, state, 1.0, True)
    with pytest.raises(ValueError, match="LM buffer"):
        bk.schur_assemble("quat", p2, obsT, maskT, rot, c2, free, state, 1.0, True)
    with pytest.raises(ValueError, match="contiguous"):
        bk.PointUpdateCost("quat", p2, obsT.transpose(0, 1).contiguous().transpose(0, 1), maskT,
                           r2, c2, free, 1.0, False, CFG)
    with pytest.raises(ValueError, match="LM buffer"):
        bk.PointUpdateCost("quat", pT, obsT, maskT, r2, c2, free, 1.0, False, CFG)
    stage = bk.PointUpdateCost("quat", p2, obsT, maskT, r2, c2, free, 1.0, True, CFG)
    with pytest.raises(ValueError, match="shape"):
        stage(state, torch.zeros(4, device=dev), torch.zeros(4, 6, device=dev))
    S, dU, rhs = bk.schur_assemble("quat", p2, obsT, maskT, r2, c2, free, state, 1.0, True)
    shifted = torch.empty(S.numel() + 1, device=dev)[1:].view_as(S).copy_(S)
    with pytest.raises(ValueError, match="aligned"):
        bk.camera_solve("quat", shifted, dU, rhs, free, state, r2, c2)


# ---------------------------------------------------------------------------
# lm_fused: the whole LM solve in one cooperative launch


def _same_result(a, b):
    """Two BAResults bit for bit: cameras, points, costs, iterations."""
    return (torch.equal(a.cams.rot, b.cams.rot) and torch.equal(a.cams.offset, b.cams.offset)
            and torch.equal(a.cams.scale, b.cams.scale) and torch.equal(a.points, b.points)
            and float(a.cost) == float(b.cost) and float(a.initial_cost) == float(b.initial_cost)
            and int(a.iterations) == int(b.iterations))


def _rejecting(cams):
    """Every free camera's scale 2.5 times too large (scale is pinned, so no
    step repairs it): from lambda_0 = 1e-2 the first LM steps are rejected."""
    scale = cams.scale.clone()
    scale[1:] *= 2.5
    return cams.replace(scale=scale)


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("optimize_points", [True, False])
@pytest.mark.parametrize("shape", [(3, 7800), (8, 1000), (16, 3000), (37, 2048), (38, 2048),
                                   (64, 4096), (119, 1024), (64, 50000), (120, 1024),
                                   (128, 1024), (192, 4096), (bk.FUSED_MAX_VIEWS, 2000)])
def test_lm_solve_is_the_per_iteration_kernels_bit_for_bit(dev, kind, optimize_points, shape):
    """ba.run's fused route against its per-iteration kernels, to convergence
    (the main path's config) and with the first steps rejected: the same
    work items and sum orders, so the same bits and iteration count. From
    38 views the camera solve runs on the launch's first cluster and from
    the crossover (GRID_MIN_V) on K3's grid route over every CTA, whose
    work dealing differs from its own launch's (a CTA a SM, not one a
    tile); 64 x 50 000 is phase 9's global BA, 192 x 4096 phase 11's and
    FUSED_MAX_VIEWS the launch's last size."""
    cams, points, obs, mask = make_problem(kind, dev, *shape)
    cfg = BundleAdjustConfig()
    for c, config in ((cams, cfg), (_rejecting(cams), dataclasses.replace(cfg, initial_lambda=1e-2,
                                                                          max_iterations=8))):
        bk.reset_launch_counts()
        r_f = ba.run(c, points, obs, mask, optimize_points, dataclasses.replace(config,
                                                                                impl="fused"))
        assert bk.launch_counts() == {"lm_solve": 1, "schur_assemble": 0, "camera_solve": 0,
                                      "point_update_cost": 0, "lm_accept": 0}
        r_k = ba.run(c, points, obs, mask, optimize_points, dataclasses.replace(config,
                                                                                impl="kernel"))
        assert _same_result(r_f, r_k), (float(r_f.cost), float(r_k.cost), int(r_f.iterations),
                                        int(r_k.iterations))
        assert 0 < int(r_f.iterations) <= config.max_iterations


def test_lm_solve_rejected_steps_keep_the_start(dev):
    """Two rejected steps leave the cameras and the cost as they were."""
    cams, points, obs, mask = make_problem("quat", dev, 8, 1000)
    cfg = BundleAdjustConfig(initial_lambda=1e-2, max_iterations=2, function_tolerance=0.0,
                             impl="fused")
    bad = _rejecting(cams)
    r = ba.run(bad, points, obs, mask, True, cfg)
    assert int(r.iterations) == 2 and float(r.cost) == float(r.initial_cost)
    assert torch.equal(r.cams.rot, bad.rot)
    r_k = ba.run(bad, points, obs, mask, True, dataclasses.replace(cfg, impl="kernel"))
    assert _same_result(r, r_k)


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_lm_solve_agrees_with_its_plain_version(dev, kind):
    """lm_solve against lm_solve_ref: one iteration at the JAX package's
    tolerances for its fused kernel (tests/test_ba_fused.py), and fifteen
    converging like the plain version."""
    cams, points, obs, mask = make_problem(kind, dev, 16, 3000)
    for iters in (1, 15):
        cfg = BundleAdjustConfig(max_iterations=iters, function_tolerance=0.0, min_lambda=1e-12)
        pT, obsT, maskT = ba.prepare(points, obs, mask)
        free = cam_mod.free_mask(cams).float().contiguous()
        out = []
        for solve in (bk.lm_solve, bk.lm_solve_ref):
            p2, r2, c2 = bk.lm_buffers(pT, cams.rot, ba.pack_camp(cams))
            st = solve(kind, p2, obsT, maskT, r2, c2, free, 1.0, True, bk.LMConfig.of(cfg), iters)
            out.append((st, *(bk.current(x, st) for x in (p2, r2, c2))))
        (s_f, p_f, r_f, c_f), (s_r, p_r, r_r, c_r) = out
        np.testing.assert_allclose(float(s_f[bk.INIT_COST]), float(s_r[bk.INIT_COST]), rtol=1e-5)
        assert float(s_f[bk.ITERS]) == float(s_r[bk.ITERS]) == iters
        if iters == 1:
            np.testing.assert_allclose(float(s_f[bk.COST]), float(s_r[bk.COST]), rtol=1e-3)
            torch.testing.assert_close(r_f, r_r, rtol=1e-4, atol=2e-6)
            torch.testing.assert_close(c_f[:, 3:5], c_r[:, 3:5], rtol=0.0, atol=1e-5)
            torch.testing.assert_close(p_f, p_r, rtol=1e-3, atol=1e-5)
        else:
            assert float(s_f[bk.COST]) < float(s_f[bk.INIT_COST]) * 1e-2
            assert float(s_f[bk.COST]) < float(s_r[bk.COST]) * 1.5 + 1e-6


def test_lm_solve_with_no_iterations_is_the_initial_cost(dev):
    cams, points, obs, mask = make_problem("quat", dev, 3, 7800)
    cfg = BundleAdjustConfig(max_iterations=0)
    r_f = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="fused"))
    r_k = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="kernel"))
    assert _same_result(r_f, r_k) and int(r_f.iterations) == 0
    assert float(r_f.cost) == float(r_f.initial_cost) > 0.0


def test_fused_gate_is_the_cards(dev):
    """The library serves 1 to FUSED_MAX_VIEWS views, the CPU rule's
    bound, and neither serves one more: up to 37 with a grid of at least one
    CTA a SM, from 38 (the cluster's camera solve) with whole clusters of
    8, from the crossover (K3's grid route) with one CTA a SM, up to where
    K1's and K2's per-view tables leave its shared memory."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for views in range(1, bk.FUSED_MAX_VIEWS + 2):
        grid, route = bk._fused_grid(views), bk.camera_solve_route(views)
        fits = views <= bk.FUSED_MAX_VIEWS
        assert (grid > 0) is fits, (views, grid)
        assert bk.fused_fits(views, 2048, dev) is fits and bk.fused_fits(views, 2048, "cpu") is fits
        if not fits:
            continue
        if route in ("warp", "cta"):
            assert grid >= sms, views
        elif route == "cluster":
            assert grid >= 8 and grid % 8 == 0, (views, grid)
        else:
            assert grid == sms, (views, grid)
    assert bk.FUSED_MAX_VIEWS > 192


def test_ba_run_routes_by_views(dev):
    """"auto" takes lm_solve, one launch a BA, up to FUSED_MAX_VIEWS views
    (64: phase 9's global BA, 120 and 192 past the cluster, on K3's grid
    route inside the launch) and the per-iteration kernels past that;
    "fused" there raises, in ba.run and in lm_solve; the JAX package's
    "pallas" is the per-iteration kernels and "xla" the plain versions."""
    cfg = BundleAdjustConfig(max_iterations=5, function_tolerance=0.0)
    small = make_problem("quat", dev, 120, 500)
    large = make_problem("quat", dev, bk.FUSED_MAX_VIEWS + 1, 500)
    none = dict.fromkeys(("lm_solve", "schur_assemble", "camera_solve", "point_update_cost",
                          "lm_accept"), 0)
    fused = {**none, "lm_solve": 1}
    per_iteration = {**none, "schur_assemble": 5, "camera_solve": 5, "point_update_cost": 6}
    at_192 = make_problem("quat", dev, 192, 1000)
    for problem, impl, launched in ((small, "auto", fused), (large, "auto", per_iteration),
                                    (make_problem("quat", dev, 64, 2000), "auto", fused),
                                    (at_192, "auto", fused), (small, "fused", fused),
                                    (small, "pallas", per_iteration), (small, "xla", none)):
        bk.reset_launch_counts()
        ba.run(*problem, True, dataclasses.replace(cfg, impl=impl))
        assert bk.launch_counts() == launched, (impl, bk.launch_counts())
        if problem is at_192:  # its camera solve: K3's grid route inside the launch
            assert bk.fused_route_launches() == {**dict.fromkeys(bk.CAMERA_SOLVE_ROUTES, 0),
                                                 "grid": 1}
    with pytest.raises(ValueError, match="fused"):
        ba.run(*large, True, dataclasses.replace(cfg, impl="fused"))
    cams, points, obs, mask = large
    pT, obsT, maskT = ba.prepare(points, obs, mask)
    p2, r2, c2 = bk.lm_buffers(pT, cams.rot, ba.pack_camp(cams))
    with pytest.raises(ValueError, match=f"{bk.FUSED_MAX_VIEWS} views"):
        bk.lm_solve("quat", p2, obsT, maskT, r2, c2, cam_mod.free_mask(cams).float(), 1.0, True,
                    CFG, 5)


@pytest.mark.parametrize("views", [16, 64, 192])
def test_lm_solve_refused_launch_raises(dev, monkeypatch, views):
    """A launch the runtime refuses (here the library answers 720,
    cudaErrorCooperativeLaunchTooLarge, as for a grid that cannot be
    resident) raises out of lm_solve and ba.run: nothing runs the
    per-iteration kernels or the plain version in its place."""
    real = bk.library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(real, name)

        def osfm_lm_fused(self, *args):
            return 720

    problem = make_problem("quat", dev, views, 1000)
    monkeypatch.setattr(bk, "library", lambda: Refusing())
    bk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="lm_solve: CUDA error 720"):
        ba.run(*problem, True, BundleAdjustConfig(max_iterations=5))
    assert bk.launch_counts() == dict.fromkeys(bk.launch_counts(), 0)


# ---------------------------------------------------------------------------
# top2 (match_kernels.cu)

NEAR_TIE = 1e-5


def _top2_stack(dev, V, N, D, seed=0):
    """Unit descriptors with exact duplicates: view 1 holds every row twice
    and view 2 starts with view 1's duplicated rows, so their queries tie
    exactly."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randn((V, N, D), generator=gen, device=dev)
    d /= torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    half = N // 2
    d[1, half:2 * half] = d[1, :half]
    d[2, :half // 2] = d[1, :half // 2]
    return d


def _agree(got, ref, rows):
    """Kernel outputs (best, second, idx) against the plain version's: d2 to
    NEAR_TIE, indices outside near ties."""
    (kb, ks, ki), (rb, rs, ri) = got, ref
    assert float((kb - rb).abs().max()) < NEAR_TIE
    assert float((ks - rs).abs().max()) < NEAR_TIE
    near = ((rs - rb) <= NEAR_TIE) | ~rows
    assert bool(torch.all((ki == ri) | near))


def _cols(pairs, dev):
    return [torch.tensor(c, dtype=torch.int32, device=dev) for c in zip(*pairs)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("N", [300, 1000, 8200])
def test_top2_kernel_matches_plain(dev, D, N):
    """Both directions from one launch. N is no multiple of the 128-row
    tile; the pairs repeat views, match a view against itself, end in ragged
    prefixes and have databases of 0 and 1 valid rows and one query row. The
    swapped pair table's forward outputs are the backward ones bit for bit,
    and two runs are identical."""
    d = _top2_stack(dev, 5, N, D)
    pairs = [(0, 1, N, N), (2, 1, N, N), (1, 1, N, N), (1, 0, N, N), (3, 4, N - 37, N - 101),
             (4, 3, N, 0), (0, 2, N, 1), (2, 3, 1, N)]
    cols = _cols(pairs, dev)
    before = mk.top2.launches
    out = mk.top2(d, *cols, impl="kernel")
    assert mk.top2.launches == before + 1
    again = mk.top2(d, *cols, impl="kernel")
    swapped = mk.top2(d, cols[1], cols[0], cols[3], cols[2], impl="kernel")
    ref = mk.top2_ref(d, *cols)
    iota = torch.arange(N, device=dev)[None, :]
    _agree(out[:3], ref[:3], iota < cols[2][:, None])
    _agree(out[3:], ref[3:], iota < cols[3][:, None])
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    for a, b in zip(out[3:] + out[:3], swapped):
        assert torch.equal(a, b)
    kb, ks, ki, bb, bs, bi = out
    # exact ties go to the lower index in both directions: view 1 holds its
    # first half twice, view 2 starts with view 1's first quarter
    half, q = N // 2, N // 4
    assert bool(torch.all(ki[1, :q] == torch.arange(q, device=dev)))
    assert bool(torch.all(kb[1, :q] == ks[1, :q]))
    assert bool(torch.all(bi[1, :q] == torch.arange(q, device=dev)))
    assert bool(torch.all(bi[2, :2 * half] == torch.arange(2 * half, device=dev) % half))
    assert bool(torch.all(bb[2, :2 * half] == bs[2, :2 * half]))
    # empty database, one valid row, one query row, rows past the counts
    for t in (kb[5], ks[5], bb[5], bs[5]):
        assert bool(torch.all(t == 4.0))
    assert bool(torch.all(ki[5] == 0) & torch.all(bi[5] == 0))
    assert bool(torch.all(ks[6] == 4.0) & torch.all(ki[6] == 0) & torch.all(kb[6] < 4.0))
    assert bool(torch.all(bb[6, 1:] == 4.0) & torch.all(bi[6, 1:] == 0) & (bb[6, 0] < 4.0))
    assert bool(torch.all(kb[7, 1:] == 4.0) & torch.all(ki[7, 1:] == 0))
    assert bool(torch.all(bs[7] == 4.0) & torch.all(bi[7] == 0) & torch.all(bb[7] < 4.0))
    assert bool(torch.all(kb[4, N - 37:] == 4.0) & torch.all(ki[4, N - 37:] == 0))
    assert bool(torch.all(bb[4, N - 101:] == 4.0) & torch.all(bi[4, N - 101:] == 0))
    assert bool(torch.all(ki[4, :N - 37] < N - 101) & torch.all(bi[4, :N - 101] < N - 37))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("N", [300, 1000, 8200])
def test_match_pairs_batched_kernel_matches_plain(dev, D, N):
    """One launch a call; the cross-checked matches equal the plain path's
    except on rows with a near tie in either direction."""
    d = _top2_stack(dev, 4, N, D, seed=1)
    m0 = N // 4
    d[3, m0:2 * m0] = d[0, :m0]
    cols = _cols([(0, 3, N, N), (1, 2, N - 50, N), (2, 2, N, N)], dev)
    before = mk.top2.launches
    m_k = match_ops.match_pairs_batched(d, *cols, impl="kernel")
    assert mk.top2.launches == before + 1
    m_t = match_ops.match_pairs_batched(d, *cols, impl="torch")
    assert int((m_k[0, :m0] == torch.arange(m0, 2 * m0, device=dev)).sum()) == m0
    rb, rs, _, bb, bs, _ = mk.top2_ref(d, *cols)
    near = ((rs - rb) <= NEAR_TIE) | ((bs - bb) <= NEAR_TIE).any(dim=1, keepdim=True)
    assert bool(torch.all((m_k == m_t) | near))


def test_top2_segment_of_more_tiles_than_threads(dev):
    """16 pairs of 33000 rows: the launch plan gives each CTA a segment of
    258 database tiles, more than its 256 threads, so that some threads take
    two tickets; and the scratch splits the pairs over two launches. Query
    sides of 0 to 300 rows keep the products small; the databases end in
    the last tile, in tile 255 (a segment of 256 tiles) and short of it.
    Both directions agree with the plain version, and two runs are
    identical."""
    N, P = 33000, 16
    seg, chunk = mk.launch_plan(P, N)
    assert seg > 255 and chunk < P
    d = _top2_stack(dev, 3, N, 64, seed=2)
    ci = [200, 128, 1, 300, 0, 129, 257, 5] * 2
    cj = [N, N - 37, 32700, 32769, N, 33000 - 128, 1000, N] * 2
    pairs = [(k % 3, (k + 1) % 3, ci[k], cj[k]) for k in range(P)]
    cols = _cols(pairs, dev)
    before = mk.top2.launches
    out = mk.top2(d, *cols, impl="kernel")
    assert mk.top2.launches == before + -(-P // chunk)
    again = mk.top2(d, *cols, impl="kernel")
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    iota = torch.arange(N, device=dev)[None, :]
    for s in range(0, P, 4):  # the plain version's (4, N, N) blocks a few at a time
        sub = [c[s:s + 4] for c in cols]
        ref = mk.top2_ref(d, *sub)
        _agree([t[s:s + 4] for t in out[:3]], ref[:3], iota < sub[2][:, None])
        _agree([t[s:s + 4] for t in out[3:]], ref[3:], iota < sub[3][:, None])


@pytest.mark.parametrize("D", [64, 128])
def test_top2_pairs_split_over_launches(dev, monkeypatch, D):
    """When the partials would pass SCRATCH_BYTES the wrapper launches once
    for each slice of pairs: the outputs equal the one-launch outputs bit for
    bit and agree with the plain version."""
    N = 1000
    d = _top2_stack(dev, 5, N, D)
    pairs = [(0, 1, N, N), (2, 1, N, N), (1, 1, N, N), (1, 0, N, N), (3, 4, N - 37, N - 101),
             (4, 3, N, 0), (0, 2, N, 1), (2, 3, 1, N)]
    cols = _cols(pairs, dev)
    one = mk.top2(d, *cols, impl="kernel")
    seg, chunk = mk.launch_plan(len(pairs), N)
    assert chunk == len(pairs)
    nt = -(-N // mk.TILE)
    monkeypatch.setattr(mk, "SCRATCH_BYTES", 3 * 12 * N * (-(-nt // seg) + nt))
    assert mk.launch_plan(len(pairs), N) == (seg, 3)
    before = mk.top2.launches
    split = mk.top2(d, *cols, impl="kernel")
    assert mk.top2.launches == before + 3
    for a, b in zip(one, split):
        assert torch.equal(a, b)
    ref = mk.top2_ref(d, *cols)
    iota = torch.arange(N, device=dev)[None, :]
    _agree(split[:3], ref[:3], iota < cols[2][:, None])
    _agree(split[3:], ref[3:], iota < cols[3][:, None])


def test_top2_kernel_takes_the_two_descriptor_widths(dev):
    """The kernel is built for D = 64 and 128; another width on the card
    raises (the plain version, impl="torch", takes any)."""
    d = _top2_stack(dev, 3, 300, 96)
    cols = _cols([(0, 1, 300, 300)], dev)
    with pytest.raises(ValueError, match="widths"):
        mk.top2(d, *cols, impl="kernel")
    assert mk.top2(d, *cols, impl="torch")[0].shape == (1, 300)


def test_top2_pair_out_of_range_is_marked_without_a_host_sync(dev):
    """A pair out of range is not read: (NaN, NaN, -1) on its rows both ways,
    match_pairs_batched marks them, and the pull raises. Neither call syncs
    the host (torch's sync debug mode would raise)."""
    d = _top2_stack(dev, 3, 300, 64)
    cols = _cols([(0, 1, 300, 300), (0, 3, 300, 300), (0, 1, 301, 300), (-1, 1, 300, 2)], dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = mk.top2(d, *cols, impl="kernel")
        m = match_ops.match_pairs_batched(d, *cols, impl="kernel")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = mk.top2_ref(d, *cols)
    rows = torch.ones((1, 300), dtype=torch.bool, device=dev)
    _agree([t[:1] for t in out[:3]], [t[:1] for t in ref[:3]], rows)
    _agree([t[:1] for t in out[3:]], [t[:1] for t in ref[3:]], rows)
    for t in out:
        bad = t[1:]
        assert bool(torch.isnan(bad).all() if t.is_floating_point() else torch.all(bad == -1))
    assert bool(torch.all(m[1:] == match_ops.BAD_PAIR)) and bool(torch.all(m[0] >= -1))
    with pytest.raises(ValueError, match="out"):
        match_ops.check_pulled(m.cpu().numpy())
    with pytest.raises(ValueError, match="out"):
        pipeline_matching._batched_pair_matches(d, np.array([301, 300, 300]), [(0, 1)], 0.8)


def test_top2_kernel_that_fails_to_build_raises(dev, monkeypatch, tmp_path):
    """No fallback to the plain version: a kernel whose build fails raises
    at the call."""
    src = tmp_path / "match_kernels.cu"
    src.write_text(mk.SOURCE.read_text() + "\n#error deliberately broken\n")
    monkeypatch.setattr(mk, "SOURCE", src)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "_build")
    mk.library.cache_clear()
    try:
        d = _top2_stack(dev, 3, 128, 64)
        cols = [torch.tensor([c], dtype=torch.int32, device=dev) for c in (0, 1, 128, 128)]
        with pytest.raises(RuntimeError, match="failed to build"):
            mk.top2(d, *cols)
    finally:
        mk.library.cache_clear()


# ---------------------------------------------------------------------------
# BA past shared memory: K1's camera tables and per-view sums (308 bytes a
# view) leave shared memory past ~600 views, K2's tables (208 bytes a view)
# past ~990; K3 takes its grid route from GRID_MIN_V views, at any size.


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("shape", [(700, 400), (1100, 300), (2000, 200)])
def test_stages_match_plain_versions_past_shared_memory(dev, kind, shape):
    """At 700 views K1 reads its global camera tables and sums in place, K2
    still builds its tables in shared memory; at 1100 and 2000 both read
    global tables. K1 and K2 against their plain versions at both lambdas
    (the tolerances of test_stages_match_plain_versions). K3 (n = 4200,
    6600, 12000: the grid route) against the f64 solve of the same prepared
    system: no further from it than twice the plain f32 LU is, since at this
    n both carry the f32 rounding of a factorization of size n."""
    inputs = _stage_inputs(kind, dev, *shape)
    pT, obsT, maskT, rot, camp, free = inputs
    assert bk.library().osfm_schur_table_floats(shape[0]) > 0
    assert (bk.library().osfm_k2_table_floats(shape[0]) > 0) == (shape[0] > 1000)
    args = (kind, *_lm(inputs), bk.new_state(1e-3, dev), 1.0, True)
    S, dU, rhs = bk.schur_assemble(*args)
    S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
    assert max(_rel(S, S_r), _rel(dU, dU_r), _rel(rhs, rhs_r)) < 1e-4
    for lam in K2_LAMBDAS:
        sargs = (S_r, dU_r, rhs_r, free, lam, rot, camp)
        delta, _, _ = _camera_step(kind, bk.camera_solve, *sargs)
        delta_r, rot_cr, camp_cr = _camera_step(kind, bk.camera_solve_ref, *sargs)
        delta_64 = ba._solve_camera_system(S_r.double(), dU_r.double(), rhs_r.double(), free,
                                           torch.tensor(lam, dtype=torch.float64, device=dev))
        assert _rel(delta.double(), delta_64) <= 2.0 * _rel(delta_r.double(), delta_64) + 1e-6
        _check_point_update_cost(kind, inputs, True, lam, delta_r, rot_cr, camp_cr)


@pytest.mark.parametrize("num_views", [700, 1100])
def test_stages_are_bit_stable_past_shared_memory(dev, num_views):
    """The global tables and in-place sums keep the fixed summation order:
    two launches of K1 and of K2 give the same bits."""
    inputs = _stage_inputs("quat", dev, num_views, 300)
    args = ("quat", *_lm(inputs), bk.new_state(1e-3, dev), 1.0, True)
    for a, b in zip(bk.schur_assemble(*args), bk.schur_assemble(*args)):
        assert torch.equal(a, b)
    pT, obsT, maskT, rot, camp, free = inputs
    S, dU, rhs = bk.normal_eq_schur_ref(*args)
    delta, rot_c, camp_c = _camera_step("quat", bk.camera_solve_ref, S, dU, rhs, free, 1e-3,
                                        rot, camp)
    stage, (p2, _, _) = _fused_stage("quat", inputs, True, rot_c, camp_c, False)
    runs = []
    for _ in range(2):
        s_in = bk.new_state(1e-3, dev)
        s_in[bk.COST] = 1e30
        s_out = torch.zeros_like(s_in)
        runs.append((stage(s_in, s_out, delta).clone(), s_out, p2[1].clone()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("num_views", [700, 1100])
def test_ba_run_past_shared_memory(dev, num_views):
    """ba.run's default route (the kernels on the card) at 700 and 1100
    views of 2000 tracks converges like the plain path."""
    cams, points, obs, mask = make_problem("quat", dev, num_views, 2000)
    cfg = BundleAdjustConfig(max_iterations=10, function_tolerance=0.0, min_lambda=1e-12)
    bk.reset_launch_counts()
    r_k = ba.run(cams, points, obs, mask, True, cfg)
    counts = bk.launch_counts()
    r_t = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    assert counts == {"lm_solve": 0, "schur_assemble": 10, "camera_solve": 10,
                      "point_update_cost": 11, "lm_accept": 0}, counts
    np.testing.assert_allclose(float(r_k.initial_cost), float(r_t.initial_cost), rtol=1e-5)
    assert float(r_k.cost) < float(r_k.initial_cost) * 1e-2
    assert float(r_k.cost) < float(r_t.cost) * 1.5 + 1e-6


def test_ba_run_at_2000_views_runs_on_the_grid_route(dev):
    """Past the cluster's 1365 views ba.run's default route stays on the
    kernels: K1, K3 by its grid route and K2, converging like the plain
    path (2000 views x 2000 tracks, 10 iterations)."""
    cams, points, obs, mask = make_problem("quat", dev, 2000, 2000)
    cfg = BundleAdjustConfig(max_iterations=10, function_tolerance=0.0, min_lambda=1e-12)
    bk.reset_launch_counts()
    r_k = ba.run(cams, points, obs, mask, True, cfg)
    counts, routes = bk.launch_counts(), bk.route_launches()
    r_t = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    assert counts == {"lm_solve": 0, "schur_assemble": 10, "camera_solve": 10,
                      "point_update_cost": 11, "lm_accept": 0}, counts
    assert routes["grid"] == 10, routes
    np.testing.assert_allclose(float(r_k.initial_cost), float(r_t.initial_cost), rtol=1e-5)
    assert float(r_k.cost) < float(r_k.initial_cost) * 1e-2
    assert float(r_k.cost) < float(r_t.cost) * 1.5 + 1e-6


def _solve_inputs(dev, num_views, n_tracks=300):
    """The plain reduced camera system of the standard problem at lambda
    1e-3, its LM buffers and its f64 solve."""
    inputs = _stage_inputs("quat", dev, num_views, n_tracks)
    pT, obsT, maskT, rot, camp, free = inputs
    S, dU, rhs = bk.normal_eq_schur_ref("quat", *_lm(inputs), bk.new_state(1e-3, dev), 1.0, True)
    d64 = ba._solve_camera_system(S.double(), dU.double(), rhs.double(), free,
                                  torch.tensor(1e-3, dtype=torch.float64, device=dev))
    return (S, dU, rhs, free, 1e-3, rot, camp), d64


@pytest.mark.parametrize("num_views", [192, 700, 1100, 2000])
def test_camera_solve_grid_route_against_f64(dev, num_views):
    """K3's grid route no further from the f64 solve than twice the plain
    f32 LU is (the bound PR 6 held the cluster to), its candidate cameras
    within 1e-6 of the retraction of the plain step, and two solves bit for
    bit (no float atomics); 192 views is the main path's shape past 119
    views (chip_smoke.py phase 11)."""
    sargs, d64 = _solve_inputs(dev, num_views)
    assert bk.camera_solve_route(num_views) == "grid"
    solve = lambda *a: bk.camera_solve(*a, route="grid")  # noqa: E731
    delta, rot_c, camp_c = _camera_step("quat", solve, *sargs)
    delta_r, rot_cr, camp_cr = _camera_step("quat", bk.camera_solve_ref, *sargs)
    assert _rel(delta.double(), d64) <= 2.0 * _rel(delta_r.double(), d64) + 1e-6
    again, _, _ = _camera_step("quat", solve, *sargs)
    assert torch.equal(delta, again)
    assert torch.isfinite(delta).all()


@pytest.mark.parametrize("num_views", [130, 1001])
def test_camera_solve_grid_route_on_ragged_panels_against_f64(dev, num_views):
    """n = 6V not a multiple of the 128-wide panels (780 and 6006: a last
    panel of 12 and of 118 columns): within the bound of
    test_camera_solve_grid_route_against_f64, and finite."""
    sargs, d64 = _solve_inputs(dev, num_views)
    solve = lambda *a: bk.camera_solve(*a, route="grid")  # noqa: E731
    delta, _, _ = _camera_step("quat", solve, *sargs)
    delta_r, _, _ = _camera_step("quat", bk.camera_solve_ref, *sargs)
    assert torch.isfinite(delta).all()
    assert _rel(delta.double(), d64) <= 2.0 * _rel(delta_r.double(), d64) + 1e-6


@pytest.mark.parametrize("num_views", [128, 700])
def test_camera_solve_grid_route_on_an_indefinite_system(dev, num_views):
    """-S' is indefinite: the grid route meets a pivot that is not positive
    and gives an all-NaN delta, as the other routes do; with state[DONE] set
    it writes no candidate camera."""
    (S, dU, rhs, free, lam, rot, camp), _ = _solve_inputs(dev, num_views)
    solve = lambda *a: bk.camera_solve(*a, route="grid")  # noqa: E731
    delta, _, _ = _camera_step("quat", solve, -S, dU, rhs, free, lam, rot, camp)
    assert torch.isnan(delta).all()
    r2, c2 = bk.lm_buffers(rot, camp)
    r2[1].fill_(7.0)
    done = bk.new_state(lam, dev)
    done[bk.DONE] = 1.0
    bk.camera_solve("quat", S, dU, rhs, free, done, r2, c2, route="grid")
    assert bool((r2[1] == 7.0).all())


def test_camera_solve_grid_route_bit_for_bit_in_three_launches(dev):
    """At 2000 views (n = 12000) two solves give the same bits, delta and
    candidate cameras (no float atomics, one summation order), and a solve
    is three launches: grid_init, the cooperative grid_solve, grid_finish."""
    from torch.profiler import ProfilerActivity, profile

    sargs, _ = _solve_inputs(dev, 2000)
    solve = lambda *a: bk.camera_solve(*a, route="grid")  # noqa: E731
    first = _camera_step("quat", solve, *sargs)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = _camera_step("quat", solve, *sargs)
        torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    names = [e.key for e in prof.key_averages() for _ in range(e.count) if "grid_" in e.key]
    assert len(names) == 3, names
    assert sum("grid_solve" in k for k in names) == 1, names


def test_grid_solve_stamps_only_in_the_timing_build(dev):
    """The grid route's barrier stamps (scripts/torch_k3_routes.py --split)
    are compiled into the timing build alone: the main path's library has
    no osfm_grid_solve_stamps. The timing build's grid_solve stamps its
    barriers in order (kinds 0 to 5, the timer never going back) and solves
    as the main build does."""
    assert not hasattr(bk.library(), "osfm_grid_solve_stamps")
    lib = bk.timing_library()
    sargs, _ = _solve_inputs(dev, 192)
    main = _camera_step("quat", lambda *a: bk.camera_solve(*a, route="grid"), *sargs)
    stamps = torch.zeros(4096, dtype=torch.int64, device=dev)
    lib.osfm_grid_solve_stamps(stamps.data_ptr())
    try:
        timed = _camera_step("quat", lambda *a: bk.camera_solve(*a, route="grid", lib=lib),
                             *sargs)
        torch.cuda.synchronize()
    finally:
        lib.osfm_grid_solve_stamps(None)
    for a, b in zip(main, timed):
        assert _rel(b.double(), a.double()) < 1e-6
    s = stamps.cpu().tolist()
    count, kinds, times = s[0], s[1:1 + 2 * s[0]:2], s[2:2 + 2 * s[0]:2]
    assert count > 2 * 9, count  # 9 panels at n = 1152: a row solve and an update each
    assert set(kinds) <= set(range(6)) and {1, 2, 3} <= set(kinds), kinds
    assert times == sorted(times)


def test_camera_solve_route_crossover(dev):
    """The automatic route: one warp up to 5 views, one CTA up to 37, the
    cluster below GRID_MIN_V (120) and the grid route from there, for the
    per-iteration kernels and inside lm_fused alike (one rule keeps their
    bits the same); in its own launch the grid route is the faster from ~96
    views, but as lm_fused's solve stage, the route "auto" runs there, the
    cluster stays the faster up to 119 (scripts/torch_k3_routes.py
    --fused). The cluster refuses
    past 1365 views, the grid route serves every size. At the crossover the
    cluster and the grid route solve the same system alike."""
    route = bk.camera_solve_route
    assert [route(v) for v in (1, 5, 6, 37, 38, 119, 120, 1365, 5000)] == [
        "warp", "warp", "cta", "cta", "cluster", "cluster", "grid", "grid", "grid"]
    assert route(1365, "cluster") == "cluster" and route(3, "grid") == "grid"
    for v, r in ((1366, "cluster"), (6, "warp"), (64, "cta"), (5, "cta")):
        with pytest.raises(ValueError, match=f"{r} route cannot serve {v} views"):
            route(v, r)
    sargs, d64 = _solve_inputs(dev, 120)
    steps = {r: _camera_step("quat", lambda *a, r=r: bk.camera_solve(*a, route=r), *sargs)
             for r in ("cluster", "grid")}
    delta_r, _, _ = _camera_step("quat", bk.camera_solve_ref, *sargs)
    for r, (delta, _, _) in steps.items():
        assert _rel(delta.double(), d64) <= 2.0 * _rel(delta_r.double(), d64) + 1e-6, r
    assert _rel(steps["grid"][0], steps["cluster"][0]) < 1e-5


@pytest.mark.parametrize("shape", [(3, 7800), (16, 8192), (64, 4096), (2000, 200)])
def test_split_mode_then_lm_accept_is_the_folded_tail(dev, shape):
    """K2 in split mode (the last CTA sums the cost, no rule) then K4
    lm_accept gives the folded tail's state, points and cameras bit for bit:
    the initial cost and one LM step, accepted."""
    inputs = _stage_inputs("quat", dev, *shape)
    pT, obsT, maskT, rot, camp, free = inputs
    cfg = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)
    outs = []
    for split in (False, True):
        p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
        st = torch.zeros((2, bk.STATE_SIZE), device=dev)
        k2 = bk.PointUpdateCost("quat", p2, obsT, maskT, r2, c2, free, 1.0, True, cfg, split=split)
        bk.reset_launch_counts()
        if split:
            bk.lm_accept(k2(None, None), None, st[0], cfg)
        else:
            k2(None, st[0])
        S, dU, rhs = bk.schur_assemble("quat", p2, obsT, maskT, r2, c2, free, st[0], 1.0, True)
        delta = bk.camera_solve("quat", S, dU, rhs, free, st[0], r2, c2)
        if split:
            bk.lm_accept(k2(st[0], None, delta), st[0], st[1], cfg)
        else:
            k2(st[0], st[1], delta)
        assert bk.launch_counts()["lm_accept"] == (2 if split else 0)
        outs.append((st, p2, r2, c2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert float(outs[0][0][1, bk.CUR]) == 1.0


def test_sharded_ba_of_one_rank_over_nccl_is_ba_run(dev):
    """parallel.ba_sharded on a process group of one rank over NCCL: K1,
    the all_reduce of S, dU and rhs, K3, K2 in split mode, the all_reduce of
    the cost and K4 give ba.run's bits (16 views x 8192 tracks, 15
    iterations)."""
    import socket

    import torch.distributed as dist

    from orthosfm_torch.parallel import ba_sharded, mesh as mesh_mod

    with socket.socket() as sock:  # a free localhost port for the group's store
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cams, points, obs, mask = make_problem("quat", dev, 16, 8192)
    cfg = BundleAdjustConfig(max_iterations=15, function_tolerance=0.0, min_lambda=1e-12)
    ref = ba.run(cams, points, obs, mask, True, cfg)
    mesh = mesh_mod.init_distributed(f"tcp://localhost:{port}", 1, 0, "nccl")
    try:
        padded, T = ba_sharded.pad_tracks([points, obs, mask], mesh.size)
        bk.reset_launch_counts()
        res = ba_sharded.make_sharded_ba(mesh, True, cfg)(
            cams, *ba_sharded.shard_track_arrays(mesh, padded))
        counts = bk.launch_counts()
    finally:
        dist.destroy_process_group()
    assert counts == {"lm_solve": 0, "schur_assemble": 15, "camera_solve": 15,
                      "point_update_cost": 16, "lm_accept": 16}, counts
    assert torch.equal(res.cams.rot, ref.cams.rot) and torch.equal(res.points, ref.points)
    assert float(res.cost) == float(ref.cost) and int(res.iterations) == int(ref.iterations)


# ---------------------------------------------------------------------------
# The slice's entry points on the card


def test_load_tracks_runs_on_the_card_by_default(tmp_path, dev):
    from orthosfm_torch.data import synthetic
    from orthosfm_torch.io import tracks_io

    ds = synthetic.generate_dataset(synthetic.sphere_cloud(100), num_views=4, seed=0)
    path = str(tmp_path / "tracks.txt")
    tracks_io.save_tracks(ds.tracks, path)
    tracks = tracks_io.load_tracks(path, np.arange(4))
    assert tracks.obs.is_cuda
    plain = tracks_io.load_tracks_plain(path, np.arange(4))
    assert torch.equal(tracks.obs.cpu(), plain.obs)


def test_ransac_h_on_the_card_matches_its_cpu_run(dev):
    """The same injected samples: inlier masks equal, and the two H map every
    valid point within 0.5 px of each other. The refinement's 8×8 normal
    equations of pixel coordinates up to 1000 are ill-conditioned in f32, so
    cuSOLVER's and the CPU's solves part in H's entries by up to ~2e-3 of
    max |H| (measured), a fraction of a pixel where the points lie."""
    from orthosfm_torch.ops import ransac_h

    rng = np.random.default_rng(0)
    P, M, iters = 6, 300, 2000
    H0 = np.array([[1.02, 0.05, 12.0], [-0.03, 0.98, -7.0], [1e-5, -2e-5, 1.0]])
    a = rng.uniform(0, 1000, (P, M, 2))
    q = np.concatenate([a, np.ones((P, M, 1))], -1) @ H0.T
    b = q[..., :2] / q[..., 2:3] + rng.normal(0, 2.0, (P, M, 2))
    b[:, : M // 4] += rng.uniform(-200, 200, (P, M // 4, 2))
    valid = np.arange(M)[None, :] < np.array([M, M - 20, M - 50, 100, 60, 40])[:, None]
    counts = torch.as_tensor(valid.sum(1))
    samples = ransac_h.draw_samples(counts, iters, torch.Generator().manual_seed(0))
    args = [torch.as_tensor(x) for x in (a.astype(np.float32), b.astype(np.float32), valid)]
    cpu = ransac_h.find_homography_batched_keys(*args, samples)
    gpu = ransac_h.find_homography_batched_keys(*(x.to(dev) for x in args), samples.to(dev))
    assert torch.equal(gpu.inliers.cpu(), cpu.inliers)
    x1 = torch.cat([args[0], torch.ones((P, M, 1))], dim=-1)
    q_c = x1 @ cpu.homography.transpose(1, 2)
    q_g = x1 @ gpu.homography.cpu().transpose(1, 2)
    moved = torch.linalg.vector_norm(q_g[..., :2] / q_g[..., 2:] - q_c[..., :2] / q_c[..., 2:],
                                     dim=-1)
    assert float(moved[args[2]].max()) < 0.5


def test_noise_sweep_on_the_card(dev):
    """Sphere at the sweep's full size (16 views, 2048 tracks), solvers 0 and
    3, σ ∈ {0, 1} px: under 0.01° and 0.25° (chip_smoke.py phase 6 runs the
    three datasets at 0, 1 and 10 px)."""
    from orthosfm_torch.config import SolverType
    from orthosfm_torch.testbench import synthetic_tests

    res = synthetic_tests.run_noise_sweep(
        datasets=("Sphere",), solvers=(SolverType(0), SolverType(3)), noise_levels=(0.0, 1.0),
        verbose=False)
    assert len(res) == 4 and not any(r.failed for r in res)
    for r in res:
        assert r.mean_angular_error_deg < (0.01 if r.noise_px == 0.0 else 0.25), r


def test_full_pipeline_dataset_on_the_card(tmp_path, dev):
    """dataset_matrix's SphereCircle (12 views of 320², rendered on the card)
    through the in-process harness, solvers 0 and 3: under 1°."""
    from orthosfm_torch.testbench import full_pipeline, render, run

    name, scene, ring, views, width, theta, roll, solvers = run.dataset_matrix(320)[0][:8]
    ds = tmp_path / "data" / name
    gt = render.make_image_dataset(str(ds / "images"), num_views=views, width=width,
                                   height=width, seed=sum(name.encode()) % 1000,
                                   ring_degrees=ring, theta_range=theta, roll_range=roll,
                                   scene=scene, device=dev)
    full_pipeline.write_references(str(ds / "references.txt"), gt,
                                   [f"view_{i:02d}.png" for i in range(views)])
    configs = [full_pipeline.RunConfiguration(run.SOLVER_NAMES[s], s) for s in solvers]
    res = full_pipeline.run_full_pipeline_tests(str(tmp_path / "proj"), str(tmp_path / "data"),
                                                [name], configs, repetitions=1,
                                                in_process=True, verbose=False)
    assert [r.config for r in res] == ["Quaternion", "EulerAllDoF"]
    for r in res:
        assert r.mean_angular_error < 1.0, r


# ---------------------------------------------------------------------------
# The BA bench (orthosfm_torch/bench.py), entry() and use_pallas=False

NO_LAUNCH = dict.fromkeys(("lm_solve", "schur_assemble", "camera_solve", "point_update_cost",
                           "lm_accept"), 0)


def test_bench_routes_launch_their_kernels(dev):
    """time_ba's routes by their launches over every call: "auto" one
    lm_fused a solve, "pallas" K1, K3 and K2 an iteration (K2 once more for
    the initial cost), "xla" nothing; the Euler key "auto" too."""
    from orthosfm_torch import bench

    iters = 5
    cams, points, obs, mask = bench.make_problem(dev, 16, 2048)
    for c, impl, per_call in (
            (cams, "auto", {**NO_LAUNCH, "lm_solve": 1}),
            (cams, "pallas", {**NO_LAUNCH, "schur_assemble": iters, "camera_solve": iters,
                              "point_update_cost": iters + 1}),
            (cams, "xla", NO_LAUNCH),
            (bench.euler_cameras(cams), "auto", {**NO_LAUNCH, "lm_solve": 1})):
        t = bench.time_ba(dev, c, points, obs, mask, iters=iters, repeats=1, impl=impl, calls=3)
        assert t.iterations == iters and t.calls == 5
        assert t.launches == {k: v * t.calls for k, v in per_call.items()}, (impl, t.launches)
        assert t.iter_per_s > 0 and t.synced_iter_per_s > 0


def test_bench_value_is_under_its_device_bound(dev):
    """The pipelined "auto" rate at the bench's size cannot exceed the
    iterations over one lm_fused solve's device time."""
    from orthosfm_torch import bench

    problem = bench.make_problem(dev)
    t = bench.time_ba(dev, *problem, repeats=2, calls=10)
    bound = bench.device_bound(*problem)
    assert t.iterations == 30 and 0 < t.iter_per_s <= bound["iter_per_s"], (t, bound)


def test_entry_on_the_card(dev):
    """entry() at its real size (16 views x 2048 tracks, 5 iterations): one
    lm_fused launch a call, two calls bit for bit, and within
    test_lm_solve_agrees_with_its_plain_version's tolerances of the plain
    route on the card (the cost, at the f32 floor after 5 iterations, within
    the floor tests/test_torch_graft_entry.py derives)."""
    from orthosfm_torch import entry as entry_mod

    fn, args = entry_mod.entry()
    assert args[1].device.type == "cuda"
    bk.reset_launch_counts()
    a = fn(*args)
    b = fn(*args)
    assert bk.launch_counts() == {**NO_LAUNCH, "lm_solve": 2}
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    plain, _ = entry_mod.entry(dev, impl="torch")
    bk.reset_launch_counts()
    ref = plain(*args)
    assert bk.launch_counts() == NO_LAUNCH
    floor = 0.5 * 2 * int(args[3].sum()) * (float(np.spacing(np.float32(2048.0))) / 2) ** 2
    assert 0.0 < float(a[0]) < floor and 0.0 < float(ref[0]) < floor
    np.testing.assert_allclose(float(a[0]), float(ref[0]), rtol=1e-3, atol=floor)
    torch.testing.assert_close(a[1], ref[1], rtol=1e-4, atol=2e-6)
    torch.testing.assert_close(a[2], ref[2], rtol=1e-3, atol=1e-5)


def test_use_pallas_false_launches_no_kernel(dev):
    """With use_pallas=False, "auto" is the plain route on the card: ba.run
    and the sharded BA (a mesh of one device) launch nothing and give the
    bits of impl="torch"; an explicit impl still launches its kernels."""
    from orthosfm_torch.parallel import ba_sharded, mesh as mesh_mod

    cams, points, obs, mask = make_problem("quat", dev, 16, 2048)
    cfg = BundleAdjustConfig(max_iterations=5, function_tolerance=0.0, use_pallas=False)
    sharded = ba_sharded.make_sharded_ba(mesh_mod.make_mesh(1, device=dev), True, cfg)
    bk.reset_launch_counts()
    r = ba.run(cams, points, obs, mask, True, cfg)
    s = sharded(cams, points, obs, mask)
    assert bk.launch_counts() == NO_LAUNCH
    ref = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    assert _same_result(r, ref)
    assert int(s.iterations) == 5 and float(s.cost) < float(s.initial_cost)
    ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="fused"))
    assert bk.launch_counts() == {**NO_LAUNCH, "lm_solve": 1}


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_ba_run_does_not_synchronize_the_host(dev, kind):
    """ba.run enqueues its whole solve: no call in it waits on the card
    (torch.cuda.set_sync_debug_mode("error") raises on one), on the fused,
    the per-iteration and the sharded route, so back-to-back calls pipeline
    as the bench's method assumes."""
    from orthosfm_torch.parallel import ba_sharded, mesh as mesh_mod

    cams, points, obs, mask = make_problem(kind, dev, 16, 2048)
    cfg = BundleAdjustConfig(max_iterations=5, function_tolerance=0.0)
    runs = [functools.partial(ba.run, cams, points, obs, mask, True,
                              dataclasses.replace(cfg, impl=impl)) for impl in ("fused", "kernel")]
    runs.append(functools.partial(ba_sharded.make_sharded_ba(mesh_mod.make_mesh(1, device=dev),
                                                             True, cfg), cams, points, obs, mask))
    for run in runs:
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(r.iterations) == 5


# ---------------------------------------------------------------------------
# The outlier filter's neighbour search (csrc/outlier_kernels.cu)

OUTLIER_TOL_ULPS = 4


def _nn_case(name, T, dev):
    """(points (T, 4) f32 with w = 1 on the card, has_pt (T,) bool, twins:
    index pairs of exact duplicates), from numpy, seeded."""
    rng = np.random.default_rng(T + len(name))
    pts = np.ones((T, 4), np.float32)
    pts[:, :3] = rng.normal(scale=0.7, size=(T, 3))
    has = rng.random(T) > 0.2
    twins = []
    if name == "duplicates":
        for a, b in ((3, T - 50), (17, 18), (T // 2, T - 1)):
            pts[b] = pts[a]
            has[a] = has[b] = True
            twins.append((a, b))
    elif name == "lone":
        has[:] = False
        has[T // 3] = True
    elif name == "all_unpointed":
        has[:] = False
    pts = torch.from_numpy(pts).to(dev)
    if name == "column_major":  # as ba.run hands the points back
        pts = pts.T.contiguous().T
    return pts, torch.from_numpy(has).to(dev), twins


@pytest.mark.parametrize("T", [700, 7800, 50000])
@pytest.mark.parametrize("name", ["holes", "duplicates", "lone", "all_unpointed",
                                  "column_major"])
def test_outlier_nn_matches_its_plain_version(dev, name, T):
    """The kernel against the plain sweep on the card, bit for bit (700 is
    ragged against the query blocks and the stages), one launch a call and
    no host sync."""
    from orthosfm_torch.ops import outlier_kernels as okern
    from orthosfm_torch.ops import outliers

    pts, has, twins = _nn_case(name, T, dev)
    ref = outliers.nearest_neighbor_distances(pts, has, impl="torch")
    before = okern.outlier_nn.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = outliers.nearest_neighbor_distances(pts, has)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert okern.outlier_nn.launches == before + 1
    assert torch.equal(got, ref)  # rounded where the plain sweep rounds
    sq = (pts.double() ** 2).sum(1)
    top = float(sq[has].max()) if bool(has.any()) else 0.0
    tol = OUTLIER_TOL_ULPS * torch.finfo(torch.float32).eps * (sq + top)
    gap = (got.double() ** 2 - ref.double() ** 2).abs()
    assert bool((gap[has] <= tol[has]).all()), float(gap[has].max())
    assert torch.equal(got[~has], torch.zeros_like(got[~has]))
    if int(has.sum()) == 1:
        assert float(got[has]) == float(ref[has]) == 1e6
    others = has.clone()
    for a, b in twins:
        # the twin is the nearest, at the expansion's rounding of 0
        assert float(got[a]) == float(got[b]) and float(got[a]) ** 2 <= float(tol[a])
        others[a] = others[b] = False
    assert bool((got[others] > 0).all())


def _cell_input(cell, dev):
    """(input, mix, config) of the first input of the benchmark cell
    from_tracks.CELL (its mix sfm_bench/mixes/CELL.json and its
    configuration's file, as BENCHMARK.json names them) at a fixed seed."""
    import json
    import pathlib

    from sfm_bench import port
    from sfm_bench.inputs import generate

    root = pathlib.Path(__file__).resolve().parents[1]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == f"from_tracks.{cell}")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    mix = json.loads((root / "sfm_bench" / "mixes" / f"{wl['traffic']}.json").read_text())
    fields = json.loads((root / entry["file"]).read_text())["reconstruction"]
    inp = generate.make_inputs(mix, 2147485011, "", dev)[0]
    return inp, mix, port.reconstruction_config(fields, inp.solver, inp.program_seed)


def _cell_job(cell, dev):
    """(tracks, widths, heights, config) of _cell_input's input, as the
    harness hands it to run_pose_estimation."""
    from sfm_bench import port

    inp, _, cfg = _cell_input(cell, dev)
    return port.trackset(inp.obs, dev), inp.wh[:, 0], inp.wh[:, 1], cfg


def _phase9_job(dev):
    """chip_smoke.py phase 9's reconstruction (testbench.scale_demo): 64
    views x 50 000 blob tracks at 1 px."""
    from orthosfm_torch.config import ReconstructionConfig, SolverType
    from orthosfm_torch.data import synthetic

    ds = synthetic.generate_dataset(synthetic.blob_cloud(50000, seed=0), num_views=64, seed=0,
                                    device=dev)
    noisy = synthetic.add_observation_noise(ds.tracks, 1.0, np.random.default_rng(0))
    w = np.full(64, 2048.0)
    return noisy, w, w, ReconstructionConfig(solver=SolverType.ORTHO_QUATERNION, seed=0)


@pytest.mark.parametrize("job", ["sweep16", "many64", "phase9"])
def test_outlier_filter_keeps_the_plain_routes_tracks(dev, monkeypatch, job):
    """At every filter_outlier_tracks call of a whole pose estimation, the
    kernel's route (one launch) and the plain route keep the same tracks
    (alive and has_point identical); phase 9's 64-view run calls it 20
    times."""
    from orthosfm_torch.ops import outlier_kernels as okern
    from orthosfm_torch.ops import outliers
    from orthosfm_torch.pipeline import incremental

    tracks, w, h, cfg = _phase9_job(dev) if job == "phase9" else _cell_job(job, dev)
    real_filter, plain = outliers.filter_outlier_tracks, outliers.nearest_neighbor_distances
    calls = []

    def both(ts, fcfg):
        before = okern.outlier_nn.launches
        got = real_filter(ts, fcfg)
        launched = okern.outlier_nn.launches - before
        with monkeypatch.context() as m:
            m.setattr(outliers, "nearest_neighbor_distances",
                      functools.partial(plain, impl="torch"))
            ref = real_filter(ts, fcfg)
        calls.append((launched, torch.equal(got.alive, ref.alive),
                      torch.equal(got.has_point, ref.has_point), int(ref.alive.sum())))
        return got

    monkeypatch.setattr(outliers, "filter_outlier_tracks", both)
    incremental.run_pose_estimation(tracks, w, h, cfg, verbose=False)
    assert calls and all(c[:3] == (1, True, True) for c in calls), calls
    if job == "phase9":
        assert len(calls) == 20


def test_ring192_job_runs_every_ba_as_one_lm_fused_launch_and_passes_the_judge(dev):
    """A whole job of the benchmark's from_tracks.ring192 (192 views x 4096
    tracks, 1 px): every view placed; every BA one lm_fused launch (no
    K1, K3 or K2 launch); the BA records' grid-route calls are lm_fused's
    grid-route launches, more than none, and the records' routes are the
    launches' routes; the answer within the cell's limits (the benchmark's
    judge)."""
    import json
    import pathlib

    from orthosfm_torch.pipeline import incremental
    from orthosfm_torch.utils import profiling
    from sfm_bench import port
    from sfm_bench.reference import judge

    inp, mix, cfg = _cell_input("ring192", dev)
    tracks = port.trackset(inp.obs, dev)
    bk.reset_launch_counts()
    rec = profiling.BARecorder()
    with rec.recording():
        res = incremental.run_pose_estimation(tracks, inp.wh[:, 0], inp.wh[:, 1], cfg,
                                              verbose=False)
    torch.cuda.synchronize(dev)
    assert len(res.present) == 192 and bool(np.all(res.present))
    s, calls = rec.summary(), rec.records()
    launches, by_route = bk.launch_counts(), bk.fused_route_launches()
    assert set(s["by_route"]) == {"fused"} and launches["lm_solve"] == s["ba_calls"]
    assert launches["schur_assemble"] == launches["camera_solve"] == 0
    assert launches["point_update_cost"] == 0
    grid = [c for c in calls if c["solve_route"] == "grid"]
    assert 0 < len(grid) == by_route["grid"]
    assert {k: r["ba_calls"] for k, r in s["by_solve_route"].items()} == {
        k: n for k, n in by_route.items() if n}
    assert all(c["views"] == 192 for c in grid)
    for c in calls:
        assert c["observations"] <= c["sum_views_sq"] <= c["views"] * c["observations"]
    root = pathlib.Path(__file__).resolve().parents[1] / "sfm_bench"
    limits = json.loads((root / "limits" / "from_tracks.ring192.json").read_text())
    job = {"obs": inp.obs, "wh": inp.wh, "gt_R": inp.gt_R, "noise_px": inp.noise_px}
    nums = judge.judge(port.answer(res, with_obs=False), job, mix["accuracy_bars"], dev)
    assert set(limits) <= set(nums) and all(nums[k] <= v for k, v in limits.items()), nums


TK_SOLVERS = {"quat": SolverType.ORTHO_QUATERNION, "euler": SolverType.ORTHO_EULER_ALL_DOF}


def _tk_scene(dev, solver, views=16, n_tracks=3000):
    """A blob seen by ``views`` views at 1 px: its tracks, the run's group
    schedule, the cameras of ``solver`` placed at the ground truth (the
    global cameras a run's later groups read their anchors in) and the
    run's configuration."""
    from orthosfm_torch.config import ReconstructionConfig
    from orthosfm_torch.data import synthetic
    from orthosfm_torch.data import tracks as tracks_mod
    from orthosfm_torch.pipeline import grouping

    ds = synthetic.generate_dataset(synthetic.blob_cloud(n_tracks, seed=0), num_views=views,
                                    seed=0, device=dev)
    tracks = synthetic.add_observation_noise(ds.tracks, 1.0, np.random.default_rng(0))
    view_ids = tracks.view_ids.cpu().numpy()
    groups = grouping.build_groups(view_ids, tracks_mod.incidence(tracks).cpu().numpy(), 3)
    wh = np.full(views, 2048.0)
    sched = grouping.schedule(groups, view_ids, wh, wh, dev)
    cfg = ReconstructionConfig(solver=TK_SOLVERS[solver], seed=0)
    cams = cam_mod.from_basis(cam_mod.basis(ds.gt_cameras), tracks.view_ids, *sched.sizes_t,
                              cfg.solver)
    return tracks, sched, cams, cfg


CAMERA_FIELDS = ("rot", "offset", "scale", "width", "height", "view_ids", "fixed")


@pytest.mark.parametrize("solver", list(TK_SOLVERS))
@pytest.mark.parametrize("case", ["first", "later", "fallback"])
def test_graphed_tk_is_the_eager_code_bit_for_bit(dev, monkeypatch, solver, case):
    """Five consecutive TK initializations drawing from one generator:
    through a CUDA graph (captured on the first call, replayed on the next
    four) each group's cameras are the eager code's bit for bit, and the
    generator ends where the eager code leaves it. For a run's first group
    (no mirror to resolve), for later groups, and for later groups on the
    unfiltered fallback tracks; quaternion and Euler cameras."""
    from orthosfm_torch.pipeline import incremental, tk_graphs
    from orthosfm_torch.utils import profiling

    tracks, sched, cams, cfg = _tk_scene(dev, solver)
    pristine, n_fb = tracks, None
    counts = incremental.group_full_size_counts(tracks, sched.cols_t)
    if case == "fallback":  # the filters left 5 tracks: fewer than a sample
        n_fb = counts
        alive = torch.zeros_like(tracks.alive)
        alive[:5] = True
        tracks = tracks.replace(alive=alive)
        counts = incremental.group_full_size_counts(tracks, sched.cols_t)
    groups = [0] * 5 if case == "first" else [1, 2, 3, 4, 5]
    graphs = tk_graphs.TKGraphs()
    monkeypatch.setattr(tk_graphs, "GRAPHS", graphs)
    runners = incremental.MeshRunners()

    def run(generator):
        out = []
        with profiling.collect_stages({}, dev):
            for g in groups:
                with profiling.stage("pose/tk", group=g):
                    out.append(incremental.initial_alignment(
                        tracks, sched, g, generator, cams, cfg, pristine, int(counts[g]),
                        None if n_fb is None else int(n_fb[g]), runners))
        return out, profiling.traces()[-1]["tk_calls"]

    eager_gen = torch.Generator(dev).manual_seed(11)
    eager, eager_calls = run(eager_gen)
    tk_gen = graphs.generator(dev).manual_seed(11)
    assert graphs.graphed(tracks.device, False, tk_gen)
    assert not graphs.graphed(tracks.device, True, tk_gen)  # a mesh of more than one rank
    graphed, graph_calls = run(tk_gen)
    assert [c["route"] for c in eager_calls] == ["eager"] * 5
    assert [c["route"] for c in graph_calls] == ["capture"] + ["replay"] * 4
    assert {c["fallback"] for c in eager_calls + graph_calls} == {case == "fallback"}
    assert graphs.captures == 1
    for a, b in zip(eager, graphed):
        for f in CAMERA_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    if case != "first":
        assert not torch.equal(eager[0].rot, eager[1].rot)  # each group its own answer
    assert torch.equal(eager_gen.get_state(), tk_gen.get_state())


def _pose_run(tracks, views, cfg):
    from orthosfm_torch.pipeline import incremental

    wh = np.full(views, 2048.0)
    return incremental.run_pose_estimation(tracks, wh, wh, cfg, verbose=False)


def test_graphed_pose_estimation_is_the_eager_one_bit_for_bit(dev, monkeypatch):
    """A 16-view run_pose_estimation through TK's CUDA graphs (captured in
    the run, then replayed) and one with the eager code give the same
    cameras, points and kept tracks, bit for bit."""
    from orthosfm_torch.pipeline import tk_graphs

    tracks, _, _, cfg = _tk_scene(dev, "quat")
    monkeypatch.setattr(tk_graphs, "GRAPHS", tk_graphs.TKGraphs())
    graphed = _pose_run(tracks, 16, cfg)
    assert tk_graphs.GRAPHS.captures == 2  # the first group's graph and the later groups'
    monkeypatch.setattr(tk_graphs.TKGraphs, "graphed", lambda self, *args: False)
    eager = _pose_run(tracks, 16, cfg)
    assert tk_graphs.GRAPHS.captures == 2
    assert graphed.present.all() and np.array_equal(graphed.present, eager.present)
    assert graphed.insertion_order == eager.insertion_order
    for f in CAMERA_FIELDS:
        assert torch.equal(getattr(graphed.cameras, f), getattr(eager.cameras, f)), f
    for f in ("points", "alive", "obs_mask", "has_point"):
        assert torch.equal(getattr(graphed.tracks, f), getattr(eager.tracks, f)), f


@pytest.mark.parametrize("solver", list(TK_SOLVERS))
def test_a_second_run_of_the_same_shapes_captures_nothing(dev, monkeypatch, solver):
    """Two traced runs of one shape after an eager one: the first captures
    a graph for its first group and one for the later groups, keeping no
    more memory allocated than their inputs and outputs; the second replays
    both with no host sync inside a pose/tk span. In both, the profiler's
    kernel records show K5 twice and K6 once a group ran on the card, and
    TK's wrappers count only what they launched themselves: the two eager
    calls before the captures in the first run, nothing in the second."""
    from orthosfm_torch.pipeline import tk_graphs
    from orthosfm_torch.solvers import tk_kernels as tkk
    from orthosfm_torch.utils import profiling

    tracks, sched, _, cfg = _tk_scene(dev, solver)
    n = len(sched.groups)
    graphs = tk_graphs.TKGraphs()
    monkeypatch.setattr(tk_graphs, "GRAPHS", graphs)
    with monkeypatch.context() as eager:
        eager.setattr(tk_graphs.TKGraphs, "graphed", lambda self, *args: False)
        _pose_run(tracks, 16, cfg)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    tkk.reset_launch_counts()
    with (profiling.kernel_runs(tkk.KERNEL_NAMES) as ran,
          profiling.collect_stages({}, dev)):
        _pose_run(tracks, 16, cfg)
    first = profiling.traces()[-1]
    # what the captures keep allocated is the graphs' inputs and outputs: their
    # scratch, cuBLAS's workspace of the capture stream too, is the pool's
    kept = sum(t.numel() * t.element_size() for g in graphs._graphs.values()
               for t in (*g.inputs, g.output))
    assert torch.cuda.memory_allocated(dev) - held <= kept + 64 * 1024
    assert [c["route"] for c in first["tk_calls"]] == ["capture"] * 2 + ["replay"] * (n - 2)
    assert first["tk_captures"] == 2
    assert ran == {"tk_factorize": 2 * n, "tk_score": n}
    assert tkk.launch_counts() == {"tk_factorize": 4, "tk_score": 2}
    tkk.reset_launch_counts()
    with (profiling.kernel_runs(tkk.KERNEL_NAMES) as ran,
          profiling.collect_stages({}, dev)):
        _pose_run(tracks, 16, cfg)
    second = profiling.traces()[-1]
    assert [c["route"] for c in second["tk_calls"]] == ["replay"] * n
    assert second["tk_captures"] == 0 and tk_graphs.GRAPHS.captures == 2
    tk_spans = [s for s in second["spans"] if s["name"] == "pose/tk"]
    assert len(tk_spans) == n and all(s["syncs"] == 0 for s in tk_spans)
    assert ran == {"tk_factorize": 2 * n, "tk_score": n}
    assert tkk.launch_counts() == {"tk_factorize": 0, "tk_score": 0}
