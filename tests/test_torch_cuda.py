"""The port's CUDA kernels (orthosfm_torch/csrc/ba_kernels.cu and
match_kernels.cu) against their plain PyTorch versions, on the card. Every test is marked `cuda` and skips
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
"""

import dataclasses

import numpy as np
import pytest
import torch

from orthosfm_torch import kernel_build
from orthosfm_torch.config import BundleAdjustConfig
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
    assert counts == {"schur_assemble": 15, "camera_solve": 15, "point_update_cost": 16}, counts
    np.testing.assert_allclose(float(r_k.initial_cost), float(r_t.initial_cost), rtol=1e-5)
    assert float(r_k.cost) < float(r_k.initial_cost) * 1e-2
    assert float(r_k.cost) < float(r_t.cost) * 1.5 + 1e-6
    assert r_k.cams.rot.is_cuda and r_k.points.is_cuda
    # the fixed camera 0 is only renormalized
    torch.testing.assert_close(r_k.cams.rot[0], cams.rot[0], rtol=0.0, atol=2e-7)


@pytest.mark.parametrize("num_views", [200, 256, 520])
def test_ba_run_at_many_views(dev, num_views):
    """Global BA over more views than grouping.DENSE_S3_MAX_VIEWS: every
    kernel launches (K1's per-view sums, K2's camera tables and K3's matrix
    must fit their memory at this size; 520 views is past K2's ceiling
    before its tables shrank) and the kernel path converges like the plain
    one."""
    cams, points, obs, mask = make_problem("quat", dev, num_views, 1000)
    cfg = BundleAdjustConfig(max_iterations=15, function_tolerance=0.0, min_lambda=1e-12)
    bk.reset_launch_counts()
    r_k = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="kernel"))
    counts = bk.launch_counts()
    r_t = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    assert all(v > 0 for v in counts.values()), counts
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
# past ~990; the kernels serve up to K3's cluster limit of 1365 views.


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("shape", [(700, 400), (1100, 300)])
def test_stages_match_plain_versions_past_shared_memory(dev, kind, shape):
    """At 700 views K1 reads its global camera tables and sums in place, K2
    still builds its tables in shared memory; at 1100 both read global
    tables. K1 and K2 against their plain versions at both lambdas (the
    tolerances of test_stages_match_plain_versions). K3 (n = 4200, 6600)
    against the f64 solve of the same prepared system: no further from it
    than twice the plain f32 LU is, since at this n both carry the f32
    rounding of a factorization of size n (the plain LU measured 1.2e-5 from
    the kernel at 1100 views)."""
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
    assert counts == {"schur_assemble": 10, "camera_solve": 10, "point_update_cost": 11}, counts
    np.testing.assert_allclose(float(r_k.initial_cost), float(r_t.initial_cost), rtol=1e-5)
    assert float(r_k.cost) < float(r_k.initial_cost) * 1e-2
    assert float(r_k.cost) < float(r_t.cost) * 1.5 + 1e-6


def test_ba_kernels_raise_past_their_view_ceiling(dev):
    """Past 1365 views every kernel wrapper raises a ValueError that names
    the limit and impl="torch", before it launches; the plain path runs."""
    V = 1400
    cams, points, obs, mask = make_problem("quat", dev, V, 100)
    cfg = BundleAdjustConfig(max_iterations=2)
    bk.reset_launch_counts()
    with pytest.raises(ValueError, match=r'at most 1365 views, not 1400.*impl="torch"'):
        ba.run(cams, points, obs, mask, True, cfg)
    inputs = _stage_inputs("quat", dev, V, 100)
    lm = _lm(inputs)
    with pytest.raises(ValueError, match="1365"):
        bk.schur_assemble("quat", *lm, bk.new_state(1e-3, dev), 1.0, True)
    S = torch.zeros((6 * V, 6 * V), device=dev)
    z = torch.zeros(6 * V, device=dev)
    with pytest.raises(ValueError, match="1365"):
        bk.camera_solve("quat", S, z, z, inputs[5], bk.new_state(1e-3, dev), lm[3], lm[4])
    assert sum(bk.launch_counts().values()) == 0
    r = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    assert torch.isfinite(r.cost)


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
