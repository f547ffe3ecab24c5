"""The port's CUDA kernels (orthosfm_torch/csrc/ba_kernels.cu and
match_kernels.cu) against their plain PyTorch versions, on the card. Every test is marked `cuda` and skips
where torch.cuda.is_available() is false.

This file imports neither jax nor the JAX package, so it runs on a machine
with a GPU and no JAX; tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the kernels sum over tracks in per-CTA partials and solve the
camera system by Gauss-Jordan without pivoting, the plain versions sum in
torch's order and solve by LU; both are f32. Relative 1e-4 on sums of ~1e4
terms, 1e-5 on the solve (measured: ~1e-6), which a solve that mishandles the
damping fails at both lambdas checked, 1e-5 on unit-norm points. top2: d2
within 1e-5 absolute (the kernel's FMA chain and cuBLAS's GEMM sum in
different orders) and the same index except on rows whose best and second
d2 lie within 1e-5 of each other.
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


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("optimize_points", [True, False])
@pytest.mark.parametrize("shape", [(8, 1000), (64, 3000), (120, 1000)])
def test_stages_match_plain_versions(dev, kind, optimize_points, shape):
    """K1-K4 against their plain versions; 1000 and 3000 tracks are ragged
    against every chunk size. The camera solve runs on one CTA at 8 views,
    on a cluster of 8 CTAs at 64 views (n = 384), and with its row blocks in
    a global scratch buffer at 120 views (n = 720)."""
    pT, obsT, maskT, rot, camp, free = _stage_inputs(kind, dev, *shape)
    state = bk.new_state(1e-3, dev)
    args = (kind, pT, obsT, maskT, rot, camp, free, state, 1.0, optimize_points)
    S, dU, rhs = bk.schur_assemble(*args)
    S_r, dU_r, rhs_r = bk.normal_eq_schur_ref(*args)
    assert max(_rel(S, S_r), _rel(dU, dU_r), _rel(rhs, rhs_r)) < 1e-4

    for lam in (1.0, 1e-3):
        sargs = (kind, S_r, dU_r, rhs_r, free, bk.new_state(lam, dev), rot, camp)
        delta, rot_c, camp_c = bk.camera_solve(*sargs)
        delta_r, rot_cr, camp_cr = bk.camera_solve_ref(*sargs)
        assert _rel(delta, delta_r) < 1e-5, lam
        assert float((rot_c - rot_cr).abs().max()) < 1e-5

    uargs = (kind, pT, obsT, maskT, rot, camp, free, state, delta_r, rot_cr, camp_cr, 1.0,
             optimize_points)
    p, parts = bk.point_update_cost(*uargs)
    p_r, parts_r = bk.point_update_cost_ref(*uargs)
    assert float((p - p_r).abs().max()) < 1e-5
    np.testing.assert_allclose(float(parts.sum()), float(parts_r.sum()), rtol=1e-4)

    cfg = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)
    s_in = bk.new_state(1e-3, dev)
    s_in[bk.COST] = parts_r.sum() * 2.0
    outs = []
    for accept in (bk.lm_accept, bk.lm_accept_ref):
        s_out = torch.zeros_like(s_in)
        r, c, q = rot.clone(), camp.clone(), pT.clone()
        accept(parts_r, s_in, s_out, r, c, q, rot_cr, camp_cr,
               p_r if optimize_points else None, cfg)
        outs.append((s_out, r, c, q))
    for a, b in zip(outs[0], outs[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
    assert float(outs[0][0][bk.ITERS]) == 1.0


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_ba_run_kernel_path_converges_like_plain(dev, kind):
    cams, points, obs, mask = make_problem(kind, dev, 16, 4000)
    cfg = BundleAdjustConfig(max_iterations=15, function_tolerance=0.0, min_lambda=1e-12)
    bk.reset_launch_counts()
    r_k = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="kernel"))
    counts = bk.launch_counts()
    r_t = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
    assert all(v > 0 for v in counts.values()), counts
    np.testing.assert_allclose(float(r_k.initial_cost), float(r_t.initial_cost), rtol=1e-5)
    assert float(r_k.cost) < float(r_k.initial_cost) * 1e-2
    assert float(r_k.cost) < float(r_t.cost) * 1.5 + 1e-6
    assert r_k.cams.rot.is_cuda and r_k.points.is_cuda
    # the fixed camera 0 is only renormalized
    torch.testing.assert_close(r_k.cams.rot[0], cams.rot[0], rtol=0.0, atol=2e-7)


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


def test_wrappers_reject_bad_inputs(dev):
    pT, obsT, maskT, rot, camp, free = _stage_inputs("quat", dev, 4, 300)
    state = bk.new_state(1e-3, dev)
    with pytest.raises(ValueError, match="dtype"):
        bk.schur_assemble("quat", pT.double(), obsT, maskT, rot, camp, free, state, 1.0, True)
    with pytest.raises(ValueError, match="device"):
        bk.schur_assemble("quat", pT, obsT, maskT.cpu(), rot, camp, free, state, 1.0, True)
    with pytest.raises(ValueError, match="contiguous"):
        bk.point_update_cost("quat", pT, obsT.transpose(0, 1).contiguous().transpose(0, 1),
                             maskT, rot, camp, free, None, None, rot, camp, 1.0, False)


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


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("N", [300, 1000])
def test_top2_kernel_matches_plain(dev, D, N):
    """N is no multiple of the 64-row tile; the pairs repeat views, match a
    view against itself, end in ragged prefixes and have databases of 0 and 1
    valid rows."""
    d = _top2_stack(dev, 5, N, D)
    pairs = [(0, 1, N, N), (2, 1, N, N), (1, 1, N, N), (1, 0, N, N), (3, 4, N - 37, N - 101),
             (4, 3, N, 0), (0, 2, N, 1), (2, 3, 1, N)]
    cols = [torch.tensor(c, dtype=torch.int32, device=dev) for c in zip(*pairs)]
    before = mk.top2.launches
    kb, ks, ki = mk.top2(d, *cols, impl="kernel")
    assert mk.top2.launches == before + 1
    rb, rs, ri = mk.top2_ref(d, *cols)
    assert float((kb - rb).abs().max()) < NEAR_TIE
    assert float((ks - rs).abs().max()) < NEAR_TIE
    near = (rs - rb) <= NEAR_TIE
    assert bool(torch.all((ki == ri) | near))
    # exact ties go to the lower column
    q = N // 4
    assert bool(torch.all(ki[1, :q] == torch.arange(q, device=dev)))
    assert bool(torch.all(kb[1, :q] == ks[1, :q]))
    # empty database, one valid row, rows past the query count
    assert bool(torch.all(kb[5] == 4.0) & torch.all(ks[5] == 4.0) & torch.all(ki[5] == 0))
    assert bool(torch.all(ks[6] == 4.0) & torch.all(ki[6] == 0) & torch.all(kb[6] < 4.0))
    assert bool(torch.all(kb[7, 1:] == 4.0) & torch.all(ki[7, 1:] == 0))
    assert bool(torch.all(kb[4, N - 37:] == 4.0))
    assert bool(torch.all(ki[4, :N - 37] < N - 101))


def test_match_pairs_batched_kernel_matches_plain(dev):
    d = _top2_stack(dev, 4, 700, 128, seed=1)
    d[3, 200:400] = d[0, :200]
    cols = [torch.tensor(c, dtype=torch.int32, device=dev)
            for c in zip((0, 3, 700, 700), (1, 2, 650, 700), (2, 2, 700, 700))]
    m_k = match_ops.match_pairs_batched(d, *cols, impl="kernel")
    m_t = match_ops.match_pairs_batched(d, *cols, impl="torch")
    assert int((m_k[0, :200] == torch.arange(200, 400, device=dev)).sum()) == 200
    rb, rs, _ = mk.top2_ref(d, *cols)
    rb2, rs2, _ = mk.top2_ref(d, cols[1], cols[0], cols[3], cols[2])
    near = ((rs - rb) <= NEAR_TIE) | ((rs2 - rb2) <= NEAR_TIE).any(dim=1, keepdim=True)
    assert bool(torch.all((m_k == m_t) | near))


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
