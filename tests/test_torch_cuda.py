"""The port's CUDA kernels (orthosfm_torch/csrc/ba_kernels.cu) against their
plain PyTorch versions, on the card. Every test is marked `cuda` and skips
where torch.cuda.is_available() is false.

This file imports neither jax nor the JAX package, so it runs on a machine
with a GPU and no JAX; tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the kernels sum over tracks in per-CTA partials and solve the
camera system by Gauss-Jordan without pivoting, the plain versions sum in
torch's order and solve by LU; both are f32. Relative 1e-4 on sums of ~1e4
terms, 1e-5 on the solve (measured: ~1e-6), which a solve that mishandles the
damping fails at both lambdas checked, 1e-5 on unit-norm points.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
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


def test_done_flag_stops_the_loop_on_the_device(dev):
    """After convergence the launched iterations are no-ops: a run allowed 50
    iterations ends bit-identical to one allowed exactly the iterations it
    used, and it converges like the plain path on the card, which runs the
    same loop (the two may differ by one iteration at the tolerance's
    edge)."""
    cams, points, obs, mask = make_problem("quat", dev, 8, 2000)
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
    assert abs(int(r_t.iterations) - iters) <= 1
    assert float(r_50.cost) < float(r_50.initial_cost) * 1e-2


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
