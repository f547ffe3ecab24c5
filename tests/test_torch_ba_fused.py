"""The port's whole-solve LM (solvers/ba_kernels.py lm_solve, whose CUDA
kernel is lm_fused, and its plain version lm_solve_ref) against the JAX
package's fused LM kernel (orthosfm_tpu/solvers/ba_fused.py run_lm) run in
interpret mode, on the CPU, where lm_solve runs lm_solve_ref.

The problem is the JAX package's own test problem (tests/test_ba_pallas.py
_problem: 8 views x 1024 tracks; 40 views, where the card's camera solve is
the cluster's; and 128, where it is K3's grid route inside the launch and
the JAX package's own gate, ba_fused.fits, still takes its fused kernel)
and the tolerances are its own for its fused kernel
against its XLA path (tests/test_ba_fused.py:54-109): both sides are f32
and differ in the order of their sums and in the solve (LU here,
Gauss-Jordan there). The CUDA kernel itself is held to lm_solve_ref
and, bit for bit, to the per-iteration kernels in tests/test_torch_cuda.py,
on the card."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from tests.test_ba_pallas import _problem as _make_problem
from tests.test_ba_fused import _fused_inputs

from orthosfm_tpu.config import BundleAdjustConfig as JBAConfig
from orthosfm_tpu.core import cameras as jcam
from orthosfm_tpu.solvers import ba as jba
from orthosfm_tpu.solvers import ba_fused as jba_fused

from orthosfm_torch import kernel_build
from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import ba_kernels as bk


@functools.lru_cache(maxsize=None)
def _problem(kind, num_views=8, n_points=1024):
    return _make_problem(kind, num_views=num_views, n_points=n_points)


def _fixed_03(cams):
    return cams.replace(fixed=jnp.zeros(8, bool).at[0].set(True).at[3].set(True))


@functools.lru_cache(maxsize=None)
def _jax_fused(kind, optimize_points, max_iterations, fixed=False, num_views=8):
    """The JAX package's fused LM kernel in interpret mode on the problem
    (cameras 0 and 3 fixed with `fixed`)."""
    cams, points, obs, mask = _problem(kind, num_views)
    if fixed:
        cams = _fixed_03(cams)
    cfg = JBAConfig(max_iterations=max_iterations, function_tolerance=0.0, min_lambda=1e-12,
                    use_pallas=False)
    pT, obsT, maskT = _fused_inputs(cams, points, obs, mask)
    return jba._run_fused(cams, pT, obsT, maskT, jcam.free_mask(cams), optimize_points, cfg,
                          n_tracks=obs.shape[0], interpret=True)


def _port(kind, optimize_points, max_iterations, fixed=False, num_views=8):
    """The port's two whole solves on the same problem: lm_solve_ref on the
    LM buffers ba.run builds, as (rot, offset, points, cost, initial cost,
    iterations), and ba.run(impl="fused")."""
    cams, points, obs, mask = _problem(kind, num_views)
    if fixed:
        cams = _fixed_03(cams)
    tc, tp, to, tm = cam_mod.from_numpy(cams), t(points), t(obs), t(mask)
    cfg = BundleAdjustConfig(max_iterations=max_iterations, function_tolerance=0.0,
                             min_lambda=1e-12, impl="fused")
    pT, obsT, maskT = ba.prepare(tp, to, tm)
    p2, r2, c2 = bk.lm_buffers(pT, tc.rot, ba.pack_camp(tc))
    st = bk.lm_solve_ref(kind, p2, obsT, maskT, r2, c2, cam_mod.free_mask(tc).float(), 1.0,
                         optimize_points, bk.LMConfig.of(cfg), max_iterations)
    p, r, c = (bk.current(x, st) for x in (p2, r2, c2))
    ref = (r, c[:, 3:5], p.T, st[bk.COST], st[bk.INIT_COST], int(st[bk.ITERS]))
    res = ba.run(tc, tp, to, tm, optimize_points, cfg)
    run = (res.cams.rot, res.cams.offset, res.points, res.cost, res.initial_cost,
           int(res.iterations))
    return cams, ref, run


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("optimize_points", [True, False])
def test_single_step_matches_fused_interpret(kind, optimize_points):
    rf = _jax_fused(kind, optimize_points, 1)
    _, ref, run = _port(kind, optimize_points, 1)
    for rot, offset, points, cost, init_cost, iters in (ref, run):
        np.testing.assert_allclose(float(init_cost), float(rf.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(float(cost), float(rf.cost), rtol=1e-3)
        np.testing.assert_allclose(n(rot), n(rf.cams.rot), rtol=1e-4, atol=2e-6)
        np.testing.assert_allclose(n(offset), n(rf.cams.offset), atol=1e-5)
        if optimize_points:
            np.testing.assert_allclose(n(points), n(rf.points), rtol=1e-3, atol=1e-5)
        assert iters == int(rf.iterations) == 1


@pytest.mark.parametrize("kind,num_views", [("quat", 40), ("euler", 40), ("quat", 128),
                                            ("euler", 128)],
                         ids=["quat", "euler", "quat-128", "euler-128"])
def test_many_view_step_matches_fused_interpret(kind, num_views):
    """40 and 128 views x 1024 tracks (one tile), past the one-CTA camera
    solve: on the card lm_fused solves 40 views on its cluster and 128 on
    K3's grid route over every CTA of the launch, where the JAX package's
    ba.run takes its fused kernel too (ba_fused.fits); here its plain
    version, one iteration against the JAX kernel's."""
    assert jba_fused.fits(num_views, 1024)
    rf = _jax_fused(kind, True, 1, num_views=num_views)
    _, ref, run = _port(kind, True, 1, num_views=num_views)
    for rot, offset, points, cost, init_cost, iters in (ref, run):
        np.testing.assert_allclose(float(init_cost), float(rf.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(float(cost), float(rf.cost), rtol=1e-3)
        np.testing.assert_allclose(n(rot), n(rf.cams.rot), rtol=1e-4, atol=2e-6)
        np.testing.assert_allclose(n(offset), n(rf.cams.offset), atol=1e-5)
        np.testing.assert_allclose(n(points), n(rf.points), rtol=1e-3, atol=1e-5)
        assert iters == int(rf.iterations) == 1


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_full_lm_converges_like_fused_interpret(kind):
    """Fifteen iterations reach the JAX kernel's reduction (the accept and
    reject sequences may part once f32 rounding differs, so the reduction
    ratios are compared, as tests/test_ba_fused.py:75-82 does)."""
    rf = _jax_fused(kind, True, 15)
    _, ref, run = _port(kind, True, 15)
    for _, _, _, cost, init_cost, iters in (ref, run):
        assert float(cost) < float(init_cost) * 1e-2, kind
        assert float(cost) < float(rf.cost) * 1.5 + 1e-6
        assert iters >= 1


def test_fixed_cameras_stay_fixed():
    """Cameras 0 and 3 fixed: they come back bit-identical, in both of the
    port's solves and in the JAX kernel's."""
    rf = _jax_fused("quat", True, 3, fixed=True)
    cams, ref, run = _port("quat", True, 3, fixed=True)
    for rot, offset in ((ref[0], ref[1]), (run[0], run[1]), (rf.cams.rot, rf.cams.offset)):
        np.testing.assert_array_equal(n(rot[0]), np.asarray(cams.rot[0]))
        np.testing.assert_array_equal(n(rot[3]), np.asarray(cams.rot[3]))
        np.testing.assert_array_equal(n(offset[3]), np.asarray(cams.offset[3]))


@pytest.mark.parametrize("views,fits", [(3, True), (37, True), (38, True), (64, True),
                                        (119, True), (120, True), (128, True), (192, True),
                                        (bk.FUSED_MAX_VIEWS, True),
                                        (bk.FUSED_MAX_VIEWS + 1, False)])
def test_fused_gate(views, fits):
    """lm_solve serves 1 to FUSED_MAX_VIEWS views (on the card its camera
    solve is one warp, one CTA, from 38 views the cluster of 8 CTAs, and
    from the crossover K3's grid route over every CTA, while K1's and K2's
    per-view tables fit the launch's shared memory; past that BA runs an
    iteration at a time; the same rule here), whatever the track count."""
    for tracks in (1, 1024, 50000):
        assert bk.fused_fits(views, tracks, "cpu") is fits
    assert kernel_build.resolve_impl("auto", torch.device("cpu"), fused=fits) == "torch"
    assert kernel_build.resolve_impl("auto", torch.device("cuda"), fused=fits) == (
        "fused" if fits else "kernel")


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
def test_jax_impl_names_run_in_the_port(impl):
    """A JAX-style BundleAdjustConfig(impl="xla" | "pallas" | "fused") runs
    in the port: on the CPU each gives the plain route's bits."""
    cams, points, obs, mask = _problem("euler")
    args = (cam_mod.from_numpy(cams), t(points), t(obs), t(mask), True)
    cfg = BundleAdjustConfig(max_iterations=3, function_tolerance=0.0)
    got = ba.run(*args, dataclasses.replace(cfg, impl=impl))
    ref = ba.run(*args, dataclasses.replace(cfg, impl="torch"))
    assert torch.equal(got.points, ref.points) and torch.equal(got.cams.rot, ref.cams.rot)
    assert float(got.cost) == float(ref.cost) and int(got.iterations) == int(ref.iterations)
    route = kernel_build.resolve_impl(impl, torch.device("cuda"), fused=True)
    assert route == {"xla": "torch", "pallas": "kernel", "fused": "fused"}[impl]


def test_fused_raises_past_37_views():
    """The fused route's edge, which was 37 views, then 119, and is now
    FUSED_MAX_VIEWS: "fused" serves 120 views, in ba.run and in lm_solve,
    with the plain route's bits on the CPU, and one view past the bound
    raises in both."""
    from orthosfm_torch.testbench.problems import make_problem

    cfg = BundleAdjustConfig(max_iterations=3, function_tolerance=0.0)
    for views in (120, bk.FUSED_MAX_VIEWS + 1):
        cams, points, obs, mask = make_problem("quat", "cpu", views, 64)
        pT, obsT, maskT = ba.prepare(points, obs, mask)
        p2, r2, c2 = bk.lm_buffers(pT, cams.rot, ba.pack_camp(cams))
        solve = functools.partial(bk.lm_solve, "quat", p2, obsT, maskT, r2, c2,
                                  cam_mod.free_mask(cams).float(), 1.0, True,
                                  bk.LMConfig.of(cfg), 3)
        fused = dataclasses.replace(cfg, impl="fused")
        if views > bk.FUSED_MAX_VIEWS:
            with pytest.raises(ValueError, match="fused"):
                ba.run(cams, points, obs, mask, True, fused)
            with pytest.raises(ValueError, match=f"{bk.FUSED_MAX_VIEWS} views"):
                solve()
            continue
        got = ba.run(cams, points, obs, mask, True, fused)
        ref = ba.run(cams, points, obs, mask, True, dataclasses.replace(cfg, impl="torch"))
        assert torch.equal(got.points, ref.points) and torch.equal(got.cams.rot, ref.cams.rot)
        assert float(got.cost) == float(ref.cost) and int(got.iterations) == int(ref.iterations)
        state = solve()
        assert float(state[bk.COST]) == float(ref.cost) and int(state[bk.ITERS]) == 3
    # the sharded BA has no fused route: "fused" keeps its per-iteration kernels
    assert kernel_build.resolve_impl("fused", torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError, match="impl"):
        kernel_build.resolve_impl("fast", torch.device("cpu"))


def test_fused_launch_failure_raises_and_runs_nothing_else(monkeypatch):
    """A refused or failed fused launch raises out of ba.run: no path runs
    the per-iteration loop or the plain solve in its place."""
    cams, points, obs, mask = _problem("quat")
    args = (cam_mod.from_numpy(cams), t(points), t(obs), t(mask), True,
            BundleAdjustConfig(max_iterations=2, impl="fused"))
    ran = []

    def refused(*a, **k):
        bk._raise_on(720, "lm_solve")  # cudaErrorCooperativeLaunchTooLarge

    monkeypatch.setattr(bk, "lm_solve", refused)
    monkeypatch.setattr(bk, "lm_iterate", lambda *a, **k: ran.append("lm_iterate"))
    monkeypatch.setattr(bk, "lm_solve_ref", lambda *a, **k: ran.append("lm_solve_ref"))
    with pytest.raises(RuntimeError, match="lm_solve: CUDA error 720"):
        ba.run(*args)
    assert ran == []


@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_false_makes_auto_the_plain_route(use_pallas):
    """BundleAdjustConfig.use_pallas=False turns "auto" into the plain route
    on every device, as it turns the JAX package's "auto" into XLA
    (orthosfm_tpu/solvers/ba.py:541-546, parallel/ba_sharded.py:44-47); an
    explicit impl wins over it."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for fits in (True, False):
        assert kernel_build.resolve_impl("auto", cuda, fused=fits, use_pallas=use_pallas) == (
            ("fused" if fits else "kernel") if use_pallas else "torch")
        assert kernel_build.resolve_impl("auto", cpu, fused=fits, use_pallas=use_pallas) == "torch"
    # the sharded BA (no fused route)
    assert kernel_build.resolve_impl("auto", cuda, use_pallas=use_pallas) == (
        "kernel" if use_pallas else "torch")
    for impl, route in (("kernel", "kernel"), ("pallas", "kernel"), ("torch", "torch"),
                        ("xla", "torch"), ("fused", "fused")):
        assert kernel_build.resolve_impl(impl, cuda, fused=True, use_pallas=use_pallas) == route
    assert kernel_build.resolve_impl("fused", cuda, use_pallas=use_pallas) == "kernel"


@pytest.mark.parametrize("use_pallas", [True, False])
def test_ba_run_and_the_sharded_ba_route_by_use_pallas(monkeypatch, use_pallas):
    """ba.run and the sharded BA hand config.use_pallas to resolve_impl: the
    route each would take for CUDA tensors is recorded beside the CPU run
    (with use_pallas false neither asks whether the fused route fits)."""
    from orthosfm_torch.parallel import ba_sharded, mesh as mesh_mod

    real = kernel_build.resolve_impl
    on_card = []

    def spy(impl, device, fused=None, use_pallas=True):
        on_card.append(real(impl, torch.device("cuda"), fused=fused, use_pallas=use_pallas))
        return real(impl, device, fused=fused, use_pallas=use_pallas)

    fits = []
    real_fits = bk.fused_fits
    monkeypatch.setattr(ba, "resolve_impl", spy)
    monkeypatch.setattr(ba_sharded, "resolve_impl", spy)
    monkeypatch.setattr(bk, "fused_fits", lambda *a: fits.append(a) or real_fits(*a))
    cams, points, obs, mask = _problem("quat")
    args = (cam_mod.from_numpy(cams), t(points), t(obs), t(mask))
    cfg = BundleAdjustConfig(max_iterations=2, use_pallas=use_pallas)
    ba.run(*args, True, cfg)
    ba_sharded.make_sharded_ba(mesh_mod.make_mesh(1, device="cpu"), True, cfg)(*args)
    assert on_card == (["fused", "kernel"] if use_pallas else ["torch", "torch"])
    assert len(fits) == int(use_pallas)
