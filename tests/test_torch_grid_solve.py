"""A CPU model of the arithmetic of K3's grid route (csrc/ba_kernels.cu
grid_solve), held to the f64 solve and to the JAX package's camera solve.

The model is the route's blocked right-looking Cholesky of the bordered
system [[S_s, .], [b^T, .]] (ba.prepare_camera_system's damped, pinned,
Jacobi-scaled system) with the route's panel width, GRID_PANEL: each
diagonal block factored in f32 and inverted, the rows below a product with
that inverse, the trailing update as the panel's sum of products and then
one subtraction, both products in emulated 3xTF32 (each f32 operand split
into a TF32 high part, rounded to nearest at 10 mantissa bits by bit
masking, and its remainder, which the tensor cores read as TF32 by dropping
its low 13 bits; hi*hi + hi*lo + lo*hi summed in f32); then the back
substitution x_p = Linv_p^T y_p, panel by panel from the last. It is not on
any path of the port: it says, without the card, whether that arithmetic
keeps the bound the card test (test_camera_solve_grid_route_against_f64)
holds the kernel to: no further from the f64 solve than twice the f32 LU,
plus 1e-6. One TF32 pass in place of three misses that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orthosfm_tpu.solvers import ba as jba
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import ba_kernels as bk
from orthosfm_torch.testbench.problems import make_problem

from tests.torch_port_helpers import n as to_np

GRID_PANEL = 128  # the route's panel width (GB in the CUDA source)
LAM = 1e-3


def tf32(x):
    """x rounded to nearest at TF32's 10 mantissa bits (ties away from zero,
    as cvt.rna.tf32.f32), by bit masking."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x):
    """x with its low 13 bits dropped, as the tensor cores read an f32 as TF32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def product(a, b, passes):
    """a @ b^T in f32 from TF32 operands: 3 passes (hi*hi + hi*lo + lo*hi)
    or 1 (hi*hi)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh.T
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def grid_solve_model(S_s, b, passes=3, panel=GRID_PANEL):
    """x with S_s x = b (f32) by the grid route's arithmetic."""
    n = S_s.shape[0]
    A = torch.zeros((n + 1, n + 1), dtype=torch.float32)
    A[:n, :n] = torch.tril(S_s)
    A[n, :n] = b
    linv = []
    for k0 in range(0, n, panel):
        k1 = min(k0 + panel, n)
        L = torch.linalg.cholesky(A[k0:k1, k0:k1].tril())
        Li = torch.linalg.solve_triangular(L, torch.eye(k1 - k0), upper=False)
        linv.append(Li)
        A[k1:, k0:k1] = product(A[k1:, k0:k1], Li, passes)  # the rows below, b's among them
        if k1 < n:
            rows = A[k1:, k0:k1]
            A[k1:, k1:] -= torch.tril(product(rows, rows, passes))
    y = A[n, :n].clone()
    x = torch.zeros(n)
    for p in reversed(range(len(linv))):
        k0 = p * panel
        k1 = min(k0 + panel, n)
        x[k0:k1] = linv[p].T @ y[k0:k1]
        y[:k0] -= A[k0:k1, :k0].T @ x[k0:k1]
    return x


def _system(num_views, n_tracks=300):
    """make_problem's reduced camera system at lambda LAM (the plain K1 on
    the CPU): (S, dU, rhs, free) as f32 tensors."""
    cams, points, obs, mask = make_problem("quat", "cpu", num_views, n_tracks)
    pT, obsT, maskT = ba.prepare(points, obs, mask)
    free = cam_mod.free_mask(cams).float().contiguous()
    p2, r2, c2 = bk.lm_buffers(pT, cams.rot.contiguous(), ba.pack_camp(cams))
    S, dU, rhs = bk.normal_eq_schur_ref("quat", p2, obsT, maskT, r2, c2, free,
                                        bk.new_state(LAM), 1.0, True)
    return S, dU, rhs, free


def _delta(x, d, free):
    return (x / d).reshape(-1, 6) * free


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.fixture(scope="module", params=[128, 400])
def system(request):
    S, dU, rhs, free = _system(request.param)
    d64 = ba._solve_camera_system(S.double(), dU.double(), rhs.double(), free,
                                  torch.tensor(LAM, dtype=torch.float64))
    lu = ba._solve_camera_system(S, dU, rhs, free, torch.tensor(LAM))
    S_s, b, d = ba.prepare_camera_system(S, dU, rhs, free, torch.tensor(LAM))
    return {"views": request.param, "S": S, "dU": dU, "rhs": rhs, "free": free, "d64": d64,
            "lu": lu, "S_s": S_s, "b": b, "d": d}


def test_grid_model_within_the_card_bound(system):
    """3xTF32 with 128-wide panels: within twice the f32 LU's error to the
    f64 solve, plus 1e-6."""
    x = grid_solve_model(system["S_s"], system["b"])
    delta = _delta(x, system["d"], system["free"])
    bound = 2.0 * _rel(system["lu"], system["d64"]) + 1e-6
    assert _rel(delta, system["d64"]) <= bound, (system["views"], _rel(delta, system["d64"]),
                                                 bound)


def test_grid_model_against_the_jax_camera_solve(system):
    """The JAX package's _solve_camera_system (f32, jnp.linalg.solve) on the
    same numpy inputs: the model lies no further from the f64 solve than
    twice the JAX solve's error, plus 1e-6, and no further from the JAX
    solve than three times that error, plus 1e-6."""
    args = [jnp.asarray(to_np(system[k])) for k in ("S", "dU", "rhs", "free")]
    d_jax = torch.as_tensor(np.array(jba._solve_camera_system(*args, jnp.float32(LAM))))
    x = grid_solve_model(system["S_s"], system["b"])
    delta = _delta(x, system["d"], system["free"])
    e_jax = _rel(d_jax, system["d64"])
    assert _rel(delta, system["d64"]) <= 2.0 * e_jax + 1e-6
    assert _rel(delta, d_jax) <= 3.0 * e_jax + 1e-6
    assert jax.devices()[0].platform == "cpu"


def test_one_tf32_pass_misses_the_bound(system):
    """One TF32 pass in place of three (hi*hi alone) lands outside the bound:
    the reason the route splits its operands."""
    x = grid_solve_model(system["S_s"], system["b"], passes=1)
    delta = _delta(x, system["d"], system["free"])
    bound = 2.0 * _rel(system["lu"], system["d64"]) + 1e-6
    assert _rel(delta, system["d64"]) > bound


def test_grid_route_floors_at_2000_views():
    """The three floors the card's numbers are held to (utils/roofline.py,
    PERF.md): n^3 / 6 FMA at the f32 peak, three times that on the TF32
    tensor cores, and the trailing update's bytes at 128-wide panels, at
    n = 12000."""
    from orthosfm_torch.utils.roofline import grid_route_bounds

    b = grid_route_bounds(2000)
    assert b["f32"] == pytest.approx(8.597, abs=1e-3)
    assert b["tf32x3"] == pytest.approx(3.491, abs=1e-3)
    assert b["bytes"] == pytest.approx(5.373, abs=1e-3)
    assert grid_route_bounds(2000, panel=64)["bytes"] == pytest.approx(2 * b["bytes"])


@pytest.mark.parametrize("num_views, ms, by", [(192, 0.0030885, "operations"),
                                               (2000, 3.4909, "operations")])
def test_grid_route_bound_is_its_tf32x3_floor(num_views, ms, by):
    """The grid route's bound (the kernels line's bound_ms) is the 3xTF32
    floor of its products, not the f32 CUDA cores' (which is 2.46x higher),
    at the main path's 192 views and at 2000."""
    from orthosfm_torch.utils.roofline import grid_route_bound, grid_route_bounds

    b_ms, b_by = grid_route_bound(num_views)
    assert (b_ms, b_by) == (pytest.approx(ms, rel=1e-4), by)
    assert b_ms == pytest.approx(grid_route_bounds(num_views)["tf32x3"])
    assert grid_route_bounds(num_views)["f32"] / b_ms == pytest.approx(495 / (3 * 67))

