"""Small dense Levenberg–Marquardt solver, batched over problems.

Port of orthosfm_tpu/solvers/lm.py, which replaces Ceres DENSE_QR for tiny
problems — in particular the Tomasi-Kanade metric upgrade (15 residuals × 9
params; reference: src/algorithms/tomasi_kanade.cpp:62-75). The JAX version
is written for one problem, differentiates it with jacfwd and is vmapped;
here the batch dimension is explicit, the caller supplies the Jacobian in
closed form, and the fixed iteration count is a Python loop.
"""

from __future__ import annotations

import torch


def solve(residual_and_jacobian, x0, args=(), *, iters: int = 40,
          init_lambda: float = 1e-3, lambda_up: float = 10.0, lambda_down: float = 0.1):
    """Minimize ½‖r(x)‖² for each row of x0 (B, n) with damped Gauss-Newton.

    residual_and_jacobian(x (B, n), *args) -> (r (B, m), J (B, m, n)).
    Returns (x (B, n), final_cost (B,)); the damping schedule and the
    accept/reject rule are the JAX package's."""
    x = x0
    lam = torch.full(x0.shape[:1], init_lambda, dtype=x0.dtype, device=x0.device)
    r, J = residual_and_jacobian(x, *args)
    c = 0.5 * torch.sum(r * r, dim=-1)
    eye = torch.eye(x0.shape[1], dtype=x0.dtype, device=x0.device)
    for _ in range(iters):
        Jt = J.transpose(1, 2)
        H = Jt @ J
        g = (Jt @ r[..., None])[..., 0]
        # Marquardt scaling: damp by the diagonal (with floor)
        d = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-8)
        step = torch.linalg.solve(H + lam[:, None, None] * d[:, None, :] * eye, -g)
        r_new, J_new = residual_and_jacobian(x + step, *args)
        c_new = 0.5 * torch.sum(r_new * r_new, dim=-1)
        accept = c_new < c
        x = torch.where(accept[:, None], x + step, x)
        r = torch.where(accept[:, None], r_new, r)
        J = torch.where(accept[:, None, None], J_new, J)
        c = torch.where(accept, c_new, c)
        lam = torch.where(accept, torch.clamp(lam * lambda_down, min=1e-12),
                          torch.clamp(lam * lambda_up, max=1e10))
    return x, c
