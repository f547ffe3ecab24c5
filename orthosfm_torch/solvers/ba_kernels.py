"""The four stages of one bundle-adjustment LM iteration: hand-written CUDA
kernels for Hopper (orthosfm_torch/csrc/ba_kernels.cu) and, beside each, its
plain PyTorch version.

  stage                 kernel wrapper       plain version          replaces (JAX package)
  assemble              schur_assemble       normal_eq_schur_ref    ba_pallas.normal_eq_schur,
                                                                    ba_fused.run_lm pass 1
  camera solve+retract  camera_solve         camera_solve_ref       ba_fused._gauss_jordan and the
                                                                    in-kernel reduced system
  point update + cost   point_update_cost    point_update_cost_ref  ba_pallas.point_update_cost,
                                                                    ba_fused.run_lm pass 2
  accept                lm_accept            lm_accept_ref          ba_fused.run_lm accept/λ/done

A wrapper given CPU tensors calls the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches in a plain
integer attribute, ``wrapper.launches``.

The scalar LM state is a float tensor of STATE_SIZE entries
[λ, cost, iterations, done, initial cost, 0, 0, 0]; ba.run keeps two slots
and alternates them, so each iteration reads one and writes the other.

The kernels are built at first use by orthosfm_torch.kernel_build (nvcc,
from csrc/ only, into orthosfm_torch/_build/, under a name that hashes the
source and flags) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from orthosfm_torch import kernel_build
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.solvers import ba

LAM, COST, ITERS, DONE, INIT_COST = 0, 1, 2, 3, 4
STATE_SIZE = 8

SOURCE = kernel_build.CSRC / "ba_kernels.cu"

# Launch geometry shared with the CUDA source
_NT = 256
_TS = 32
_KT = 16
_TARGET_CTAS = 264  # two CTAs per SM on the 132-SM H100


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The LM schedule constants lm_accept reads."""

    lam0: float
    func_tol: float
    lam_up: float
    lam_down: float
    min_lam: float
    max_lam: float

    @classmethod
    def of(cls, config) -> "LMConfig":
        return cls(config.initial_lambda, config.function_tolerance, config.lambda_up,
                   config.lambda_down, config.min_lambda, config.max_lambda)


def new_state(lam: float, device="cpu") -> torch.Tensor:
    """A fresh scalar state slot holding λ (for driving single stages)."""
    s = torch.zeros(STATE_SIZE, dtype=torch.float32, device=device)
    s[LAM] = lam
    return s


# ---------------------------------------------------------------------------
# Plain PyTorch versions


def normal_eq_schur_ref(kind, pT, obsT, maskT, rot, camp, free, state_in, huber_delta,
                        optimize_points):
    """S' (n, n) = blkdiag(U) − W V̂⁻¹ Wᵀ in block-major (view·6 + param)
    order, dU (n,) = diag(U), rhs (n,) = g_c − W V̂⁻¹ g_p, with n = 6V — the
    contract of the JAX package's ba_pallas.normal_eq_schur."""
    lam = state_in[LAM]
    V, T = obsT.shape[0], obsT.shape[2]
    R, dS = ba.rotation_tensors(kind, rot)
    blocks = ba._residuals_and_jacobians(kind, R, dS, camp, pT, obsT, maskT != 0, huber_delta)
    U, Wc, Vt, g_c, g_p = ba.normal_equations(blocks, free)
    V_inv = ba.damped_point_inverse(Vt, lam, optimize_points)
    WVi = (Wc[:, :, 0, None, :] * V_inv[None, None, 0] +
           Wc[:, :, 1, None, :] * V_inv[None, None, 1] +
           Wc[:, :, 2, None, :] * V_inv[None, None, 2])  # (V, 6, 3, T)
    X = WVi.reshape(V * 6, 3 * T)
    Y = Wc.reshape(V * 6, 3 * T)
    ar = torch.arange(V, device=pT.device)
    S = pT.new_zeros((V, 6, V, 6))
    S[ar, :, ar, :] = U
    S = S.reshape(V * 6, V * 6) - X @ Y.T
    dU = torch.diagonal(U, dim1=1, dim2=2).reshape(V * 6)
    rhs = g_c.reshape(V * 6) - X @ g_p.reshape(3 * T)
    return S, dU, rhs


def retract_params(kind, rot, camp, delta):
    """Candidate (rot, camp) after the camera step delta (V, 6)
    (cameras.retract on the packed parameters)."""
    rot_c = cam_mod.retract_rotation(kind, rot, delta)
    z = torch.zeros_like(delta[:, :1])
    step = torch.cat([delta[:, 5:6], z, z, delta[:, 3:5], z, z, z], dim=1)
    return rot_c.contiguous(), (camp + step).contiguous()


def camera_solve_ref(kind, S, dU, rhs, free, state_in, rot, camp):
    """Damped, pinned, Jacobi-scaled dense solve of the reduced camera system
    (ba._solve_camera_system, torch.linalg.solve) and the camera retraction.
    Returns (delta (V, 6), rot_c (V, 4), camp_c (V, 8))."""
    delta = ba._solve_camera_system(S, dU, rhs, free, state_in[LAM])
    rot_c, camp_c = retract_params(kind, rot, camp, delta)
    return delta.contiguous(), rot_c, camp_c


def point_update_cost_ref(kind, pT, obsT, maskT, rot, camp, free, state_in, delta, rot_c,
                          camp_c, huber_delta, update_points):
    """Point back-substitution δp = V̂⁻¹(g_p − Wᵀδc), S³ retraction, and the
    robust cost at (rot_c, camp_c, new points). Returns (p_new (4, T), cost
    partials (1,)); p_new is pT itself when update_points is False."""
    m = maskT != 0
    p_new = pT
    if update_points:
        R, dS = ba.rotation_tensors(kind, rot)
        blocks = ba._residuals_and_jacobians(kind, R, dS, camp, pT, obsT, m, huber_delta)
        _, Wc, Vt, _, g_p = ba.normal_equations(blocks, free)
        V_inv = ba.damped_point_inverse(Vt, state_in[LAM], True)
        tmp = g_p - torch.einsum("vaqt,va->qt", Wc, delta)
        dp = torch.einsum("qpt,pt->qt", V_inv, tmp)
        p_new = ba.retract_point_T(pT, dp)
    Rn, _ = ba.rotation_tensors(kind, rot_c)
    r = ba._project_residuals_T(Rn, camp_c, p_new, obsT)
    r = torch.where(m[:, None, :], r, torch.zeros_like(r))
    return p_new, ba.robust_cost(r, m, huber_delta).reshape(1)


def lm_accept_ref(cost_part, state_in, state_out, rot, camp, pT, rot_c, camp_c, p_c,
                  cfg: LMConfig, init: bool = False):
    """LM accept/reject (ba.py:501-513 of the JAX package), in place and
    without a host sync: writes the new scalar state into ``state_out`` and,
    on acceptance, the candidate cameras and points into rot, camp and pT."""
    new = torch.sum(cost_part)
    z = torch.zeros_like(new)
    if init:
        state_out.copy_(torch.stack([z + cfg.lam0, new, z, z, new, z, z, z]))
        return
    lam, cost = state_in[LAM], state_in[COST]
    active = state_in[DONE] == 0
    acc = active & (new < cost)
    rel = (cost - new) / torch.clamp(cost, min=1e-20)
    done = acc & (rel < cfg.func_tol)
    nl = torch.where(acc, torch.clamp(lam * cfg.lam_down, min=cfg.min_lam),
                     torch.clamp(lam * cfg.lam_up, max=cfg.max_lam))
    done = done | (~acc & (nl >= cfg.max_lam))
    out = torch.stack([nl, torch.where(acc, new, cost), state_in[ITERS] + 1,
                       done.to(new.dtype), state_in[INIT_COST], z, z, z])
    state_out.copy_(torch.where(active, out, state_in))
    rot.copy_(torch.where(acc, rot_c, rot))
    camp.copy_(torch.where(acc, camp_c, camp))
    if p_c is not None:
        pT.copy_(torch.where(acc, p_c, pT))


# ---------------------------------------------------------------------------
# Build and binding


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "osfm_schur_assemble": [_I, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P],
    "osfm_camera_solve": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "osfm_point_update_cost": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                               _P, _P, _P],
    "osfm_lm_accept": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _P],
    "osfm_camera_solve_scratch_floats": [_I],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with every C function's signature declared."""
    return kernel_build.load(SOURCE, _SIGNATURES)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _check(name: str, t, shape, device, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on device {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_kind(kind):
    if kind not in ("quat", "euler"):
        raise ValueError(f"unknown camera kind {kind!r}")


def _check_problem(kind, pT, obsT, maskT, rot, camp, free):
    _check_kind(kind)
    V, T = obsT.shape[0], obsT.shape[2]
    if T < 1 or V < 1:
        raise ValueError("empty bundle-adjustment problem")
    dev = pT.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev.type} tensors")
    _check("pT", pT, (4, T), dev)
    _check("obsT", obsT, (V, 2, T), dev)
    _check("maskT", maskT, (V, T), dev)
    _check("rot", rot, (V, 4), dev)
    _check("camp", camp, (V, 8), dev)
    _check("free", free, (V, 6), dev)
    return V, T, dev


# ---------------------------------------------------------------------------
# Kernel wrappers


def schur_assemble(kind, pT, obsT, maskT, rot, camp, free, state_in, huber_delta,
                   optimize_points):
    """K1: S', dU, rhs of normal_eq_schur_ref, on the card."""
    if pT.device.type == "cpu":
        return normal_eq_schur_ref(kind, pT, obsT, maskT, rot, camp, free, state_in,
                                   huber_delta, optimize_points)
    V, T, dev = _check_problem(kind, pT, obsT, maskT, rot, camp, free)
    _check("state_in", state_in, (STATE_SIZE,), dev)
    n = 6 * V
    n_tiles = math.ceil(n / _TS) ** 2
    n_chunks = max(1, min(math.ceil(T / _KT), math.ceil(_TARGET_CTAS / n_tiles)))
    chunk = math.ceil(math.ceil(T / n_chunks) / _KT) * _KT
    n_chunks = math.ceil(T / chunk)
    Spart = torch.empty((n_chunks, n, n), dtype=torch.float32, device=dev)
    vpart = torch.empty((n_chunks, 2, n), dtype=torch.float32, device=dev)
    S = torch.empty((n, n), dtype=torch.float32, device=dev)
    dU = torch.empty((n,), dtype=torch.float32, device=dev)
    rhs = torch.empty((n,), dtype=torch.float32, device=dev)
    err = library().osfm_schur_assemble(
        int(kind == "quat"), _ptr(pT), _ptr(obsT), _ptr(maskT), _ptr(rot), _ptr(camp),
        _ptr(free), _ptr(state_in), float(huber_delta), int(bool(optimize_points)), V, T,
        chunk, n_chunks, _ptr(Spart), _ptr(vpart), _ptr(S), _ptr(dU), _ptr(rhs), _stream())
    _raise_on(err, "schur_assemble")
    schur_assemble.launches += 1
    return S, dU, rhs


def camera_solve(kind, S, dU, rhs, free, state_in, rot, camp):
    """K3: delta (V, 6), rot_c (V, 4), camp_c (V, 8) of camera_solve_ref, on
    the card."""
    if S.device.type == "cpu":
        return camera_solve_ref(kind, S, dU, rhs, free, state_in, rot, camp)
    _check_kind(kind)
    V = rot.shape[0]
    n = 6 * V
    dev = S.device
    _check("S", S, (n, n), dev)
    _check("dU", dU, (n,), dev)
    _check("rhs", rhs, (n,), dev)
    _check("free", free, (V, 6), dev)
    _check("state_in", state_in, (STATE_SIZE,), dev)
    _check("rot", rot, (V, 4), dev)
    _check("camp", camp, (V, 8), dev)
    lib = library()
    n_scratch = lib.osfm_camera_solve_scratch_floats(V)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev) if n_scratch else None
    delta = torch.empty((V, 6), dtype=torch.float32, device=dev)
    rot_c = torch.empty((V, 4), dtype=torch.float32, device=dev)
    camp_c = torch.empty((V, 8), dtype=torch.float32, device=dev)
    err = lib.osfm_camera_solve(
        int(kind == "quat"), _ptr(S), _ptr(dU), _ptr(rhs), _ptr(free), _ptr(state_in),
        _ptr(rot), _ptr(camp), V, _ptr(scratch), _ptr(delta), _ptr(rot_c), _ptr(camp_c),
        _stream())
    _raise_on(err, "camera_solve")
    camera_solve.launches += 1
    return delta, rot_c, camp_c


def point_update_cost(kind, pT, obsT, maskT, rot, camp, free, state_in, delta, rot_c,
                      camp_c, huber_delta, update_points):
    """K2: (p_new (4, T), per-CTA cost partials) of point_update_cost_ref, on
    the card. ``state_in`` and ``delta`` may be None when update_points is
    False (the initial-cost mode)."""
    if pT.device.type == "cpu":
        return point_update_cost_ref(kind, pT, obsT, maskT, rot, camp, free, state_in, delta,
                                     rot_c, camp_c, huber_delta, update_points)
    V, T, dev = _check_problem(kind, pT, obsT, maskT, rot, camp, free)
    _check("rot_c", rot_c, (V, 4), dev)
    _check("camp_c", camp_c, (V, 8), dev)
    if state_in is not None:
        _check("state_in", state_in, (STATE_SIZE,), dev)
    if update_points:
        if state_in is None or delta is None:
            raise ValueError("point update needs state_in and delta")
        _check("delta", delta, (V, 6), dev)
    n_blocks = math.ceil(T / _NT)
    p_out = torch.empty((4, T), dtype=torch.float32, device=dev) if update_points else None
    parts = torch.empty((n_blocks,), dtype=torch.float32, device=dev)
    err = library().osfm_point_update_cost(
        int(kind == "quat"), _ptr(pT), _ptr(obsT), _ptr(maskT), _ptr(rot), _ptr(camp),
        _ptr(free), _ptr(state_in), _ptr(delta if update_points else None), _ptr(rot_c),
        _ptr(camp_c), float(huber_delta), int(bool(update_points)), V, T, _ptr(p_out),
        _ptr(parts), _stream())
    _raise_on(err, "point_update_cost")
    point_update_cost.launches += 1
    return (p_out if update_points else pT), parts


def lm_accept(cost_part, state_in, state_out, rot, camp, pT, rot_c, camp_c, p_c,
              cfg: LMConfig, init: bool = False):
    """K4: lm_accept_ref on the card (in place, no host sync)."""
    if pT.device.type == "cpu":
        return lm_accept_ref(cost_part, state_in, state_out, rot, camp, pT, rot_c, camp_c, p_c,
                             cfg, init=init)
    dev = pT.device
    V, T = rot.shape[0], pT.shape[1]
    if cost_part.dim() != 1:
        raise ValueError("cost_part must be 1-D")
    _check("cost_part", cost_part, cost_part.shape, dev)
    _check("state_out", state_out, (STATE_SIZE,), dev)
    if not init:
        _check("state_in", state_in, (STATE_SIZE,), dev)
    for name, t, shape in (("rot", rot, (V, 4)), ("camp", camp, (V, 8)), ("pT", pT, (4, T)),
                           ("rot_c", rot_c, (V, 4)), ("camp_c", camp_c, (V, 8))):
        _check(name, t, shape, dev)
    if p_c is not None:
        _check("p_c", p_c, (4, T), dev)
    n_blocks = max(1, min(math.ceil(4 * T / _NT), _TARGET_CTAS))
    err = library().osfm_lm_accept(
        int(bool(init)), _ptr(cost_part), cost_part.shape[0], _ptr(None if init else state_in),
        _ptr(state_out), _ptr(rot), _ptr(camp), _ptr(pT), _ptr(rot_c), _ptr(camp_c), _ptr(p_c),
        V, T, n_blocks, cfg.lam0, cfg.func_tol, cfg.lam_up, cfg.lam_down, cfg.min_lam,
        cfg.max_lam, _stream())
    _raise_on(err, "lm_accept")
    lm_accept.launches += 1


KERNELS = (schur_assemble, camera_solve, point_update_cost, lm_accept)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
