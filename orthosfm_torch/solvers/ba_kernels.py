"""The three stages of one bundle-adjustment LM iteration: hand-written CUDA
kernels for Hopper (orthosfm_torch/csrc/ba_kernels.cu) and, beside each, its
plain PyTorch version.

  stage                 kernel wrapper       plain version          replaces (JAX package)
  assemble              schur_assemble       normal_eq_schur_ref    ba_pallas.normal_eq_schur,
                                                                    ba_fused.run_lm pass 1
  camera solve+retract  camera_solve         camera_solve_ref       ba_fused._gauss_jordan and the
                                                                    in-kernel reduced system
                                                                    (a Cholesky on the card, LU in
                                                                    the plain version)
  point update + cost   PointUpdateCost      point_update_accept_ref  ba_pallas.point_update_cost,
  + accept              (K2, its last CTA    (point_update_cost_ref   ba_fused.run_lm pass 2 and
                        the accept rule)     then lm_accept_ref)      accept/λ/done
  accept (sharded LM)   lm_accept (K4)       lm_accept_state_ref      ba.py:444-513 with
                                                                    cost_reduce_fn (psum)

K3 has four routes (CAMERA_SOLVE_ROUTES): one warp, one CTA, a cluster of 8
CTAs and the grid route over the whole card; camera_solve_route(V) names the
one it takes for V views. The sharded LM (parallel/ba_sharded.py) runs K2 in
split mode (its last CTA sums the shard's cost and applies no rule), sums
that cost over the shards and runs K4 on the sum.

A wrapper given CPU tensors calls the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches in a plain
integer attribute (``schur_assemble.launches``, ``camera_solve.launches``
and ``camera_solve.route_launches`` by route, ``PointUpdateCost.launches``,
``lm_accept.launches``); ``launch_counts()`` reads them by kernel name.

The scalar LM state is a float tensor of STATE_SIZE entries
[λ, cost, iterations, done, initial cost, current half, 0, 0]; ba.run keeps
two slots and alternates them, so each iteration reads one and writes the
other. The LM buffers (``lm_buffers``) hold the points (2, 4, T), rotations
(2, V, 4) and packed camera params (2, V, 8) in two halves; the state's
CUR slot names the current half. K1 reads it, K3 writes the candidate
cameras and K2 the candidate points into the other half, and an accepted
step flips CUR: nothing is copied. K1, K3 and K2 and their plain versions
take the LM buffers; point_update_cost_ref and lm_accept_ref, the two halves
of K2's plain version, take single tensors.

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

LAM, COST, ITERS, DONE, INIT_COST, CUR = 0, 1, 2, 3, 4, 5
STATE_SIZE = 8

SOURCE = kernel_build.CSRC / "ba_kernels.cu"

# Launch geometry shared with the CUDA source
_TC = 32           # tracks per chunk of K1's block pass (one CTA each)
_PT = 32           # edge of the product's output tiles
_NU = 27           # per-view sums of the block pass: U's upper triangle and the rhs
_PRODUCT_CTAS = 1056  # aim of the product's split over K: eight 64-thread CTAs per SM
_K2_TRACKS = 32    # tracks per CTA of K2, one a lane
_K2_MAXW = 16      # warps per CTA of K2 at most
_K2_VIEWS_PER_WARP = 4  # views each warp of K2 walks, up to _K2_MAXW warps
# K3's routes, in the order of the CUDA source's Route enum. K1 and K2 keep
# their per-view tables in shared memory up to ~600 and ~990 views and in
# global memory past that; no kernel has a view limit but the card's memory.
CAMERA_SOLVE_ROUTES = ("warp", "cta", "cluster", "grid")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The LM schedule constants of the accept rule (lm_accept_ref and K2's
    last CTA)."""

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


def lm_buffers(*xs):
    """The LM buffers of the given tensors, each (2, *x.shape) with both
    halves holding x (a fresh state names half 0): ba.run's points (2, 4, T),
    rotations (2, V, 4) and packed camera params (2, V, 8)."""
    return tuple(torch.stack([x, x]).contiguous() for x in xs)


def current(buf, state):
    """The half of an LM buffer that state[CUR] names (no host sync)."""
    return torch.where(state[CUR] != 0, buf[1], buf[0])


def _put_candidate(buf, x, state):
    """Writes x into the half of `buf` that state[CUR] does not name."""
    buf.copy_(torch.where(state[CUR] != 0, torch.stack([x, buf[1]]), torch.stack([buf[0], x])))


# ---------------------------------------------------------------------------
# Plain PyTorch versions


def schur_views(out, n):
    """(S (n, n), dU (n,), rhs (n,)) as views of one flat buffer of
    n·n + 2n floats, S first: the sharded LM all-reduces the three in one
    collective."""
    return out[:n * n].view(n, n), out[n * n:n * n + n], out[n * n + n:]


def normal_eq_schur_ref(kind, pT, obsT, maskT, rot, camp, free, state_in, huber_delta,
                        optimize_points, out=None):
    """S' (n, n) = blkdiag(U) − W V̂⁻¹ Wᵀ in block-major (view·6 + param)
    order, dU (n,) = diag(U), rhs (n,) = g_c − W V̂⁻¹ g_p, with n = 6V — the
    contract of the JAX package's ba_pallas.normal_eq_schur, at the current
    halves of the LM buffers pT, rot and camp. With ``out`` (n·n + 2n
    floats) the three are written there (schur_views) and returned as its
    views."""
    pT, rot, camp = (current(x, state_in) for x in (pT, rot, camp))
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
    if out is None:
        return S, dU, rhs
    views = schur_views(out, 6 * V)
    for dst, src in zip(views, (S, dU, rhs)):
        dst.copy_(src)
    return views


def retract_params(kind, rot, camp, delta):
    """Candidate (rot, camp) after the camera step delta (V, 6)
    (cameras.retract on the packed parameters)."""
    rot_c = cam_mod.retract_rotation(kind, rot, delta)
    z = torch.zeros_like(delta[:, :1])
    step = torch.cat([delta[:, 5:6], z, z, delta[:, 3:5], z, z, z], dim=1)
    return rot_c.contiguous(), (camp + step).contiguous()


def camera_solve_ref(kind, S, dU, rhs, free, state_in, rot, camp):
    """Damped, pinned, Jacobi-scaled dense solve of the reduced camera system
    (ba._solve_camera_system, torch.linalg.solve) and the camera retraction
    of the current half of the LM buffers rot (2, V, 4) and camp (2, V, 8);
    the candidate cameras go into the other half. Returns delta (V, 6)."""
    delta = ba._solve_camera_system(S, dU, rhs, free, state_in[LAM])
    rot_c, camp_c = retract_params(kind, current(rot, state_in), current(camp, state_in), delta)
    _put_candidate(rot, rot_c, state_in)
    _put_candidate(camp, camp_c, state_in)
    return delta.contiguous()


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


def lm_accept_state_ref(cost, state_in, state_out, cfg: LMConfig):
    """K4's plain version: lm_accept_ref's rule on the scalar state alone,
    for the LM buffers, where an accepted step flips state_out[CUR]
    instead of copying the candidates. cost: the candidate's cost (1,)
    (summed over the shards); state_in None: the first state."""
    init = state_in is None
    dummy = cost.new_zeros(())
    lm_accept_ref(cost, state_in, state_out, dummy, dummy.clone(), dummy.clone(), dummy, dummy,
                  None, cfg, init=init)
    if not init:
        acc = (state_in[DONE] == 0) & (torch.sum(cost) < state_in[COST])
        cur = (state_in[CUR] != 0).to(state_in.dtype)
        state_out[CUR] = torch.where(acc, 1.0 - cur, cur)


def point_update_accept_ref(kind, pT, obsT, maskT, rot, camp, free, state_in, state_out, delta,
                            huber_delta, update_points, cfg: LMConfig):
    """K2 with its accept tail, plain: point_update_cost_ref, then
    lm_accept_ref, on the LM buffers pT (2, 4, T), rot (2, V, 4) and
    camp (2, V, 8) with the kernel's bookkeeping: the current half is the one
    state_in[CUR] names, the candidate cameras are in the other, the
    candidate points are written there, and on acceptance state_out[CUR]
    names it. With state_in None: the initial cost (current cameras as
    candidates, points not updated) into state_out; with state_out None: no
    accept. Returns the cost partials (1,)."""
    init = state_in is None
    s = torch.zeros(STATE_SIZE, dtype=pT.dtype, device=pT.device) if init else state_in
    other = s.clone()
    other[CUR] = 1.0 - (s[CUR] != 0).to(s.dtype)
    p_cur, r_cur, c_cur = (current(x, s) for x in (pT, rot, camp))
    r_c, c_c = (r_cur, c_cur) if init else (current(rot, other), current(camp, other))
    upd = bool(update_points) and not init
    p_new, parts = point_update_cost_ref(kind, p_cur, obsT, maskT, r_cur, c_cur, free, state_in,
                                         delta, r_c, c_c, huber_delta, upd)
    if upd:
        _put_candidate(pT, p_new, s)
    if state_out is not None:
        lm_accept_state_ref(parts, state_in, state_out, cfg)
    return parts


# ---------------------------------------------------------------------------
# Build and binding


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "osfm_schur_assemble": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "osfm_camera_solve": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "osfm_point_update_cost": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                               _I, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _P],
    "osfm_lm_accept": [_P, _P, _P, _F, _F, _F, _F, _F, _F, _P],
    "osfm_camera_solve_route": [_I, _I],
    "osfm_camera_solve_scratch_floats": [_I, _I],
    "osfm_schur_table_floats": [_I],
    "osfm_k2_table_floats": [_I],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with every C function's signature declared."""
    lib = kernel_build.load(SOURCE, _SIGNATURES)
    lib.osfm_camera_solve_scratch_floats.restype = ctypes.c_longlong  # past 2^31 floats
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _halves(t):
    """Device addresses of the two halves of an LM buffer (2, ...)."""
    p = t.data_ptr()
    return p, p + 2 * t.numel()  # half of numel() floats of 4 bytes


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


def _check_buffer(name: str, t, shape, device):
    """An LM buffer of shape (2, *shape)."""
    if isinstance(t, torch.Tensor) and t.dim() != len(shape) + 1:
        raise ValueError(f"{name} must be an LM buffer of shape (2, {', '.join(map(str, shape))})")
    _check(name, t, (2, *shape), device)


def _check_kind(kind):
    if kind not in ("quat", "euler"):
        raise ValueError(f"unknown camera kind {kind!r}")


def _check_problem(kind, pT, obsT, maskT, rot, camp, free):
    _check_kind(kind)
    V, T = obsT.shape[0], obsT.shape[2]
    if T < 1 or V < 1:
        raise ValueError("empty bundle-adjustment problem")
    dev = obsT.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev.type} tensors")
    _check_buffer("pT", pT, (4, T), dev)
    _check("obsT", obsT, (V, 2, T), dev)
    _check("maskT", maskT, (V, T), dev)
    _check_buffer("rot", rot, (V, 4), dev)
    _check_buffer("camp", camp, (V, 8), dev)
    _check("free", free, (V, 6), dev)
    return V, T, dev


# ---------------------------------------------------------------------------
# Kernel wrappers


def schur_plan(V: int, T: int) -> tuple:
    """K1's geometry for V views and T tracks: (ldx, n_chunks, n_split, cps).
    The scratch holds 3·_TC columns per chunk of n = 6V floats padded to
    ldx; the product runs over the upper-triangle tiles of the output, split
    over K into n_split ranges of cps chunks."""
    n = 6 * V
    ldx = math.ceil(n / _PT) * _PT
    n_chunks = math.ceil(T / _TC)
    nt = ldx // _PT
    n_split = max(1, min(n_chunks, math.ceil(_PRODUCT_CTAS / (nt * (nt + 1) // 2))))
    cps = math.ceil(n_chunks / n_split)
    return ldx, n_chunks, math.ceil(n_chunks / cps), cps


@functools.lru_cache(maxsize=None)
def _schur_table_floats(V: int) -> int:
    """Floats of K1's global camera tables at V views (0 below ~600)."""
    return library().osfm_schur_table_floats(V)


def schur_assemble(kind, pT, obsT, maskT, rot, camp, free, state_in, huber_delta,
                   optimize_points, out=None):
    """K1: S', dU, rhs of normal_eq_schur_ref, on the card, from the half of
    the LM buffers pT, rot and camp that state_in[CUR] names; with ``out``
    (n·n + 2n floats) into its views (schur_views)."""
    if pT.device.type == "cpu":
        return normal_eq_schur_ref(kind, pT, obsT, maskT, rot, camp, free, state_in,
                                   huber_delta, optimize_points, out)
    V, T, dev = _check_problem(kind, pT, obsT, maskT, rot, camp, free)
    _check("state_in", state_in, (STATE_SIZE,), dev)
    n = 6 * V
    if out is None:
        out = torch.empty((n * n + 2 * n,), dtype=torch.float32, device=dev)
    _check("out", out, (n * n + 2 * n,), dev)
    ldx, n_chunks, n_split, cps = schur_plan(V, T)
    opt = bool(optimize_points)
    nt = ldx // _PT
    # one float workspace: the X and Y scratch (only when points move), the
    # blocks' per-chunk sums and the product's per-split tiles, each at a
    # 16-byte aligned offset
    sizes = [3 * _TC * n_chunks * ldx if opt else 0] * 2 + [
        n_chunks * V * _NU, (n_split * nt * (nt + 1) // 2 if opt else 0) * _PT * _PT]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + -(-size // 4) * 4)
    n_tables = _schur_table_floats(V)
    ws = torch.empty((offsets[-1] + n_tables,), dtype=torch.float32, device=dev)
    Xk, Yk, vpart, Ppart, gcams = (ws.data_ptr() + 4 * o for o in offsets)
    gcams = gcams if n_tables else None
    counts = torch.empty((n_chunks,), dtype=torch.int32, device=dev)
    S, dU, rhs = schur_views(out, n)
    err = library().osfm_schur_assemble(
        int(kind == "quat"), *_halves(pT), _ptr(obsT), _ptr(maskT), *_halves(rot),
        *_halves(camp), _ptr(free), _ptr(state_in), float(huber_delta), int(opt), V, T, ldx,
        n_chunks, n_split, cps, gcams, Xk, Yk, _ptr(counts), vpart, Ppart, _ptr(S), _ptr(dU),
        _ptr(rhs), _stream())
    _raise_on(err, "schur_assemble")
    schur_assemble.launches += 1
    return S, dU, rhs


def camera_solve_route(V: int, route=None) -> str:
    """The route K3 takes for V views: `route` (one of
    CAMERA_SOLVE_ROUTES) where it can serve V views, else raises; None: the
    automatic choice (the grid route from the crossover measured on the
    card, GRID_MIN_V in the CUDA source)."""
    code = -1 if route is None else CAMERA_SOLVE_ROUTES.index(route)
    got = library().osfm_camera_solve_route(V, code)
    if got < 0:
        raise ValueError(f"K3's {route} route cannot serve {V} views")
    return CAMERA_SOLVE_ROUTES[got]


def camera_solve(kind, S, dU, rhs, free, state_in, rot, camp, route=None):
    """K3: camera_solve_ref on the card, by a Cholesky factorization: returns
    delta (V, 6) and writes the candidate cameras into the half of the LM
    buffers rot and camp that state_in[CUR] does not name. Where it meets a
    pivot that is not positive (an indefinite system) every entry of delta
    is NaN, so the LM step is rejected; the plain version's LU solves such a
    system. ``route`` forces one of CAMERA_SOLVE_ROUTES (None: the automatic
    choice, camera_solve_route)."""
    if S.device.type == "cpu":
        return camera_solve_ref(kind, S, dU, rhs, free, state_in, rot, camp)
    _check_kind(kind)
    V = rot.shape[1]
    n = 6 * V
    dev = S.device
    _check("S", S, (n, n), dev)
    _check("dU", dU, (n,), dev)
    _check("rhs", rhs, (n,), dev)
    _check("free", free, (V, 6), dev)
    _check("state_in", state_in, (STATE_SIZE,), dev)
    _check_buffer("rot", rot, (V, 4), dev)
    _check_buffer("camp", camp, (V, 8), dev)
    if S.data_ptr() % 16:
        raise ValueError("S must be 16-byte aligned (the kernel reads it as float4)")
    lib = library()
    name = camera_solve_route(V, route)
    code = CAMERA_SOLVE_ROUTES.index(name)
    n_scratch = lib.osfm_camera_solve_scratch_floats(V, code)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev) if n_scratch else None
    delta = torch.empty((V, 6), dtype=torch.float32, device=dev)
    err = lib.osfm_camera_solve(
        int(kind == "quat"), _ptr(S), _ptr(dU), _ptr(rhs), _ptr(free), _ptr(state_in),
        *_halves(rot), *_halves(camp), V, code, _ptr(scratch), _ptr(delta), _stream())
    _raise_on(err, "camera_solve")
    camera_solve.launches += 1
    camera_solve.route_launches[name] += 1
    return delta


def _k2_warps(V: int) -> int:
    """K2's warps per CTA: one for every _K2_VIEWS_PER_WARP views, up to
    _K2_MAXW (the fastest of 1, 2, 4, 8 and 16 warps at 3 x 7800, 16 x 8192
    and 64 x 4096 on an H100, scripts/torch_ba_kernel_turns.py)."""
    return min(_K2_MAXW, math.ceil(V / _K2_VIEWS_PER_WARP))


class PointUpdateCost:
    """K2 with its accept tail, bound to one problem's LM buffers pT
    (2, 4, T), rot (2, V, 4), camp (2, V, 8): it checks them and allocates
    its cost partials and ticket once; each call is one launch. Called with
    (state_in, state_out, delta), it updates the points from the current
    half into the other, computes the robust cost at the candidate half, and
    in its last CTA applies lm_accept's rule, writing state_out, whose CUR
    names the other half on acceptance. With state_in None: the initial
    cost; with state_out None: no accept tail. Returns the cost partials.
    With split=True (the sharded LM) state_out must be None and each call
    returns the summed cost (1,) instead, summed by the last CTA in the
    tail's order; lm_accept then applies the rule to it. With CPU tensors,
    or plain=True (ba.run's impl "torch"), each call runs
    point_update_accept_ref."""

    launches = 0

    def __init__(self, kind, pT, obsT, maskT, rot, camp, free, huber_delta, update_points,
                 cfg: LMConfig, plain: bool = False, split: bool = False):
        self.kind, self.pT, self.obsT, self.maskT = kind, pT, obsT, maskT
        self.rot, self.camp, self.free, self.cfg = rot, camp, free, cfg
        self.huber_delta, self.update_points = float(huber_delta), bool(update_points)
        self.plain = plain or pT.device.type == "cpu"
        self.split = bool(split)
        if self.plain:
            return
        V, T, self.device = _check_problem(kind, pT, obsT, maskT, rot, camp, free)
        self.V = V
        warps = _k2_warps(V)
        self.parts = torch.empty((math.ceil(T / _K2_TRACKS),), dtype=torch.float32,
                                 device=self.device)
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self.cost = torch.zeros((1,), dtype=torch.float32, device=self.device)
        n_tables = library().osfm_k2_table_floats(V)
        self.tables = (torch.empty((n_tables,), dtype=torch.float32, device=self.device)
                       if n_tables else None)
        self._args = ((int(kind == "quat"), *_halves(pT), _ptr(obsT), _ptr(maskT),
                       *_halves(rot), *_halves(camp), _ptr(free)),
                      (self.huber_delta, int(self.update_points), V, T, warps,
                       _ptr(self.tables)),
                      (_ptr(self.parts), _ptr(self.ticket), cfg.lam0, cfg.func_tol, cfg.lam_up,
                       cfg.lam_down, cfg.min_lam, cfg.max_lam))

    def __call__(self, state_in, state_out, delta=None):
        if self.split and state_out is not None:
            raise ValueError("K2 in split mode applies no rule: state_out must be None")
        if self.plain:
            return point_update_accept_ref(self.kind, self.pT, self.obsT, self.maskT, self.rot,
                                           self.camp, self.free, state_in, state_out, delta,
                                           self.huber_delta, self.update_points, self.cfg)
        for name, t, shape in (("state_in", state_in, (STATE_SIZE,)),
                               ("state_out", state_out, (STATE_SIZE,)),
                               ("delta", delta, (self.V, 6))):
            if t is not None:
                _check(name, t, shape, self.device)
        if self.update_points and state_in is not None and delta is None:
            raise ValueError("the point update needs delta")
        head, mid, tail = self._args
        parts, ticket, *rule = tail
        err = library().osfm_point_update_cost(*head, _ptr(state_in), _ptr(delta), *mid,
                                               _ptr(state_out), parts, ticket,
                                               _ptr(self.cost) if self.split else None, *rule,
                                               _stream())
        _raise_on(err, "point_update_cost")
        PointUpdateCost.launches += 1
        return self.cost if self.split else self.parts


def lm_accept(cost, state_in, state_out, cfg: LMConfig, plain: bool = False):
    """K4: the LM accept rule of K2's tail as a launch of its own, on the
    candidate's cost (1,) (the sharded LM's, summed over the shards),
    without a host sync: writes state_out, whose CUR names the other half
    of the LM buffers on acceptance; state_in None: the first state. With a
    CPU cost, or plain=True, lm_accept_state_ref."""
    if plain or cost.device.type == "cpu":
        lm_accept_state_ref(cost, state_in, state_out, cfg)
        return
    dev = cost.device
    _check("cost", cost, (1,), dev)
    _check("state_out", state_out, (STATE_SIZE,), dev)
    if state_in is not None:
        _check("state_in", state_in, (STATE_SIZE,), dev)
    err = library().osfm_lm_accept(_ptr(state_in), _ptr(cost), _ptr(state_out), cfg.lam0,
                                   cfg.func_tol, cfg.lam_up, cfg.lam_down, cfg.min_lam,
                                   cfg.max_lam, _stream())
    _raise_on(err, "lm_accept")
    lm_accept.launches += 1


def reset_launch_counts():
    schur_assemble.launches = camera_solve.launches = PointUpdateCost.launches = 0
    lm_accept.launches = 0
    camera_solve.route_launches = dict.fromkeys(CAMERA_SOLVE_ROUTES, 0)


def launch_counts() -> dict:
    """Launches of each kernel since the last reset_launch_counts(), by name
    (K4 lm_accept: its own launches, the sharded LM's; unsharded its rule
    runs in K2's last CTA)."""
    return {"schur_assemble": schur_assemble.launches, "camera_solve": camera_solve.launches,
            "point_update_cost": PointUpdateCost.launches, "lm_accept": lm_accept.launches}


def route_launches() -> dict:
    """camera_solve's launches since the last reset_launch_counts(), by route."""
    return dict(camera_solve.route_launches)


reset_launch_counts()
