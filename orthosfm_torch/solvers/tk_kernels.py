"""The Tomasi-Kanade initialization on the card: two hand-written CUDA
kernels (orthosfm_torch/csrc/tk_kernels.cu) and, beside each, its plain
PyTorch version. The JAX package runs the same computation as one jitted
program (orthosfm_tpu/solvers/tomasi_kanade.py:193, robust_factorization:
its hypotheses vmapped, its metric upgrade a lax.scan); it has no Pallas
kernel there.

  kernel wrapper   plain version      replaces (JAX package)
  tk_factorize     tk_factorize_ref   tomasi_kanade.factorize (:49) with
  (K5)                                lm.solve and is_result_usable (:88)
  tk_score         tk_score_ref       tomasi_kanade._triangulate_and_errors
  (K6)                                (:112) and score_hypothesis's scoring

tk_factorize(obs, mask, q0, cfg, rstar=None) -> (sol1, sol2, usable, rstar):
B factorizations of obs (B, S, G, 2) pixels over the columns mask (B, S)
holds (None: every column), from the metric-upgrade inits q0 (B, 9). RStar
(B, 2G, 3) is the measurement matrix's top three left singular vectors: the
plain version takes them from torch.linalg.svd, the kernel as the top three
eigenvectors of its Gram by cyclic Jacobi; each column's sign is arbitrary
in both, so the two agree up to column signs. `rstar` given replaces them in
both (the tests hold the metric upgrade and the models given one RStar).
Returns the mirror pair (B, G, 3, 3), the validity heuristic on sol1 (B,)
and the RStar used. The kernel forms the Gram itself from up to
GRAM_INLINE_COLUMNS columns; the fallback over every valid track takes its
Gram from one torch.matmul of the centred, masked measurement matrix (a
plain product, as the JAX package's economy SVD is XLA's) and runs as one
more problem of K5.

tk_score(sol1, usable, obs, valid, width, height, samp_idx, cfg) ->
(score (H,), n_consensus (H,) int64): each hypothesis's sol1 triangulates
every valid track of obs (T, G, 2) (width, height (G,)), and the tracks
within cfg.max_inlier_reprojection_error_px at every camera and outside
the hypothesis's sample samp_idx (H, S) are its consensus; the score is
score_hypothesis's.

A wrapper given CPU tensors calls the plain version; given CUDA tensors it
launches its kernel or raises (no fallback), and reads nothing back from
the card. The kernels are built for groups of KERNEL_GROUP_SIZES views (the
per-problem state sits in registers) and samples of up to MAX_SAMPLE
tracks; other sizes raise on the card. Each wrapper counts the launches
it makes (``tk_factorize.launches``, ``tk_score.launches``;
``launch_counts()``), and none while the stream captures a CUDA graph: a
graph's replays run its kernels with no wrapper called, so count those
from the profiler's kernel records (``KERNEL_NAMES``,
utils.profiling.kernel_runs).
The library is built at first use by orthosfm_torch.kernel_build (nvcc,
into orthosfm_torch/_build/) and bound with ctypes; ``host_library()`` is
the same source built for the host (tests only: the kernels' arithmetic on
the CPU).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orthosfm_torch import kernel_build
from orthosfm_torch.config import RansacConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.solvers import lm
from orthosfm_torch.solvers.ba import solve3x3

SOURCE = kernel_build.CSRC / "tk_kernels.cu"
KERNEL_GROUP_SIZES = (2, 3, 4)  # as instantiated in the CUDA source
MAX_SAMPLE = 64                 # K6's sample indices in shared memory
GRAM_INLINE_COLUMNS = 64        # K5 forms the Gram itself up to this many columns

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FACTORIZE_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _P]
_SCORE_ARGS = [_P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _P, _P]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with every C function's signature declared."""
    return kernel_build.load(SOURCE, {"osfm_tk_factorize": [*_FACTORIZE_ARGS, _P],
                                      "osfm_tk_score": [_I, _I, _I, _I, *_SCORE_ARGS, _P]})


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The same source built by the host C++ compiler: the kernels'
    arithmetic, one problem after another, on the CPU (for tests)."""
    return kernel_build.load(SOURCE, {"osfm_tk_factorize_host": _FACTORIZE_ARGS,
                                      "osfm_tk_score_host": [_I, _I, _I, _I, *_SCORE_ARGS]},
                             host=True)


# ---------------------------------------------------------------------------
# Plain versions


def _tk_residual(q, RStar):
    """Metric-upgrade constraints and their Jacobian, batched over problems
    (reference: tomasi_kanade.h:43-117): per camera iᵀQQᵀi=1, jᵀQQᵀj=1,
    iᵀQQᵀj=0, plus 6 gauge residuals pinning camera 0 to the world axes.

    q (B, 9) row-major Q; RStar (B, 2G, 3). With u = Qᵀi and v = Qᵀj,
    ∂(u·u)/∂Q_ab = 2 i_a u_b, ∂(u·v)/∂Q_ab = i_a v_b + j_a u_b, and
    ∂u_b/∂Q_ab' = i_a δ_bb'. Returns (r (B, 3G+6), J (B, 3G+6, 9))."""
    B, G = q.shape[0], RStar.shape[1] // 2
    Q = q.reshape(B, 3, 3)
    i = RStar[:, :G]
    j = RStar[:, G:]
    u = i @ Q  # (B, G, 3)
    v = j @ Q
    r = torch.stack([torch.sum(u * u, -1) - 1.0, torch.sum(v * v, -1) - 1.0,
                     torch.sum(u * v, -1)], -1).reshape(B, 3 * G)
    c1 = u[:, 0] - RStar.new_tensor([1.0, 0.0, 0.0])
    c2 = v[:, 0] - RStar.new_tensor([0.0, 1.0, 0.0])

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    Jr = torch.stack([2.0 * outer(i, u), 2.0 * outer(j, v), outer(i, v) + outer(j, u)],
                     dim=2).reshape(B, 3 * G, 9)
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
    Jc1 = (eye3[None, :, None, :] * i[:, 0, None, :, None]).reshape(B, 3, 9)
    Jc2 = (eye3[None, :, None, :] * j[:, 0, None, :, None]).reshape(B, 3, 9)
    return torch.cat([r, c1, c2], dim=1), torch.cat([Jr, Jc1, Jc2], dim=1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


FLIP = (1.0, 1.0, -1.0)


def centered_measurements(obs, mask):
    """factorize's D (B, 2G, S): the negated pixel coordinates (x rows, then
    y rows), mean-centred over the columns `mask` (B, S) holds and zero
    elsewhere."""
    m = mask.to(obs.dtype)
    D = -torch.cat([obs[..., 0].transpose(1, 2), obs[..., 1].transpose(1, 2)], dim=1)
    count = torch.clamp(torch.sum(m, dim=1), min=1.0)
    mean = torch.sum(D * m[:, None, :], dim=2, keepdim=True) / count[:, None, None]
    return (D - mean) * m[:, None, :]


def is_result_usable(model, cfg: RansacConfig):
    """Validity heuristic, batched over models (..., G, 3, 3): reject
    factorizations with near-duplicate cameras (reference: tomasi_kanade.cpp:446-470)."""
    G = model.shape[-3]
    angles = cam_mod.basis_to_phi_theta_roll(model)  # (..., G, 3)
    dphi = torch.abs(angles[..., :, None, 0] - angles[..., None, :, 0])
    dtheta = torch.abs(angles[..., :, None, 1] - angles[..., None, :, 1])
    too_close_ang = (dphi < cfg.min_angle_separation_rad) & (dtheta < cfg.min_angle_separation_rad)
    diff = (model[..., :, None, :, :] - model[..., None, :, :, :]).reshape(
        model.shape[:-3] + (G, G, 9))
    too_close_basis = torch.linalg.vector_norm(diff, dim=-1) < cfg.min_basis_distance
    off_diag = ~torch.eye(G, dtype=torch.bool, device=model.device)
    return ~torch.any(((too_close_ang | too_close_basis) & off_diag).flatten(-2), dim=-1)


def tk_factorize_ref(obs, mask, q0, cfg: RansacConfig = RansacConfig(), rstar=None):
    """Plain version of K5 (see the module docstring): the economy SVD of D,
    lm.solve on _tk_residual, the models and is_result_usable
    (reference: tomasi_kanade.cpp:20-151)."""
    G = obs.shape[2]
    if mask is None:
        mask = torch.ones(obs.shape[:2], dtype=torch.bool, device=obs.device)
    if rstar is None:
        U, _, _ = torch.linalg.svd(centered_measurements(obs, mask), full_matrices=False)
        rstar = U[..., :3].contiguous()  # (B, 2G, 3)

    q, _ = lm.solve(_tk_residual, q0, (rstar,), iters=40)
    RFinal = rstar @ q.reshape(-1, 3, 3)  # (B, 2G, 3)

    x = RFinal[:, :G]
    y = RFinal[:, G:]
    z = torch.linalg.cross(x, y)
    combined = torch.stack([_unit(x), _unit(y), _unit(z)], dim=-1)  # (B, G, 3, 3) cols=axes
    sol1 = torch.einsum("bji,bgjk->bgik", combined[:, 0], combined)

    flip = torch.diag(obs.new_tensor(FLIP))
    combined2 = flip @ combined @ flip
    sol2 = torch.einsum("bji,bgjk->bgik", combined2[:, 0], combined2)
    return sol1, sol2, is_result_usable(sol1, cfg), rstar


def _model_geometry(model):
    """Basis trio -> (R_l2w (..., G, 3, 3), origins, look dirs) through the
    reference's angle-projection path (convertFromAxis → spherical matrix)."""
    S = cam_mod.spherical_matrix(cam_mod.basis_to_phi_theta_roll(model))
    R = cam_mod.coord_transform(S).T @ S
    o = R @ cam_mod.down(R)
    return R, o, R[..., :, 2]


def _triangulate_and_errors(model, obs, valid, width, height):
    """Triangulate all tracks under each model and return per-(track, cam)
    reprojection errors in pixels. model: (B, G, 3, 3); obs: (T, G, 2);
    valid: (T,); width/height: (G,). Returns pts (B, T, 3), err (B, T, G).

    Every ray of a model shares its camera's direction, so the normal matrix
    Σ_g (I − d dᵀ) is one per model for all valid tracks."""
    R, o, look = _model_geometry(model)  # (B, G, 3, 3), (B, G, 3), (B, G, 3)
    wh = torch.stack([width, height], -1)  # (G, 2)
    norm = -2.0 * (obs / wh[None] - 0.5)  # (T, G, 2)
    origins = (o[:, None] + norm[None, ..., 0:1] * R[:, None, :, :, 0]
               + norm[None, ..., 1:2] * R[:, None, :, :, 1])  # (B, T, G, 3)
    eye = torch.eye(3, dtype=obs.dtype, device=obs.device)
    proj = eye - look[..., :, None] * look[..., None, :]  # (B, G, 3, 3)
    A_valid = torch.sum(proj, dim=1) + 1e-8 * eye  # (B, 3, 3)
    A = torch.where(valid[None, :, None, None], A_valid[:, None], 1e-8 * eye)  # (B, T, 3, 3)
    b = torch.sum(torch.einsum("bgij,btgj->btgi", proj, origins), dim=2)
    b = b * valid[None, :, None].to(obs.dtype)
    pts = solve3x3(A, b)  # (B, T, 3)

    local = torch.einsum("bgij,bti->btgj", R, pts)  # Rᵀ·p
    pix = wh * (local[..., :2] / (-2.0) + 0.5)
    err = torch.linalg.vector_norm(pix - obs[None], dim=-1)  # (B, T, G)
    return pts, err


def tk_score_ref(sol1, usable, obs, valid, width, height, samp_idx,
                 cfg: RansacConfig = RansacConfig()):
    """Plain version of K6 (see the module docstring): the (H, T, G) errors
    of _triangulate_and_errors, the consensus and inlier sets, and
    score_hypothesis's score (reference: tomasi_kanade.cpp:225-343)."""
    T = obs.shape[0]
    H = sol1.shape[0]
    _, err = _triangulate_and_errors(sol1, obs, valid, width, height)
    in_sample = torch.zeros((H, T), dtype=torch.bool, device=obs.device)
    in_sample.scatter_(1, samp_idx, True)
    track_ok = torch.all(err <= cfg.max_inlier_reprojection_error_px, dim=2)
    consensus = valid[None] & ~in_sample & track_ok
    n_consensus = torch.sum(consensus, dim=1)

    # Model error over the inlier set (sample + consensus), matching the
    # reference's selection statistic (tomasi_kanade.cpp:318-343)
    inlier = consensus | (in_sample & valid[None])
    err_sum = torch.sum(torch.where(inlier[..., None], err, torch.zeros_like(err)), dim=(1, 2))
    mean_err = err_sum / torch.clamp(torch.sum(inlier, dim=1) * obs.shape[1], min=1)

    ok = usable & (n_consensus >= cfg.min_consensus_size)
    thr = cfg.max_inlier_reprojection_error_px
    score = torch.where(
        ok,
        n_consensus.to(obs.dtype) + (thr - torch.clamp(mean_err, 0.0, thr)) / (10.0 * thr),
        torch.full_like(mean_err, -torch.inf))
    return score, n_consensus


# ---------------------------------------------------------------------------
# Kernel wrappers


def _check(name, t, shape, device, dtype):
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


def check_group_size(G: int):
    """The kernels hold a problem's state in registers for groups of
    KERNEL_GROUP_SIZES views; another size raises (never the plain version)."""
    if G not in KERNEL_GROUP_SIZES:
        raise ValueError(f"the TK kernels are built for groups of {KERNEL_GROUP_SIZES[0]} to "
                         f"{KERNEL_GROUP_SIZES[-1]} views (a problem's state in registers), "
                         f"not {G}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def tk_factorize(obs, mask, q0, cfg: RansacConfig = RansacConfig(), rstar=None):
    """(sol1, sol2, usable, rstar) of B factorizations: see the module
    docstring. K5 on CUDA tensors, the plain version on CPU tensors."""
    dev = obs.device
    if dev.type != "cuda":
        return tk_factorize_ref(obs, mask, q0, cfg, rstar)
    B, S, G, _ = obs.shape
    check_group_size(G)
    _check("obs", obs, (B, S, G, 2), dev, torch.float32)
    _check("q0", q0, (B, 9), dev, torch.float32)
    if mask is not None:
        _check("mask", mask, (B, S), dev, torch.bool)
    if rstar is not None:
        _check("rstar", rstar, (B, 2 * G, 3), dev, torch.float32)
    gram = None
    if rstar is None and S > GRAM_INLINE_COLUMNS:
        if mask is None:
            mask = torch.ones((B, S), dtype=torch.bool, device=dev)
        D = centered_measurements(obs, mask)
        gram = torch.matmul(D, D.transpose(1, 2)).contiguous()  # (B, 2G, 2G)
    sol1 = torch.empty((B, G, 3, 3), dtype=torch.float32, device=dev)
    sol2 = torch.empty_like(sol1)
    usable = torch.empty((B,), dtype=torch.bool, device=dev)
    rstar_out = torch.empty((B, 2 * G, 3), dtype=torch.float32, device=dev)
    if B == 0:
        return sol1, sol2, usable, rstar_out
    err = library().osfm_tk_factorize(
        G, B, S, None if gram is not None else obs.data_ptr(),
        None if gram is not None else _ptr(mask), _ptr(gram), _ptr(rstar), q0.data_ptr(),
        cfg.min_angle_separation_rad, cfg.min_basis_distance, sol1.data_ptr(), sol2.data_ptr(),
        usable.data_ptr(), rstar_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "tk_factorize")
    if not torch.cuda.is_current_stream_capturing():
        tk_factorize.launches += 1
    return sol1, sol2, usable, rstar_out


def tk_score(sol1, usable, obs, valid, width, height, samp_idx,
             cfg: RansacConfig = RansacConfig()):
    """(score (H,), n_consensus (H,) int64) of H hypotheses: see the module
    docstring. K6 on CUDA tensors, the plain version on CPU tensors."""
    dev = obs.device
    if dev.type != "cuda":
        return tk_score_ref(sol1, usable, obs, valid, width, height, samp_idx, cfg)
    T, G, _ = obs.shape
    H, S = samp_idx.shape
    check_group_size(G)
    if S > MAX_SAMPLE:
        raise ValueError(f"the TK score kernel takes samples of up to {MAX_SAMPLE} tracks, not {S}")
    _check("sol1", sol1, (H, G, 3, 3), dev, torch.float32)
    _check("usable", usable, (H,), dev, torch.bool)
    _check("obs", obs, (T, G, 2), dev, torch.float32)
    _check("valid", valid, (T,), dev, torch.bool)
    _check("width", width, (G,), dev, torch.float32)
    _check("height", height, (G,), dev, torch.float32)
    _check("samp_idx", samp_idx, (H, S), dev, torch.int64)
    score = torch.empty((H,), dtype=torch.float32, device=dev)
    n_consensus = torch.empty((H,), dtype=torch.int64, device=dev)
    if H == 0:
        return score, n_consensus
    thr = cfg.max_inlier_reprojection_error_px
    err = library().osfm_tk_score(
        G, H, T, S, sol1.data_ptr(), usable.data_ptr(), obs.data_ptr(),
        valid.data_ptr(), width.data_ptr(), height.data_ptr(), samp_idx.data_ptr(), thr,
        10.0 * thr, cfg.min_consensus_size, score.data_ptr(), n_consensus.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "tk_score")
    if not torch.cuda.is_current_stream_capturing():
        tk_score.launches += 1
    return score, n_consensus


def tk_factorize_host(obs, mask, q0, cfg: RansacConfig = RansacConfig(), rstar=None, gram=None):
    """K5's arithmetic on CPU tensors (host_library, tests only): the same
    inputs and outputs as tk_factorize; `gram` (B, 2G, 2G) in place of the
    Gram K5 forms from obs."""
    B, S, G, _ = obs.shape
    check_group_size(G)
    sol1 = torch.empty((B, G, 3, 3), dtype=torch.float32)
    sol2 = torch.empty_like(sol1)
    usable = torch.empty((B,), dtype=torch.bool)
    rstar_out = torch.empty((B, 2 * G, 3), dtype=torch.float32)
    keep = [t if t is None else t.contiguous() for t in (obs, mask, gram, rstar, q0)]
    host_library().osfm_tk_factorize_host(
        G, B, S, *map(_ptr, keep), cfg.min_angle_separation_rad, cfg.min_basis_distance,
        sol1.data_ptr(), sol2.data_ptr(), usable.data_ptr(), rstar_out.data_ptr())
    return sol1, sol2, usable, rstar_out


def tk_score_host(sol1, usable, obs, valid, width, height, samp_idx,
                  cfg: RansacConfig = RansacConfig()):
    """K6's arithmetic on CPU tensors (host_library, tests only): the same
    inputs and outputs as tk_score."""
    T, G, _ = obs.shape
    H, S = samp_idx.shape
    check_group_size(G)
    score = torch.empty((H,), dtype=torch.float32)
    n_consensus = torch.empty((H,), dtype=torch.int64)
    keep = [t.contiguous() for t in (sol1, usable, obs, valid, width, height, samp_idx)]
    thr = cfg.max_inlier_reprojection_error_px
    host_library().osfm_tk_score_host(
        G, H, T, S, *(t.data_ptr() for t in keep), thr, 10.0 * thr, cfg.min_consensus_size,
        score.data_ptr(), n_consensus.data_ptr())
    return score, n_consensus


def reset_launch_counts():
    tk_factorize.launches = tk_score.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset_launch_counts()."""
    return {"tk_factorize": tk_factorize.launches, "tk_score": tk_score.launches}


#: each kernel's name in a profiler's kernel records, by launch_counts()' keys
KERNEL_NAMES = {"tk_factorize": "tk_factorize_kernel", "tk_score": "tk_score_kernel"}


reset_launch_counts()
