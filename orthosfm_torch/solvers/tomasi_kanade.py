"""Tomasi-Kanade factorization initialization with batched RANSAC.

Port of orthosfm_tpu/solvers/tomasi_kanade.py (reference: the OpenMP RANSAC
loop of src/algorithms/tomasi_kanade.cpp:20-470). All hypotheses run as one
batched tensor computation: Gumbel top-k sampling replaces std::sample, the
Ceres DENSE_QR metric upgrade is a batched dense LM (solvers/lm.py),
consensus scoring is a masked reduction and the best model an argmax.

Randomness comes from an explicit torch.Generator. The JAX package draws
with JAX keys, which torch cannot reproduce, so `score_hypothesis`,
`robust_factorization` and `factorize` also accept the sample indices and
metric-upgrade inits as inputs (tests feed them the JAX draws).

On the card the whole call is one device program with no host round trip,
as the JAX package's jitted one: the draws, K5 (tk_kernels.tk_factorize:
every hypothesis's factorization, metric upgrade and validity in one
launch), K6 (tk_kernels.tk_score: every hypothesis's triangulation and
consensus score in one launch), the fallback's Gram and its K5 launch, and
the argmax and selection, all enqueued without a sync. On the CPU the
wrappers run their plain versions.

Terminology follows the paper/reference: D is the 2G×S measurement matrix of
mean-centered negated pixel coordinates, RStar its first three left singular
vectors, Q the 3×3 metric-upgrade matrix, and the two returned models are the
depth-ambiguity mirror pair (flip diag(1,1,−1)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orthosfm_torch.config import RansacConfig
from orthosfm_torch.solvers import tk_kernels
from orthosfm_torch.solvers.tk_kernels import (  # noqa: F401  (this module's API)
    _model_geometry, _tk_residual, _unit, is_result_usable)


def factorize(obs, mask, q0=None, generator: Optional[torch.Generator] = None):
    """Batched TK factorizations on masked observations.

    obs: (B, S, G, 2) pixels; mask: (B, S) valid columns; q0: (B, 9)
    metric-upgrade inits, drawn uniformly in [-1, 1) from ``generator`` when
    not given. Returns the mirror pair (model1, model2), each
    (B, G, 3, 3) basis matrices normalized so camera 0 is the identity
    (reference: tomasi_kanade.cpp:20-151). K5 (tk_kernels.tk_factorize) on
    CUDA tensors, its plain version on CPU tensors."""
    if q0 is None:
        q0 = torch.rand((obs.shape[0], 9), generator=generator, device=obs.device) * 2.0 - 1.0
    sol1, sol2, _, _ = tk_kernels.tk_factorize(obs, mask, q0)
    return sol1, sol2


class TKResult(NamedTuple):
    model1: torch.Tensor  # (G, 3, 3)
    model2: torch.Tensor  # mirror solution
    num_inliers: torch.Tensor
    found: torch.Tensor  # bool — consensus model found (else fallback used)


def draw_hypotheses(valid, cfg: RansacConfig, generator: torch.Generator):
    """RANSAC draws from ``generator``: sample indices (H, S) — a uniform
    sample of S valid tracks without replacement per hypothesis (Gumbel
    top-k) — metric-upgrade inits (H, 9) in [-1, 1), and the fallback's
    init (9,)."""
    H, S, T = cfg.max_iterations, cfg.sample_size, valid.shape[0]
    dev = valid.device
    u = torch.rand((H, T), generator=generator, device=dev).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(valid[None, :], gumbel, torch.full_like(gumbel, -torch.inf))
    samp_idx = torch.topk(scores, S, dim=1).indices
    q0 = torch.rand((H + 1, 9), generator=generator, device=dev) * 2.0 - 1.0
    return samp_idx, q0[:H], q0[H]


def score_hypothesis(obs, valid, width, height, cfg: RansacConfig, samp_idx=None, q0=None,
                     generator: Optional[torch.Generator] = None):
    """All RANSAC hypotheses at once: factorize each sample → validity
    heuristic → triangulate → consensus score (reference:
    tomasi_kanade.cpp:225-343). samp_idx (H, S) and q0 (H, 9) are the draws,
    taken from ``generator`` (draw_hypotheses) when not given.

    Returns (samp_idx, score (H,), n_consensus (H,), model1 (H, G, 3, 3), model2)."""
    if samp_idx is None:
        samp_idx, q0, _ = draw_hypotheses(valid, cfg, generator)
    obs = obs.contiguous()
    sol1, sol2, usable, _ = tk_kernels.tk_factorize(obs[samp_idx], None, q0, cfg)
    score, n_consensus = tk_kernels.tk_score(sol1, usable, obs, valid, width.contiguous(),
                                             height.contiguous(), samp_idx, cfg)
    return samp_idx, score, n_consensus, sol1, sol2


def robust_factorization(obs, valid, width, height, cfg: RansacConfig = RansacConfig(),
                         generator: Optional[torch.Generator] = None,
                         samp_idx=None, q0=None, q0_fallback=None) -> TKResult:
    """RANSAC'd TK factorization (reference: tomasi_kanade.cpp:193-370).

    obs: (T, G, 2) pixel observations of full-group tracks; valid: (T,) mask.
    The draws come from ``generator`` unless given. The fallback (factorize on
    all valid tracks) is always computed and selected when no hypothesis
    reaches the consensus threshold, so the choice needs no host sync.
    """
    if samp_idx is None:
        if generator is None:
            raise ValueError("robust_factorization needs a generator or injected draws")
        samp_idx, q0, q0_fallback = draw_hypotheses(valid, cfg, generator)
    G = obs.shape[1]
    width, height = (per_camera(x, G, obs) for x in (width, height))

    _, scores, n_con, sol1, sol2 = score_hypothesis(obs, valid, width, height, cfg,
                                                   samp_idx=samp_idx, q0=q0)
    return select_model(obs, valid, scores, n_con, sol1, sol2, samp_idx.shape[1], q0_fallback)


def per_camera(x, G: int, like):
    """An image width or height as a (G,) tensor on ``like``'s device: a
    number is filled there (no host-to-device copy), a tensor broadcast."""
    if isinstance(x, (int, float)):
        return torch.full((G,), float(x), dtype=like.dtype, device=like.device)
    return torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype, device=like.device), (G,))


def select_model(obs, valid, scores, n_con, sol1, sol2, sample_size: int,
                 q0_fallback) -> TKResult:
    """The best-scoring hypothesis's mirror pair, or, when none reached the
    consensus threshold (every score −inf), the factorization over all
    valid tracks (tomasi_kanade.cpp:361-365), chosen on the device with no
    host sync (index_select: indexing with a tensor would read it back)."""
    best = torch.argmax(scores).reshape(1)

    def pick(x):
        return x.index_select(0, best)[0]

    found = pick(scores) > -torch.inf
    fb1, fb2 = factorize(obs[None].contiguous(), valid[None], q0_fallback[None])
    model1 = torch.where(found, pick(sol1), fb1[0])
    model2 = torch.where(found, pick(sol2), fb2[0])
    num_inliers = torch.where(found, pick(n_con) + sample_size, torch.sum(valid))
    return TKResult(model1=model1, model2=model2, num_inliers=num_inliers, found=found)


def resolve_ambiguity(model1, model2, global_dir):
    """Pick the mirror solution whose cam0→cam1 origin direction best matches
    the already-aligned global cameras (reference: tomasi_kanade.cpp:372-444).
    global_dir: (3,), or None for the first group."""
    if global_dir is None:
        return model1

    def local_vec(model):
        on = _unit(_model_geometry(model)[1])
        return on[1] - on[0]

    s1 = torch.dot(global_dir, local_vec(model1))
    s2 = torch.dot(global_dir, local_vec(model2))
    return torch.where(s1 > s2, model1, model2)
