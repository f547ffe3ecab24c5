"""Distributed Tomasi-Kanade RANSAC, its hypotheses sharded over the mesh:
port of orthosfm_tpu/parallel/tk_sharded.py over torch.distributed.

The reference parallelizes its RANSAC iterations with OpenMP threads
(tomasi_kanade.cpp:225). Here every rank draws all hypotheses from the same
seeded generator (tomasi_kanade.draw_hypotheses), so the draws do not depend
on the world size, and scores its slice of them (sampling is done;
factorization, metric upgrade, triangulation, consensus). Only the scores,
consensus counts and mirror pairs are all-gathered, a few hundred floats a
hypothesis batch, and every rank takes the same argmax.
"""

from __future__ import annotations

import torch

from orthosfm_torch.config import RansacConfig
from orthosfm_torch.parallel.mesh import Mesh, pad_to_multiple
from orthosfm_torch.solvers import tomasi_kanade as tk


def make_sharded_tk(mesh: Mesh, cfg: RansacConfig = RansacConfig()):
    """Returns run(obs, valid, width, height, generator) -> tk.TKResult, with
    the semantics of tomasi_kanade.robust_factorization, called on every
    rank with the same inputs and a generator seeded alike.

    The hypothesis axis is padded to a multiple of the world size with
    copies of hypothesis 0 whose scores are masked to −inf, so the argmax
    picks from exactly the unsharded set; the winner's mirror pair is the
    one its rank factorized (the JAX package factorizes the winner again
    from the same key, which gives the same pair)."""

    def run(obs, valid, width, height, generator) -> tk.TKResult:
        samp_idx, q0, q0_fallback = tk.draw_hypotheses(valid, cfg, generator)
        G = obs.shape[1]
        width, height = (torch.broadcast_to(torch.as_tensor(x, dtype=obs.dtype, device=obs.device),
                                            (G,)) for x in (width, height))
        H = samp_idx.shape[0]
        Hp = pad_to_multiple(H, mesh.size)
        pad = Hp - H
        samp_p = torch.cat([samp_idx, samp_idx[:1].expand(pad, -1)]) if pad else samp_idx
        q0_p = torch.cat([q0, q0[:1].expand(pad, -1)]) if pad else q0
        sl = mesh.shard(Hp)
        _, scores, n_con, sol1, sol2 = tk.score_hypothesis(obs, valid, width, height, cfg,
                                                          samp_idx=samp_p[sl], q0=q0_p[sl])
        scores, n_con, sol1, sol2 = (mesh.all_gather(x) for x in (scores, n_con, sol1, sol2))
        real = torch.arange(Hp, device=obs.device) < H
        scores = torch.where(real, scores, torch.full_like(scores, -torch.inf))
        return tk.select_model(obs, valid, scores, n_con, sol1, sol2, samp_idx.shape[1],
                               q0_fallback)

    return run
