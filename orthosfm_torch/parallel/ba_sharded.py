"""Distributed bundle adjustment over a mesh: port of
orthosfm_tpu/parallel/ba_sharded.py over torch.distributed.

Tracks (their observations and point blocks) shard over the mesh's ranks;
the cameras are replicated. Each rank assembles its shard's part of the
reduced camera system with K1, one all_reduce sums S, dU and rhs (one flat
buffer), and every rank solves the (small) camera system itself with K3.
K2 in split mode updates the shard's points and sums its cost; a second
all_reduce sums the cost over the shards, and K4 applies the accept rule
to the sum on every rank. The LM control flow is replicated and
deterministic, so the ranks never diverge. On CUDA the loop enqueues with
no host sync, as solvers.ba.run does: the collectives wait on the stream,
not on the host.

Reference mapping: the distributed analog of Ceres SPARSE_SCHUR
(bundle_adjustment.cpp:126-145): points are the eliminated group, cameras
the reduced camera system.
"""

from __future__ import annotations

import torch

from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.kernel_build import resolve_impl
from orthosfm_torch.parallel.mesh import Mesh, pad_to_multiple
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import ba_kernels as bk


def make_sharded_ba(mesh: Mesh, optimize_points: bool = True,
                    config: BundleAdjustConfig = BundleAdjustConfig(), impl=None):
    """Returns run(cams, points4, obs, mask) -> ba.BAResult with the
    semantics of solvers.ba.run, called on every rank with that rank's
    shard of the tracks (shard_track_arrays): points4 (T_r, 4), obs
    (T_r, V, 2), mask (T_r, V), the cameras whole. The result's points are
    every rank's, all-gathered in rank order. `impl` ("kernel" | "torch",
    default config.impl) picks the per-shard stages as ba.run does: with
    no card, the plain versions."""

    def run(cams: cam_mod.CameraSet, points4, obs, mask) -> ba.BAResult:
        route = resolve_impl(config.impl if impl is None else impl, obs.device)
        plain = route == "torch"
        kind = cams.kind
        T = obs.shape[0]
        pT, obsT, maskT = ba.prepare(points4, obs.to(torch.float32), mask)
        free = cam_mod.free_mask(cams).to(torch.float32).contiguous()
        pT2, rot2, camp2 = bk.lm_buffers(pT, cams.rot.to(torch.float32), ba.pack_camp(cams))
        hub = float(config.huber_delta)
        lm_cfg = bk.LMConfig.of(config)
        assemble = bk.normal_eq_schur_ref if plain else bk.schur_assemble
        solve = bk.camera_solve_ref if plain else bk.camera_solve
        update = bk.PointUpdateCost(kind, pT2, obsT, maskT, rot2, camp2, free, hub,
                                    optimize_points, lm_cfg, plain=plain, split=True)
        n = 6 * len(cams)
        system = torch.empty((n * n + 2 * n,), dtype=torch.float32, device=obs.device)

        state = torch.zeros((2, bk.STATE_SIZE), dtype=torch.float32, device=obs.device)
        bk.lm_accept(mesh.all_reduce(update(None, None)), None, state[0], lm_cfg, plain=plain)
        for it in range(config.max_iterations):
            s_in, s_out = state[it % 2], state[(it + 1) % 2]
            assemble(kind, pT2, obsT, maskT, rot2, camp2, free, s_in, hub, optimize_points,
                     out=system)
            mesh.all_reduce(system)
            S, dU, rhs = bk.schur_views(system, n)
            delta = solve(kind, S, dU, rhs, free, s_in, rot2, camp2)
            cost = mesh.all_reduce(update(s_in, None, delta))
            bk.lm_accept(cost, s_in, s_out, lm_cfg, plain=plain)
            if obs.device.type == "cpu" and bool(s_out[bk.DONE] != 0):
                state[config.max_iterations % 2] = s_out
                break
        final = state[config.max_iterations % 2]
        rot, camp, pT = (bk.current(x, final) for x in (rot2, camp2, pT2))
        cams_f = cams.replace(rot=rot, offset=camp[:, 3:5].contiguous(),
                              scale=camp[:, 0].contiguous())
        points = mesh.all_gather(pT.T[:T].contiguous())
        return ba.BAResult(cams=cams_f, points=points, cost=final[bk.COST],
                           initial_cost=final[bk.INIT_COST],
                           iterations=final[bk.ITERS].to(torch.int32))

    return run


def pad_tracks(arrs, n_devices: int):
    """Zero-pads the leading (track) axis of each tensor to a multiple of
    n_devices (a padded track has no observation: mask False). Returns
    (padded tensors, original length)."""
    t = arrs[0].shape[0]
    t_pad = pad_to_multiple(max(t, 1), n_devices)
    out = []
    for a in arrs:
        pad = a.new_zeros((t_pad - t, *a.shape[1:]))
        out.append(torch.cat([a, pad]) if t_pad > t else a)
    return out, t


def shard_track_arrays(mesh: Mesh, arrs):
    """This rank's shard of each padded track-major tensor, on its device."""
    sl = mesh.shard(arrs[0].shape[0])
    return [a[sl].to(mesh.device).contiguous() for a in arrs]
