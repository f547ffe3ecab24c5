"""Incremental group-wise pose estimation — the pipeline's algorithmic core.

Port of orthosfm_tpu/pipeline/incremental.py, reproducing runPoseEstimation
(reference: src/sfm/reconstruct.cpp:174-295): greedy group schedule → per
group RANSAC'd Tomasi-Kanade init → reprojection filter → local BA (with
retriangulation) → first group seeds the global scene, later groups
align/merge → every 3rd group a global BA + outlier filters → scene
normalization → final global BA.

The global camera set covers ALL views from the start (absent cameras are
flagged fixed and carry no observations); only the host-side `present` mask
grows. Group control flow stays in Python; every numeric stage runs on the
device of the track tensors. With a mesh of more than one rank
(parallel.mesh), MeshRunners sends every bundle adjustment through
parallel.ba_sharded and every Tomasi-Kanade initialization through
parallel.tk_sharded; the rest runs replicated on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from orthosfm_torch.config import ReconstructionConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.core import umeyama
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.ops import outliers, triangulate
from orthosfm_torch.pipeline import grouping, tk_graphs
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import tomasi_kanade as tk
from orthosfm_torch.utils.profiling import record_tk, stage


class TooFewTracksError(RuntimeError):
    """Raised when a group has <10 full-size tracks
    (reference: tomasi_kanade.cpp:202-205)."""


class MeshRunners:
    """The solvers run_pose_estimation calls, over a mesh (port of the JAX
    package's MeshRunners). With a mesh of more than one rank every bundle
    adjustment shards its tracks (parallel.ba_sharded: K1 per shard, the
    camera system and cost summed over the ranks) and every Tomasi-Kanade
    initialization its hypotheses (parallel.tk_sharded); with no mesh, or
    one of a single rank, the unsharded solvers run. Sharded solvers are
    cached per (optimize_points, config)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.n_devices = mesh.size if mesh is not None else 1
        self.active = self.n_devices > 1
        self.tk_run = self._sharded_tk if self.active else tk.robust_factorization
        self._ba_cache = {}
        self._tk_cache = {}

    def ba_run(self, cams, points4, obs, mask, optimize_points, config):
        if not self.active:
            return ba.run(cams, points4, obs, mask, optimize_points=optimize_points,
                          config=config)
        from orthosfm_torch.parallel import ba_sharded

        key = (bool(optimize_points), config)
        if key not in self._ba_cache:
            self._ba_cache[key] = ba_sharded.make_sharded_ba(
                self.mesh, optimize_points=optimize_points, config=config)
        padded, T = ba_sharded.pad_tracks([points4, obs, mask], self.n_devices)
        res = self._ba_cache[key](cams, *ba_sharded.shard_track_arrays(self.mesh, padded))
        return res._replace(points=res.points[:T])

    def _sharded_tk(self, obs, valid, widths, heights, cfg, generator):
        from orthosfm_torch.parallel import tk_sharded

        if cfg not in self._tk_cache:
            self._tk_cache[cfg] = tk_sharded.make_sharded_tk(self.mesh, cfg=cfg)
        return self._tk_cache[cfg](obs, valid, widths, heights, generator)


@dataclasses.dataclass
class PoseEstimationResult:
    cameras: cam_mod.CameraSet  # V_total rows, only `present` valid
    present: np.ndarray  # (V_total,) bool
    insertion_order: List[int]  # view ids in reconstruction order
    tracks: tracks_mod.TrackSet  # filtered + triangulated global tracks


def _global_direction(R):
    """normalize(origin₁) − normalize(origin₀) of an anchor pair of global
    cameras, R (2, 3, 3) their local→world rotations, after rotating the
    scene so the first has identity basis (reference:
    tomasi_kanade.cpp:411-419)."""
    o = R @ cam_mod.down(R)
    o_rot = torch.einsum("ij,vi->vj", R[0], o)  # R0ᵀ · o
    on = o_rot / torch.clamp(torch.linalg.vector_norm(o_rot, dim=-1, keepdim=True), min=1e-12)
    return on[1] - on[0]


def align_to_global(local: cam_mod.CameraSet, global_cams: cam_mod.CameraSet,
                    li, gi) -> cam_mod.CameraSet:
    """Transform the local group into the global frame; ``li``, ``gi``: the
    overlapping cameras' rows in ``local`` and in ``global_cams``.

    Quaternion path: slerp(0.5) of the first two local→global relative
    rotations, falling back to the second when the first is ≈ identity
    (reference: OrthoQuaternionRecoAlgorithm.cpp:72-118); with a single
    overlapping camera, its relative rotation. Euler path: Umeyama over
    origin+axes correspondences of every overlapping camera (reference:
    OrthographicReconstructionAlgorithm.cpp:101-142).
    """
    if local.kind == "quat":
        trans = quat.from_to_rotation(quat.normalize(local.rot[li]),
                                      quat.normalize(global_cams.rot[gi]))
        if trans.shape[0] == 1:
            return cam_mod.apply_rotation(local, trans[0])
        smoothed = quat.slerp(trans[0], trans[1], 0.5)
        t0 = trans[0]
        dist_identity = torch.sqrt((1.0 - t0[0]) ** 2 + torch.sum(t0[1:] ** 2))
        smoothed = torch.where(dist_identity < 0.05, trans[1], smoothed)
        return cam_mod.apply_rotation(local, smoothed)

    R_l = cam_mod.basis(local)[li]  # (K, 3, 3)
    R_g = cam_mod.basis(global_cams)[gi]
    down = R_l.new_tensor([0.0, 0.0, -cam_mod.CAMERA_DISTANCE])
    src = torch.cat([R_l @ down, R_l[..., :, 0], R_l[..., :, 1], R_l[..., :, 2]], dim=0)
    dst = torch.cat([R_g @ down, R_g[..., :, 0], R_g[..., :, 1], R_g[..., :, 2]], dim=0)
    return cam_mod.apply_rotation(local, umeyama.rotation_align(src, dst))


def group_full_size_counts(tracks: tracks_mod.TrackSet, cols):
    """Per-group count of full-size tracks, fetched in ONE host readback;
    they only change when the global filters mutate obs_mask/alive.
    cols: (G, S) the groups' columns (GroupSchedule.cols_t)."""
    m = tracks.alive[:, None] & torch.all(tracks.obs_mask[:, cols], dim=2)  # (T, G)
    return torch.sum(m, dim=0).cpu().numpy()


def initial_rotations(obs, valid, wh, anchor_rot=None, *, ransac, solver, generator, tk_run):
    """The device work of a group's TK initialization, from the RANSAC draws
    to its cameras' rotation parameters (S, 4) (cameras.basis_rotations):
    ``tk_run`` (robust_factorization, or its sharded form) on the group's
    observations obs (T, S, 2), full-size mask valid (T,) and sizes wh
    (2, S), then, past a run's first group, the mirror solution that agrees
    with ``anchor_rot`` (2, 4), the rotation parameters of the group's anchor
    pair among the global cameras. It reads nothing back to the host, so
    tk_graphs captures it as it stands."""
    res = tk_run(obs, valid, wh[0], wh[1], ransac, generator)
    model = res.model1
    if anchor_rot is not None:
        kind = "quat" if solver.is_quaternion else "euler"
        gdir = _global_direction(cam_mod.rotation_matrices(kind, anchor_rot))
        model = tk.resolve_ambiguity(res.model1, res.model2, gdir)
    return cam_mod.basis_rotations(model, solver)


def _group_inputs(src: tracks_mod.TrackSet, cols, wh, global_rot, first: bool):
    """initial_rotations' inputs for the group of columns ``cols`` (S,) from
    the tracks ``src``: the observations of its columns, its full-size mask,
    its sizes ``wh`` and, past the first group, the rotation parameters in
    ``global_rot`` of its anchor pair (its first two columns)."""
    inputs = (torch.index_select(src.obs, 1, cols), tracks_mod.full_size_mask(src, cols), wh)
    if first:
        return inputs
    return inputs + (torch.index_select(global_rot, 0, cols[:2]),)


def initial_alignment(tracks: tracks_mod.TrackSet, sched: grouping.GroupSchedule, g: int,
                      generator: torch.Generator, global_cams: cam_mod.CameraSet,
                      config: ReconstructionConfig, fallback_tracks: tracks_mod.TrackSet,
                      n_valid: int, n_valid_fb: Optional[int], runners: MeshRunners,
                      verbose: bool = False) -> cam_mod.CameraSet:
    """calculateInitialAlignment analog (reference:
    OrthoQuaternionRecoAlgorithm.cpp:23-50 / Orthographic...cpp:36-63) for
    group ``g`` of ``sched``, which gives its columns (the first two its
    anchor pair, read in ``global_cams`` from the second group on), sizes
    and ids. ``n_valid``, ``n_valid_fb``: its full-size tracks in ``tracks``
    and (None until read) in ``fallback_tracks``.

    ``fallback_tracks`` (normally the pristine pre-filter track set) is used
    when the filtered set has too few full-size tracks for the group: under
    heavy noise the global 1.5 px reprojection filter can strip every feature
    of the placed cameras, where the reference hard-throws
    (tomasi_kanade.cpp:202-205). Falling back is safe for initialization only,
    because the RANSAC around Tomasi-Kanade provides its own robustness. With
    config.strict_reference_behavior the fallback is disabled.

    The device work (initial_rotations) runs through tk_graphs' graph of its
    shape where tk_graphs.GRAPHS.graphed says so (a card, no mesh, the
    device's TK generator), else eagerly; record_tk notes the route."""
    ids, cols = sched.groups[g], sched.cols_t[g]
    min_tracks = max(10, config.ransac.sample_size)
    if config.strict_reference_behavior:
        fallback_tracks = None
    fallback = n_valid < min_tracks and fallback_tracks is not None and n_valid_fb > n_valid
    if fallback:
        if verbose:
            print(f"  group {ids}: only {n_valid} filtered full-size "
                  "tracks; initializing from the unfiltered observations")
        n_valid = n_valid_fb
    src = fallback_tracks if fallback else tracks
    if n_valid < min_tracks:
        raise TooFewTracksError(
            f"group {ids}: only {n_valid} full-size tracks (<{min_tracks})")

    fn = functools.partial(initial_rotations, ransac=config.ransac, solver=config.solver,
                           generator=generator, tk_run=runners.tk_run)
    inputs = _group_inputs(src, cols, sched.wh_t[g], global_cams.rot, g == 0)
    if tk_graphs.GRAPHS.graphed(src.device, runners.active, generator):
        rot, route = tk_graphs.GRAPHS.run(fn, inputs)
    else:
        rot, route = fn(*inputs), "eager"
    record_tk(ids, n_valid, config.ransac, fallback, route)
    w, h = sched.wh_t[g]
    return cam_mod.with_rotations(rot, sched.view_ids_t[g], w, h, config.solver)


def _local_ba(local_cams, tracks, cols, config, runners):
    """Local bundle adjustment with retriangulation; only cameras persist
    (reference: reconstruct.cpp:219 + bundle_adjustment.cpp:74-83)."""
    local = tracks.replace(alive=tracks_mod.shared_mask(tracks, cols))
    local = triangulate.triangulate_tracks(local_cams, local, cols)
    mask = local.obs_mask[:, cols] & local.alive[:, None] & local.has_point[:, None]
    res = runners.ba_run(local_cams, local.points, local.obs[:, cols], mask, True, config.ba)
    return res.cams, res


def _global_ba(global_cams, present, tracks, config, runners):
    """Global bundle adjustment over the cameras of the columns ``present``
    ((V,) bool on the device); optimizes and writes back point positions
    (reference: reconstruct.cpp:261, 281)."""
    # Absent cameras are frozen so the full-capacity camera set is solvable
    cams = global_cams.replace(fixed=global_cams.fixed | ~present)
    mask = (tracks.obs_mask & present[None, :] & tracks.alive[:, None]
            & tracks.has_point[:, None])
    res = runners.ba_run(cams, tracks.points, tracks.obs, mask, True, config.ba)
    new_cams = res.cams.replace(fixed=global_cams.fixed)
    # Rescale optimized (unit-norm) points back to w=1 form for export/filters
    pts = res.points
    w_comp = pts[..., 3:4]
    safe = torch.where(torch.abs(w_comp) < 1e-8,
                       torch.where(w_comp < 0, -1e-8, 1e-8).to(w_comp.dtype), w_comp)
    pts = torch.where(tracks.has_point[:, None], pts / safe, tracks.points)
    return new_cams, tracks.replace(points=pts), res


def _place(global_cams, local_cams, local_idx, cols) -> cam_mod.CameraSet:
    """global_cams with rows ``cols`` taken from local_cams' rows
    ``local_idx``: one indexed copy a camera field (mergeIntoGlobal)."""
    return global_cams.replace(**{
        f: getattr(global_cams, f).index_copy(0, cols, getattr(local_cams, f)[local_idx])
        for f in ("rot", "offset", "scale", "fixed")})


def run_pose_estimation(tracks: tracks_mod.TrackSet, widths, heights,
                        config: ReconstructionConfig, verbose: bool = True,
                        mesh=None) -> PoseEstimationResult:
    """Full incremental alignment (reference: reconstruct.cpp:174-295), on the
    device of ``tracks``. RANSAC draws come from one torch.Generator on that
    device, seeded with config.seed: on a card the device's TK generator,
    which tk_graphs' graphs draw from (so two runs on one card at once would
    share it). The group loop indexes with the run's grouping.GroupSchedule
    alone.

    ``mesh``: optional parallel.mesh.Mesh, the tracks on its rank's device,
    every rank calling with the same inputs. With more than one rank every
    bundle adjustment shards the tracks over the ranks and every TK
    initialization its hypotheses (MeshRunners); the results are every
    rank's. Its stages (utils.profiling.stage): pose/grouping, pose/tk,
    pose/filters, pose/local_ba, pose/merge and pose/global_ba, those of the
    group loop with the group's index, and pose/triangulate inside
    pose/merge, pose/local_ba and pose/filters."""
    runners = MeshRunners(mesh)
    solver = config.solver
    dev = tracks.device
    view_ids = tracks.view_ids.cpu().numpy()
    generator = (tk_graphs.GRAPHS.generator(dev) if dev.type == "cuda"
                 else torch.Generator(device=dev))
    generator.manual_seed(config.seed)

    # Pristine snapshot for initialization fallback under heavy noise (the
    # global filters below mutate obs_mask/alive; see initial_alignment)
    pristine_tracks = tracks

    with stage("pose/grouping"):
        inc = tracks_mod.incidence(tracks).cpu().numpy()
        groups = grouping.build_groups(view_ids, inc, config.group_size)
        sched = grouping.schedule(groups, view_ids, widths, heights, dev)
        group_counts = group_full_size_counts(tracks, sched.cols_t)
    if verbose:
        print(f"Built {len(groups)} groups: {groups}")

    # Full-capacity global camera set (rows ordered like track columns)
    if solver.is_quaternion:
        global_cams = cam_mod.make_quaternion(tracks.view_ids, *sched.sizes_t, device=dev)
    else:
        global_cams = cam_mod.make_euler(tracks.view_ids, *sched.sizes_t, solver=solver,
                                         device=dev)
    root = sched.cols[0][0]  # the column of the first view placed
    pristine_counts = None

    for g, ids in enumerate(sched.groups):
        processed = g + 1
        if verbose:
            print(f"===== Reconstructing group {ids} ({processed}/{len(groups)}) =====")
        cols = sched.cols_t[g]

        n_valid = int(group_counts[g])
        min_tracks = max(10, config.ransac.sample_size)
        if n_valid < min_tracks and pristine_counts is None \
                and not config.strict_reference_behavior:
            pristine_counts = group_full_size_counts(pristine_tracks, sched.cols_t)
        n_valid_fb = int(pristine_counts[g]) if pristine_counts is not None else None
        with stage("pose/tk", group=g):
            local_cams = initial_alignment(tracks, sched, g, generator, global_cams, config,
                                           pristine_tracks, n_valid, n_valid_fb, runners,
                                           verbose)

        # Reprojection outlier filter on the LOCAL track copy (reconstruct.cpp:212)
        with stage("pose/filters", group=g):
            local_tracks = outliers.filter_tracks_reprojection_error(
                tracks, local_cams, cols, config.filters)

        if g == 0:
            fixed = local_cams.fixed.clone()
            fixed[0] = True
            local_cams = local_cams.replace(fixed=fixed)

        with stage("pose/local_ba", group=g):
            local_cams, ba_res = _local_ba(local_cams, local_tracks, cols, config, runners)
        if verbose:
            print(f"  local BA: cost {float(ba_res.initial_cost):.1f} -> "
                  f"{float(ba_res.cost):.1f} in {int(ba_res.iterations)} iters")
            print("Optimized local alignment:")
            print(cam_mod.format_cameras(local_cams))

        n_overlap = sched.overlap_t[g].shape[1]
        if g > 0 and n_overlap != config.group_size - 1 and verbose:
            print(f"  warning: {n_overlap} overlapping cameras "
                  f"(expected {config.group_size - 1})")
        with stage("pose/merge", group=g):
            if g == 0:
                local_cams = cam_mod.normalize_scene_to_camera(local_cams, 0)
            else:
                local_cams = align_to_global(local_cams, global_cams, *sched.overlap_t[g])
            # mergeIntoGlobal: only cameras not yet present are added
            global_cams = _place(global_cams, local_cams, *sched.new_t[g])
            pres_cols = sched.present_cols_t[g]
            tracks = triangulate.triangulate_tracks(cam_mod.take(global_cams, pres_cols), tracks,
                                                    pres_cols, reset_existing=True)
        if g == 0:
            continue

        if processed % config.global_ba_interval == 0:
            with stage("pose/global_ba", group=g):
                global_cams, tracks, res = _global_ba(global_cams, sched.present_t[g], tracks,
                                                      config, runners)
            if verbose:
                print(f"  global BA: cost {float(res.initial_cost):.1f} -> "
                      f"{float(res.cost):.1f} in {int(res.iterations)} iters")
            with stage("pose/filters", group=g):
                tracks = outliers.filter_outlier_tracks(tracks, config.filters)
                tracks = outliers.filter_tracks_reprojection_error(
                    tracks, cam_mod.take(global_cams, pres_cols), pres_cols, config.filters)
                # obs_mask/alive changed → refresh the per-group counts
                group_counts = group_full_size_counts(tracks, sched.cols_t)

        with stage("pose/merge", group=g):
            global_cams = cam_mod.normalize_scene_to_camera(global_cams, root)
        if verbose:
            print("Current Cameras:")
            print(cam_mod.format_cameras(global_cams, mask=sched.present[g]))

    # Final global BA + normalize (reconstruct.cpp:281-282)
    with stage("pose/global_ba"):
        global_cams, tracks, res = _global_ba(global_cams, sched.present_t[-1], tracks, config,
                                              runners)
    if verbose:
        print(f"final BA: cost {float(res.initial_cost):.1f} -> {float(res.cost):.1f} "
              f"in {int(res.iterations)} iters")
    global_cams = cam_mod.normalize_scene_to_camera(global_cams, root)
    if verbose:
        print("Final Alignment:")
        print(cam_mod.format_cameras(global_cams, mask=sched.present[-1]))

    return PoseEstimationResult(cameras=global_cams, present=sched.present[-1].copy(),
                                insertion_order=sched.insertion_order, tracks=tracks)
