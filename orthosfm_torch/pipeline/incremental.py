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
from typing import List, Optional

import numpy as np
import torch

from orthosfm_torch.config import ReconstructionConfig, SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.core import umeyama
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.ops import outliers, triangulate
from orthosfm_torch.pipeline import grouping
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import tomasi_kanade as tk


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

    def tk_run(self, obs, valid, widths, heights, cfg, generator):
        if not self.active:
            return tk.robust_factorization(obs, valid, widths, heights, cfg, generator=generator)
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


def _cols_for(tracks: tracks_mod.TrackSet, ids):
    return tracks_mod.columns_for_view_ids(tracks, ids)


def _make_group_cameras(model, ids, widths, heights, solver) -> cam_mod.CameraSet:
    return cam_mod.from_basis(model, np.asarray(ids, np.int32),
                              np.asarray(widths, np.float32),
                              np.asarray(heights, np.float32), solver)


def _global_direction(global_cams: cam_mod.CameraSet, i0, i1):
    """normalize(origin₁) − normalize(origin₀) after rotating the scene so
    camera i0 has identity basis (reference: tomasi_kanade.cpp:411-419)."""
    R = cam_mod.basis(global_cams)
    o = R @ R.new_tensor([0.0, 0.0, -cam_mod.CAMERA_DISTANCE])
    o_rot = torch.einsum("ij,vi->vj", R[i0], o)  # R0ᵀ · o
    on = o_rot / torch.clamp(torch.linalg.vector_norm(o_rot, dim=-1, keepdim=True), min=1e-12)
    return on[i1] - on[i0]


def align_to_global(local: cam_mod.CameraSet, global_cams: cam_mod.CameraSet,
                    overlap_local_idx, overlap_global_idx) -> cam_mod.CameraSet:
    """Transform the local group into the global frame.

    Quaternion path: slerp(0.5) of the two local→global relative rotations,
    falling back to the second when the first is ≈ identity (reference:
    OrthoQuaternionRecoAlgorithm.cpp:72-118). Euler path: Umeyama over
    origin+axes correspondences of every overlapping camera (reference:
    OrthographicReconstructionAlgorithm.cpp:101-142).
    """
    li = torch.as_tensor(list(overlap_local_idx), dtype=torch.long, device=local.device)
    gi = torch.as_tensor(list(overlap_global_idx), dtype=torch.long, device=local.device)
    if local.kind == "quat":
        trans = quat.from_to_rotation(quat.normalize(local.rot[li]),
                                      quat.normalize(global_cams.rot[gi]))
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


def group_full_size_counts(tracks: tracks_mod.TrackSet, groups, col_of):
    """Per-group count of full-size tracks, fetched in ONE host readback;
    they only change when the global filters mutate obs_mask/alive."""
    cols = torch.as_tensor(np.asarray([[col_of[v] for v in ids] for ids in groups]),
                           dtype=torch.long, device=tracks.device)  # (G, S)
    m = tracks.alive[:, None] & torch.all(tracks.obs_mask[:, cols], dim=2)  # (T, G)
    return torch.sum(m, dim=0).cpu().numpy()


def initial_alignment(tracks: tracks_mod.TrackSet, ids, widths, heights,
                      solver: SolverType, generator: torch.Generator,
                      global_cams: Optional[cam_mod.CameraSet], global_idx_pair,
                      config: ReconstructionConfig,
                      fallback_tracks: Optional[tracks_mod.TrackSet] = None,
                      verbose: bool = False, n_valid: Optional[int] = None,
                      n_valid_fb: Optional[int] = None,
                      runners: Optional[MeshRunners] = None) -> cam_mod.CameraSet:
    """calculateInitialAlignment analog (reference:
    OrthoQuaternionRecoAlgorithm.cpp:23-50 / Orthographic...cpp:36-63).

    ``fallback_tracks`` (normally the pristine pre-filter track set) is used
    when the filtered set has too few full-size tracks for the group: under
    heavy noise the global 1.5 px reprojection filter can strip every feature
    of the placed cameras, where the reference hard-throws
    (tomasi_kanade.cpp:202-205). Falling back is safe for initialization only,
    because the RANSAC around Tomasi-Kanade provides its own robustness. With
    config.strict_reference_behavior the fallback is disabled."""
    cols = _cols_for(tracks, ids)
    ct = tracks_mod.col_index(tracks, cols)
    obs = tracks.obs[:, ct, :]
    valid = tracks_mod.full_size_mask(tracks, cols)
    if n_valid is None:
        n_valid = int(torch.sum(valid))
    min_tracks = max(10, config.ransac.sample_size)
    if config.strict_reference_behavior:
        fallback_tracks = None
    if n_valid < min_tracks and fallback_tracks is not None:
        cols_fb = _cols_for(fallback_tracks, ids)
        valid_fb = tracks_mod.full_size_mask(fallback_tracks, cols_fb)
        if n_valid_fb is None:
            n_valid_fb = int(torch.sum(valid_fb))
        if n_valid_fb > n_valid:
            if verbose:
                print(f"  group {list(ids)}: only {n_valid} filtered full-size "
                      "tracks; initializing from the unfiltered observations")
            obs = fallback_tracks.obs[:, tracks_mod.col_index(fallback_tracks, cols_fb), :]
            valid = valid_fb
            n_valid = n_valid_fb
    if n_valid < min_tracks:
        raise TooFewTracksError(
            f"group {list(ids)}: only {n_valid} full-size tracks (<{min_tracks})")

    w = torch.as_tensor(np.asarray(widths, np.float32), device=tracks.device)
    h = torch.as_tensor(np.asarray(heights, np.float32), device=tracks.device)
    runners = runners or MeshRunners()
    res = runners.tk_run(obs.contiguous(), valid, w, h, config.ransac, generator)
    if global_cams is None:
        model = res.model1
    else:
        gdir = _global_direction(global_cams, *global_idx_pair)
        model = tk.resolve_ambiguity(res.model1, res.model2, gdir)
    return _make_group_cameras(model, ids, widths, heights, solver)


def _local_ba(local_cams, tracks, cols, config, runners):
    """Local bundle adjustment with retriangulation; only cameras persist
    (reference: reconstruct.cpp:219 + bundle_adjustment.cpp:74-83)."""
    local = tracks.replace(alive=tracks_mod.shared_mask(tracks, cols))
    local = triangulate.triangulate_tracks(local_cams, local, cols)
    ct = tracks_mod.col_index(tracks, cols)
    mask = local.obs_mask[:, ct] & local.alive[:, None] & local.has_point[:, None]
    res = runners.ba_run(local_cams, local.points, local.obs[:, ct], mask, True, config.ba)
    return res.cams, res


def _global_ba(global_cams, present, tracks, config, view_ids_np, runners):
    """Global bundle adjustment over all present cameras; optimizes and writes
    back point positions (reference: reconstruct.cpp:261, 281)."""
    dev = tracks.device
    cols = tracks_mod.col_index(tracks, _cols_for(tracks, view_ids_np[present]))
    present_cols = torch.zeros((tracks.num_views,), dtype=torch.bool, device=dev)
    present_cols[cols] = True
    # Absent cameras are frozen so the full-capacity camera set is solvable
    present_t = torch.as_tensor(present, device=dev)
    cams = global_cams.replace(fixed=global_cams.fixed | ~present_t)
    all_cols = tracks_mod.col_index(tracks, _cols_for(tracks, view_ids_np))
    mask = (tracks.obs_mask[:, all_cols] & present_cols[None, all_cols]
            & tracks.alive[:, None] & tracks.has_point[:, None])
    res = runners.ba_run(cams, tracks.points, tracks.obs[:, all_cols], mask, True, config.ba)
    new_cams = res.cams.replace(fixed=global_cams.fixed)
    # Rescale optimized (unit-norm) points back to w=1 form for export/filters
    pts = res.points
    w_comp = pts[..., 3:4]
    safe = torch.where(torch.abs(w_comp) < 1e-8,
                       torch.where(w_comp < 0, -1e-8, 1e-8).to(w_comp.dtype), w_comp)
    pts = torch.where(tracks.has_point[:, None], pts / safe, tracks.points)
    return new_cams, tracks.replace(points=pts), res


def _set_camera(dst: cam_mod.CameraSet, dst_idx, src: cam_mod.CameraSet,
                src_idx) -> cam_mod.CameraSet:
    out = {}
    for name in ("rot", "offset", "scale", "fixed"):
        t = getattr(dst, name).clone()
        t[dst_idx] = getattr(src, name)[src_idx]
        out[name] = t
    return dst.replace(**out)


def _triangulate_global(global_cams, present, tracks, view_ids_np):
    cols = _cols_for(tracks, view_ids_np[present])
    return triangulate.triangulate_tracks(cam_mod.take(global_cams, cols), tracks, cols,
                                          reset_existing=True)


def run_pose_estimation(tracks: tracks_mod.TrackSet, widths, heights,
                        config: ReconstructionConfig, verbose: bool = True,
                        mesh=None) -> PoseEstimationResult:
    """Full incremental alignment (reference: reconstruct.cpp:174-295), on the
    device of ``tracks``. RANSAC draws come from one torch.Generator on that
    device, seeded with config.seed.

    ``mesh``: optional parallel.mesh.Mesh, the tracks on its rank's device,
    every rank calling with the same inputs. With more than one rank every
    bundle adjustment shards the tracks over the ranks and every TK
    initialization its hypotheses (MeshRunners); the results are every
    rank's."""
    runners = MeshRunners(mesh)
    solver = config.solver
    dev = tracks.device
    view_ids = tracks_mod.host_view_ids(tracks.view_ids)
    V = len(view_ids)
    widths = np.broadcast_to(np.asarray(widths, np.float32), (V,))
    heights = np.broadcast_to(np.asarray(heights, np.float32), (V,))
    generator = torch.Generator(device=dev)
    generator.manual_seed(config.seed)

    # Pristine snapshot for initialization fallback under heavy noise (the
    # global filters below mutate obs_mask/alive; see initial_alignment)
    pristine_tracks = tracks

    inc = tracks_mod.incidence(tracks).cpu().numpy().astype(bool)
    groups = grouping.build_groups(view_ids, inc, config.group_size)
    if verbose:
        print(f"Built {len(groups)} groups: {groups}")

    # Full-capacity global camera set (rows ordered like track columns)
    if solver.is_quaternion:
        global_cams = cam_mod.make_quaternion(view_ids, widths, heights, device=dev)
    else:
        global_cams = cam_mod.make_euler(view_ids, widths, heights, solver=solver, device=dev)
    present = np.zeros(V, bool)
    insertion_order: List[int] = []
    col_of = {int(v): i for i, v in enumerate(view_ids)}

    group_counts = group_full_size_counts(tracks, groups, col_of)
    pristine_counts = None

    for gi, ids in enumerate(groups):
        processed = gi + 1
        if verbose:
            print(f"===== Reconstructing group {ids} ({processed}/{len(groups)}) =====")
        cols = _cols_for(tracks, ids)

        n_valid = int(group_counts[gi])
        min_tracks = max(10, config.ransac.sample_size)
        if n_valid < min_tracks and pristine_counts is None \
                and not config.strict_reference_behavior:
            pristine_counts = group_full_size_counts(pristine_tracks, groups, col_of)
        n_valid_fb = int(pristine_counts[gi]) if pristine_counts is not None else None
        first_group = not present.any()
        pair = None if first_group else (col_of[ids[0]], col_of[ids[1]])
        local_cams = initial_alignment(tracks, ids, widths[cols], heights[cols], solver,
                                       generator, None if first_group else global_cams,
                                       pair, config, fallback_tracks=pristine_tracks,
                                       verbose=verbose, n_valid=n_valid,
                                       n_valid_fb=n_valid_fb, runners=runners)

        # Reprojection outlier filter on the LOCAL track copy (reconstruct.cpp:212)
        local_tracks = outliers.filter_tracks_reprojection_error(
            tracks, local_cams, cols, config.filters)

        if first_group:
            fixed = local_cams.fixed.clone()
            fixed[0] = True
            local_cams = local_cams.replace(fixed=fixed)

        local_cams, ba_res = _local_ba(local_cams, local_tracks, cols, config, runners)
        if verbose:
            print(f"  local BA: cost {float(ba_res.initial_cost):.1f} -> "
                  f"{float(ba_res.cost):.1f} in {int(ba_res.iterations)} iters")
            print("Optimized local alignment:")
            print(cam_mod.format_cameras(local_cams))

        if first_group:
            local_cams = cam_mod.normalize_scene_to_camera(local_cams, 0)
            for j, vid in enumerate(ids):
                c = col_of[vid]
                global_cams = _set_camera(global_cams, c, local_cams, j)
                present[c] = True
                insertion_order.append(vid)
            tracks = _triangulate_global(global_cams, present, tracks, view_ids)
            continue

        overlap_local = [j for j, vid in enumerate(ids) if present[col_of[vid]]]
        overlap_global = [col_of[ids[j]] for j in overlap_local]
        if len(overlap_local) != config.group_size - 1 and verbose:
            print(f"  warning: {len(overlap_local)} overlapping cameras "
                  f"(expected {config.group_size - 1})")
        local_cams = align_to_global(local_cams, global_cams, overlap_local, overlap_global)
        # mergeIntoGlobal: only cameras not yet present are added
        for j, vid in enumerate(ids):
            c = col_of[vid]
            if not present[c]:
                global_cams = _set_camera(global_cams, c, local_cams, j)
                present[c] = True
                insertion_order.append(vid)
        tracks = _triangulate_global(global_cams, present, tracks, view_ids)

        if processed % config.global_ba_interval == 0:
            global_cams, tracks, res = _global_ba(global_cams, present, tracks, config,
                                                  view_ids, runners)
            if verbose:
                print(f"  global BA: cost {float(res.initial_cost):.1f} -> "
                      f"{float(res.cost):.1f} in {int(res.iterations)} iters")
            tracks = outliers.filter_outlier_tracks(tracks, config.filters)
            pres_cols = _cols_for(tracks, view_ids[present])
            tracks = outliers.filter_tracks_reprojection_error(
                tracks, cam_mod.take(global_cams, pres_cols), pres_cols, config.filters)
            # obs_mask/alive changed → refresh the per-group counts
            group_counts = group_full_size_counts(tracks, groups, col_of)

        global_cams = cam_mod.normalize_scene_to_camera(global_cams, col_of[insertion_order[0]])
        if verbose:
            print("Current Cameras:")
            print(cam_mod.format_cameras(global_cams, mask=present))

    # Final global BA + normalize (reconstruct.cpp:281-282)
    global_cams, tracks, res = _global_ba(global_cams, present, tracks, config, view_ids,
                                          runners)
    if verbose:
        print(f"final BA: cost {float(res.initial_cost):.1f} -> {float(res.cost):.1f} "
              f"in {int(res.iterations)} iters")
    global_cams = cam_mod.normalize_scene_to_camera(global_cams, col_of[insertion_order[0]])
    if verbose:
        print("Final Alignment:")
        print(cam_mod.format_cameras(global_cams, mask=present))

    return PoseEstimationResult(cameras=global_cams, present=present,
                                insertion_order=insertion_order, tracks=tracks)
