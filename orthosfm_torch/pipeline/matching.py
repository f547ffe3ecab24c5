"""Feature matching orchestration: views → SIFT + SURF features → exhaustive
pairwise matching with geometric verification → tracks. Port of
orthosfm_tpu/pipeline/matching.py.

The counterpart of the reference's calculateTracksUsingMVE
(src/matching/matching_mve.cpp:247-473): images go straight through SIFT and
SURF on the device, pairs are matched in batches through the top-2 kernel
(ops.matching_kernels), verified by pair-batched RANSAC-F (or RANSAC-H, the
CudaSift-style engine), and tracks come from a host union-find. Gates and
thresholds follow the reference's bundler
configuration (matching_mve.cpp:393-417): low-res pre-gate (500 features,
≥ 5 matches) when |f1|·|f2| > 1e6, Lowe ratio 0.8 (SURF 0.7),
≥ max(8, 50) consistent matches, RANSAC-F 1000 iterations at 0.0015,
≥ max(8, 30) inliers.

Held host state stays numpy, as in the JAX package: coordinates, scales and
the gates. Descriptors and gray images stay on the device. Every host array
that crosses to the device is cast to f32 or int32 there.

With a mesh (parallel.mesh) the pair axis of every batched pair program,
the matcher and RANSAC-F/H, is split over the ranks
(parallel.matching_sharded); the RANSAC samples are drawn for all pairs
first, so every rank gets the matches of a run on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import numpy as np
import torch

from orthosfm_torch.config import ReconstructionConfig
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.data.views import View
from orthosfm_torch.ops import matching as match_ops
from orthosfm_torch.ops import ransac_f, ransac_h, sift, surf
from orthosfm_torch.parallel import matching_sharded
from orthosfm_torch.pipeline import tracks_build


def _no_timer(name):
    return contextlib.nullcontext()


def checked_device(device) -> torch.device:
    """`device` as a torch.device; CUDA without a CUDA device raises at once
    rather than run on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" to run on the CPU')
    return device


#: RANSAC-F pair chunk: (chunk, iterations, M) Sampson blocks stay ≲ 0.27 GB
RANSAC_BLOCK_ELEMS = 1 << 26
#: RANSAC-H pair chunk: (chunk, iterations, M) transfer-error blocks stay
#: ≲ 0.5 GB, the JAX package's rule
RANSAC_H_BLOCK_ELEMS = 1 << 27


@dataclasses.dataclass
class ViewFeatures:
    """Combined per-view features, ordered [SIFT..., SURF...] like MVE's
    FeatureSet (feature_set.cc). Descriptors stay per type (128-d / 64-d)
    and are matched separately, then combined with index offsets
    (mve/sfm/matching.cc combine_results)."""

    xy: np.ndarray  # (N, 2) pixel coords in the view's image
    norm_xy: np.ndarray  # (N, 2) MVE-normalized coords
    scale: np.ndarray  # (N,)
    sift_desc: torch.Tensor  # (Ns, 128) device
    surf_desc: torch.Tensor  # (Nu, 64) device

    @property
    def count(self) -> int:
        return self.xy.shape[0]

    @property
    def n_sift(self) -> int:
        return self.sift_desc.shape[0]


def _halving_plan(H: int, W: int, max_pixels: int):
    """(halvings, h, w) after MVE-style repeated half-size until ≤ max_pixels
    (reference: bundler_features.cc:66-68)."""
    halvings, h, w = 0, H, W
    while h * w > max_pixels:
        h, w = (h + 1) // 2, (w + 1) // 2
        halvings += 1
    return halvings, h, w


def _prepare_grays(views: List[View], config: ReconstructionConfig, device):
    """Per-view (gray, halvings, h, w), one device program per distinct input
    shape: grayscale as the exact uint channel sum / 765 with one f32
    rounding (MVE DESATURATE_AVERAGE), `halvings` MVE half-size reductions,
    then edge padding to a multiple of 128 (the padded border is part of the
    JAX package's result: its blurs reach the image edge)."""
    by_shape = {}
    for i, v in enumerate(views):
        by_shape.setdefault(tuple(v.pixels.shape), []).append(i)
    prepared = [None] * len(views)
    for shape, idxs in by_shape.items():
        halvings, h, w = _halving_plan(shape[0], shape[1], config.matching.max_image_pixels)
        pad_h, pad_w = -(-h // 128) * 128, -(-w // 128) * 128
        rgb = torch.from_numpy(np.stack([views[i].pixels for i in idxs])).to(device)
        gray = torch.sum(rgb, dim=-1, dtype=torch.int32).to(torch.float32) / (3.0 * 255.0)
        for _ in range(halvings):
            gray = sift.half_size_gaussian(gray)
        gray = sift.edge_pad(sift.edge_pad(gray, 0, pad_h - h, -2), 0, pad_w - w, -1)
        for bi, i in enumerate(idxs):
            prepared[i] = (gray[bi], halvings, h, w)
    return prepared


def _assemble_features(view: View, config: ReconstructionConfig, sift_np, surf_np,
                       halvings, h_orig, w_orig) -> ViewFeatures:
    """Filter/sort/scale one view's raw detector outputs into ViewFeatures.
    sift_np/surf_np: dicts of host (xy, scale, valid) numpy and the device
    "desc" rows of this view; surf_np may be None. Descriptors are selected
    by device row gathers (the host only computes the index lists)."""

    def in_bounds(xy):
        return (xy[:, 0] < w_orig - 0.5) & (xy[:, 1] < h_orig - 0.5)

    v = sift_np["valid"] & in_bounds(sift_np["xy"])
    rows_s = np.flatnonzero(v)
    xy_s = sift_np["xy"][rows_s]
    scale_s = sift_np["scale"][rows_s] * (2.0**halvings)

    if surf_np is not None:
        sv = surf_np["valid"] & in_bounds(surf_np["xy"])
        rows_u = np.flatnonzero(sv)
        xy_u = surf_np["xy"][rows_u]
        scale_u = surf_np["scale"][rows_u] * (2.0**halvings)
    else:
        rows_u = np.zeros((0,), np.int64)
        xy_u = np.zeros((0, 2), np.float32)
        scale_u = np.zeros((0,), np.float32)

    cap = config.matching.max_features_per_view
    if xy_s.shape[0] > cap:
        order = np.argsort(-scale_s)[:cap]
        xy_s, scale_s, rows_s = xy_s[order], scale_s[order], rows_s[order]
    if xy_u.shape[0] > cap:
        order = np.argsort(-scale_u)[:cap]
        xy_u, scale_u, rows_u = xy_u[order], scale_u[order], rows_u[order]

    dev = sift_np["desc"].device
    sift_desc = sift_np["desc"][torch.as_tensor(rows_s, dtype=torch.long, device=dev)]
    surf_desc = (surf_np["desc"][torch.as_tensor(rows_u, dtype=torch.long, device=dev)]
                 if surf_np is not None
                 else torch.zeros((0, 64), dtype=torch.float32, device=dev))

    xy = np.concatenate([xy_s, xy_u])
    scale = np.concatenate([scale_s, scale_u])
    # Map detected coords back to the view image (pixel centers: x' = 2x+0.5)
    for _ in range(halvings):
        xy = 2.0 * xy + 0.5

    w, h = float(view.width), float(view.height)
    maxdim = max(w, h)
    norm_xy = np.stack([(xy[:, 0] + 0.5 - w / 2.0) / maxdim,
                        (xy[:, 1] + 0.5 - h / 2.0) / maxdim], -1)
    return ViewFeatures(xy=xy, norm_xy=norm_xy, scale=scale, sift_desc=sift_desc,
                        surf_desc=surf_desc)


def extract_all_view_features(views: List[View], config: ReconstructionConfig,
                              device="cuda", timer=None) -> List[ViewFeatures]:
    """Batched extraction on `device` (CUDA unless the caller names another;
    see checked_device): views group by (padded shape, halvings) and each
    group's SIFT and SURF run once over the group's view stack.
    timer: optional factory of a context manager per named stage (chip_smoke.py
    times the stages with one)."""
    device = checked_device(device)
    stage = timer or _no_timer
    with stage("prepare_gray"):
        prepared = _prepare_grays(views, config, device)
    groups = {}
    for i, (gray, halvings, _, _) in enumerate(prepared):
        groups.setdefault((tuple(gray.shape), halvings), []).append(i)

    out: List[ViewFeatures] = [None] * len(views)  # type: ignore[list-item]
    for (_, halvings), idxs in groups.items():
        stack = torch.stack([prepared[i][0] for i in idxs])
        with stage("sift"):
            fs = sift.extract_batch(stack, min_octave=config.matching.sift_min_octave)._asdict()
        fu = None
        if config.matching.use_surf:
            with stage("surf"):
                fu = surf.extract_batch(stack)._asdict()
        for bi, i in enumerate(idxs):
            s_i = {k: a[bi] for k, a in fs.items()}
            u_i = {k: a[bi] for k, a in fu.items()} if fu is not None else None
            out[i] = _assemble_features(views[i], config, s_i, u_i, halvings,
                                        prepared[i][2], prepared[i][3])
    return out


def _stack_descriptors(descs, cap: int):
    """(V, cap, D) stacked, zero-padded device descriptors and (V,) host
    counts."""
    counts = np.array([min(d.shape[0], cap) for d in descs], np.int32)
    stack = torch.zeros((len(descs), cap, descs[0].shape[1]), dtype=torch.float32,
                        device=descs[0].device)
    for v, (d, c) in enumerate(zip(descs, counts)):
        stack[v, :c] = d[:c]
    return stack, counts


def _batched_pair_matches(stack, counts, pairs, ratio, mesh=None):
    """match_pairs_batched over `pairs` of the (V, N, D) device stack.
    counts: (V,) host valid counts. Returns (P, N) numpy int64 matches (one
    pull). With a mesh each rank matches its share of the pairs."""
    P = len(pairs)
    N = stack.shape[1]
    if P == 0:
        return np.zeros((0, N), np.int64)
    bi = np.array([p[0] for p in pairs])
    bj = np.array([p[1] for p in pairs])
    args = [torch.as_tensor(np.asarray(a, np.int32), device=stack.device)
            for a in (bi, bj, counts[bi], counts[bj])]
    m12 = matching_sharded.run_over_pairs(
        mesh, lambda *pair_args: match_ops.match_pairs_batched(stack, *pair_args,
                                                               lowe_ratio=float(ratio)), *args)
    return match_ops.check_pulled(m12.cpu().numpy())


def match_all_pairs(features: List[ViewFeatures], config: ReconstructionConfig,
                    verbose: bool = True, timer=None, mesh=None):
    """Exhaustive pairwise matching with gates; returns
    [(i, j, idx_i, idx_j), ...] inlier match lists. The top-2 search runs
    through the CUDA kernel for CUDA descriptors. Pairs are verified by
    RANSAC-F, or by RANSAC-H where config.matching.pair_verification is
    "homography". With a mesh the matcher and the verification split their
    pairs over the ranks, and every rank returns the lists of one device."""
    stage = timer or _no_timer
    m = config.matching
    candidates = candidate_pairs(features, config, verbose, timer, mesh=mesh)

    # --- Geometric verification: pair-batched RANSAC-F, or RANSAC-H (the
    # CudaSift-style engine, reference: matching.cpp:172-199)
    results = []
    if candidates:
        device = features[0].sift_desc.device
        homography = m.pair_verification == "homography"
        with stage("ransac_h" if homography else "ransac_f"):
            verify = _verify_homography if homography else _verify_fundamental
            inl_counts, inliers = verify(candidates, features, config, device, mesh=mesh)
        min_required = (m.homography_min_inliers if homography
                        else max(m.min_pair_inliers_to_accept, m.min_matching_inliers))
        for (i, j, idx_i, idx_j), n_inl, inl in zip(candidates, inl_counts, inliers):
            if n_inl < min_required:
                if verbose:
                    print(f"Pair ({i},{j}) rejected, {n_inl} inliers below "
                          f"threshold {min_required}.")
                continue
            inl = inl[:len(idx_i)]
            results.append((i, j, idx_i[inl], idx_j[inl]))
            if verbose:
                print(f"Pair ({i},{j}) matched, {n_inl} inliers.")
    if verbose:
        print(f"Found a total of {len(results)} matching image pairs.")
    return results


def candidate_pairs(features: List[ViewFeatures], config: ReconstructionConfig,
                    verbose: bool = True, timer=None, mesh=None):
    """The pairs that pass the low-res gate and the match-count gate, with
    their combined SIFT + SURF matches, before geometric verification:
    [(i, j, idx_i, idx_j), ...]."""
    stage = timer or _no_timer
    m = config.matching
    if m.matcher not in ("cascade_hashing", "exhaustive"):
        raise ValueError(f"unknown matcher {m.matcher!r} "
                         "(expected 'cascade_hashing' or 'exhaustive')")
    # Both engines run the exact matcher (MatchingConfig.matcher)
    n_views = len(features)
    all_pairs = [(i, j) for i in range(n_views) for j in range(i + 1, n_views)
                 if features[i].count and features[j].count]
    if not all_pairs:
        return []
    device = features[0].sift_desc.device

    # --- Low-res matchability gate (two_view_matching,
    # bundler_matching.cc:146-158; exhaustive_matching.cc:147-176): on lowres
    # SIFT when the FIRST view has SIFT features, otherwise on lowres SURF;
    # each view contributes min(lowres_feature_count, its count) features.
    gated = [(i, j) for (i, j) in all_pairs
             if features[i].count * features[j].count > 1_000_000]
    passed = {p: True for p in all_pairs}
    gated_by_type = {
        "sift": [p for p in gated if features[p[0]].n_sift],
        "surf": [p for p in gated
                 if not features[p[0]].n_sift and features[p[0]].count - features[p[0]].n_sift],
    }
    for kind, gpairs in gated_by_type.items():
        if not gpairs:
            continue
        with stage("lowres_gate"):
            if kind == "sift":
                per_view = [(f.scale[:f.n_sift], f.sift_desc) for f in features]
                ratio = m.lowe_ratio
            else:
                per_view = [(f.scale[f.n_sift:], f.surf_desc) for f in features]
                ratio = m.surf_lowe_ratio
            nlow_cap = min(m.lowres_feature_count, max(max(s.shape[0] for s, _ in per_view), 1))
            low_descs = [desc[torch.as_tensor(np.argsort(-scale)[:nlow_cap], dtype=torch.long,
                                              device=device)]
                         for scale, desc in per_view]
            low_stack, low_counts = _stack_descriptors(low_descs, nlow_cap)
            m_low = _batched_pair_matches(low_stack, low_counts, gpairs, ratio, mesh)
        for p, row in zip(gpairs, m_low):
            if int((row >= 0).sum()) < m.lowres_match_threshold:
                passed[p] = False
                if verbose:
                    print(f"Pair ({p[0]},{p[1]}) rejected, low-res matches "
                          f"below {m.lowres_match_threshold}.")
    pairs = [p for p in all_pairs if passed[p]]

    # --- Full SIFT + SURF matching, batched per descriptor type
    with stage("full_sift"):
        ns_cap = max(1, max(f.n_sift for f in features))
        sift_stack, sift_counts = _stack_descriptors([f.sift_desc for f in features], ns_cap)
        m_sift = _batched_pair_matches(sift_stack, sift_counts, pairs, m.lowe_ratio, mesh)
    with stage("full_surf"):
        nu_max = max(f.surf_desc.shape[0] for f in features)
        if nu_max > 0:
            surf_stack, surf_counts = _stack_descriptors([f.surf_desc for f in features], nu_max)
            m_surf = _batched_pair_matches(surf_stack, surf_counts, pairs, m.surf_lowe_ratio,
                                           mesh)
        else:
            m_surf = np.zeros((len(pairs), 0), np.int64)

    # --- Combine per-type match lists and apply the match-count gate
    candidates = []  # (i, j, idx_i, idx_j)
    for pi, (i, j) in enumerate(pairs):
        fi, fj = features[i], features[j]
        # Combine the per-type match lists with index offsets
        # (mve/sfm/matching.cc combine_results)
        m12 = np.full(fi.count, -1, np.int64)
        row = m_sift[pi, :fi.n_sift]
        hit = row >= 0
        m12[:fi.n_sift][hit] = row[hit]
        n_surf_i = fi.count - fi.n_sift
        if n_surf_i and m_surf.shape[1]:
            row = m_surf[pi, :n_surf_i]
            hit = row >= 0
            m12[fi.n_sift:][hit] = row[hit] + fj.n_sift

        n_match = int((m12 >= 0).sum())
        if n_match < max(8, m.min_feature_matches):
            if verbose:
                print(f"Pair ({i},{j}) rejected, {n_match} matches below "
                      f"threshold {max(8, m.min_feature_matches)}.")
            continue
        idx_i = np.flatnonzero(m12 >= 0)
        candidates.append((i, j, idx_i, m12[idx_i]))
    return candidates


def _candidate_arrays(candidates, features, coords):
    """(p1, p2 (P, M, 2), valid (P, M)) host arrays of the candidates'
    correspondences in the features' `coords` ("xy" pixels or "norm_xy"),
    each pair's valid prefix first."""
    M = max(len(c[2]) for c in candidates)
    P = len(candidates)
    p1 = np.zeros((P, M, 2), np.float32)
    p2 = np.zeros((P, M, 2), np.float32)
    valid = np.zeros((P, M), bool)
    for pi, (i, j, idx_i, idx_j) in enumerate(candidates):
        p1[pi, :len(idx_i)] = getattr(features[i], coords)[idx_i]
        p2[pi, :len(idx_i)] = getattr(features[j], coords)[idx_j]
        valid[pi, :len(idx_i)] = True
    return p1, p2, valid


def _verify_homography(candidates, features, config, device, mesh=None):
    """RANSAC-H over every candidate pair in pixel coordinates, in pair chunks
    whose (chunk, iterations, M) transfer-error blocks stay ≲ 0.5 GB (a
    rank's share of a chunk, with a mesh). The samples are drawn on the
    device from one generator seeded with config.seed + 7919, over all
    candidates at once. Returns host (num_inliers (P,), inliers (P, M))."""
    m = config.matching
    p1, p2, valid = _candidate_arrays(candidates, features, "xy")
    P, M = valid.shape
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed + 7919)
    counts = torch.as_tensor([len(c[2]) for c in candidates], device=device)
    samples = ransac_h.draw_samples(counts, m.homography_iterations, gen)
    p1, p2, valid = (torch.as_tensor(a, device=device) for a in (p1, p2, valid))
    chunk = _ranks(mesh) * max(1, RANSAC_H_BLOCK_ELEMS // max(m.homography_iterations * M, 1))
    nums, inls = [], []
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        res = matching_sharded.run_over_pairs(
            mesh, lambda *a: ransac_h.find_homography_batched_keys(
                *a, threshold_px=m.homography_threshold_px,
                find_threshold_px=m.homography_find_threshold_px),
            p1[sl], p2[sl], valid[sl], samples[sl])
        nums.append(res.num_inliers)
        inls.append(res.inliers)
    return torch.cat(nums).cpu().numpy(), torch.cat(inls).cpu().numpy()


def _ranks(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _verify_fundamental(candidates, features, config, device, mesh=None):
    """RANSAC-F over every candidate pair, in pair chunks (a rank's share
    of a chunk, with a mesh). The samples are drawn on the device from one
    generator seeded with config.seed + 7919, over all candidates at once,
    so they do not depend on the chunking or the ranks. Returns host
    (num_inliers (P,), inliers (P, M))."""
    m = config.matching
    p1, p2, valid = _candidate_arrays(candidates, features, "norm_xy")
    P, M = valid.shape
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed + 7919)
    counts = torch.as_tensor([len(c[2]) for c in candidates], device=device)
    samples = ransac_f.draw_samples(counts, m.ransac_f_iterations, gen)
    p1, p2, valid = (torch.as_tensor(a, device=device) for a in (p1, p2, valid))
    chunk = _ranks(mesh) * max(1, RANSAC_BLOCK_ELEMS // max(m.ransac_f_iterations * M, 1))
    nums, inls = [], []
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        res = matching_sharded.run_over_pairs(
            mesh, lambda *a: ransac_f.ransac_fundamental_batched(
                *a, threshold=m.ransac_f_threshold),
            p1[sl], p2[sl], valid[sl], samples[sl])
        nums.append(res.num_inliers)
        inls.append(res.inliers)
    return torch.cat(nums).cpu().numpy(), torch.cat(inls).cpu().numpy()


def build_tracks(views: List[View], config: ReconstructionConfig, verbose: bool = True,
                 device="cuda", mesh=None) -> tracks_mod.TrackSet:
    """Full matching stage: SIFT + SURF → pairwise matching → union-find
    tracks, on `device` (CUDA unless the caller names another). With a mesh
    (its rank's device) the pairwise matching and its verification split
    their pairs over the ranks."""
    features = extract_all_view_features(views, config, device)
    if verbose:
        for v, f in zip(views, features):
            print(f"[View {v.view_id:04d}] {f.count} features "
                  f"({f.n_sift} SIFT + {f.count - f.n_sift} SURF)")
    pair_matches = match_all_pairs(features, config, verbose=verbose, mesh=mesh)
    return tracks_from_matches(views, features, pair_matches, device=device)


def tracks_from_matches(views: List[View], features: List[ViewFeatures], pair_matches,
                        device="cuda", timer=None) -> tracks_mod.TrackSet:
    """Union-find + TrackSet assembly from verified pairwise matches, on
    `device` (CUDA unless the caller names another): the TrackSet
    tracks_mod.from_feature_lists gives for the JAX package's feature lists
    (view id, feature, global id vi·2²⁰ + fi, x, y, color 0)."""
    device = checked_device(device)
    stage = timer or _no_timer
    with stage("union_find"):
        track, vi, fi = tracks_build.track_members(pair_matches,
                                                   [f.count for f in features])
        n_tracks = int(track[-1]) + 1 if len(track) else 0
        cap = max(n_tracks, 1)
        V = len(views)
        xy_all = (np.concatenate([f.xy for f in features]).astype(np.float32)
                  if V else np.zeros((0, 2), np.float32))
        offsets = np.concatenate([[0], np.cumsum([f.count for f in features])]).astype(np.int64)
        obs = np.zeros((cap, V, 2), np.float32)
        obs_mask = np.zeros((cap, V), bool)
        local_ids = np.full((cap, V), -1, np.int32)
        global_ids = np.full((cap, V), -1, np.int32)
        obs[track, vi] = xy_all[offsets[vi] + fi]
        obs_mask[track, vi] = True
        local_ids[track, vi] = fi
        global_ids[track, vi] = vi * (1 << 20) + fi
        alive = np.arange(cap) < n_tracks
        view_ids = np.asarray([v.view_id for v in views], np.int32)
        return tracks_mod.from_host(obs, obs_mask, np.zeros((cap, V, 3), np.uint8), local_ids,
                                    global_ids, np.zeros((cap, 4)), np.zeros((cap,)), alive,
                                    view_ids, device=device)
