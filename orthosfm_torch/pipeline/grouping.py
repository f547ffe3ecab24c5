"""Greedy next-best-view group construction (host-side).

Replaces the reference's combinatorial loops (src/data_structures/group.cpp:
13-212) with vectorized NumPy scoring over the track-view incidence matrix.
For the reference's groupSize=3 every group after the first is the best
(used seed pair, remaining view) by S3[a,b,c] = #tracks covering views
{a,b,c}. Tracks collapse to their distinct support patterns first (one
packed key a track), so the scoring scales with patterns, not tracks; each
remaining view keeps a running maximum over the used seed pairs, updated by
one slab of S3 per newly used view, so a selection is an argmax over the
remaining views — the reference's O(C(used,2)·remaining·tracks) re-scan per
group (group.cpp:42-83, omp-parallel at group.cpp:118) disappears entirely.
Control flow stays on the host — group construction is inherently sequential
and tiny next to the device work it schedules.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

from orthosfm_torch.utils import profiling


def complete_group(seed_ids, incidence, view_ids, remaining, group_size):
    """Greedily extend seed_ids to group_size by adding, at each step, the
    remaining view sharing the most full-size tracks with the current group
    (reference: group.cpp:90-155). Returns (ids, shared_track_count).

    Generic-group-size path (the groupSize=3 schedule below never calls
    this)."""
    col = {int(v): i for i, v in enumerate(view_ids)}
    ids = list(seed_ids)
    added_tracks = 0
    while len(ids) < group_size:
        group_cols = [col[i] for i in ids]
        base = incidence[:, group_cols].all(axis=1)  # tracks covering the group
        best_id, best_score = None, -1
        for cand in sorted(remaining):
            if cand in ids:
                continue
            score = int(np.sum(base & incidence[:, col[cand]]))
            if score > best_score:
                best_id, best_score = cand, score
        if best_id is None:  # nothing left to add
            break
        ids.append(best_id)
        added_tracks = best_score
    return ids, added_tracks


def _support_patterns(incidence):
    """The distinct support patterns of the tracks, (P, V) bool, and how
    many tracks have each, (P,) int64.

    Each row packs to bytes (np.packbits; the zero padding past V is the
    same for every row) and np.unique sorts one fixed-width key a row, not
    rows of bools. The patterns come in the keys' order: the slabs below
    are sums of integer counts below 2**24, exact in float32 in any
    order."""
    Mb = np.asarray(incidence, bool)
    assert Mb.shape[0] < 2 ** 24, "track counts must stay exact in float32"
    packed = np.packbits(Mb, axis=1)
    keys = packed.view(np.dtype((np.void, packed.shape[1]))).ravel()
    _, first, counts = np.unique(keys, return_index=True, return_counts=True)
    return Mb[first], counts


def _build_groups3(view_ids, patterns, counts) -> List[List[int]]:
    """groupSize=3 schedule: after the seed group, each group is the used
    seed pair (a, b), a < b, and the remaining view c sharing the most
    tracks, S3[a, b, c]; ties go to the lex-smallest ((a, b), c), the
    reference's scan order (group.cpp:42-83). Each candidate keeps a
    running maximum over the used pairs and the smallest pair attaining
    it; every newly used view n folds in its (used, remaining) slab of
    S3[n] in one (U, P)·(P, R) product: O(P·V³) work, O(V²) memory."""
    ids = sorted(view_ids)
    V = len(ids)
    # columns in id order, so an index compares as its view id does
    order = np.argsort(view_ids, kind="stable")
    Mp = patterns[:, order].astype(np.float32)
    MpW = Mp * counts.astype(np.float32)[:, None]

    def slab(n, rows, cols):
        """S3[n, rows, cols] (len(rows), len(cols)), int64."""
        return np.rint((Mp[:, rows] * Mp[:, n:n + 1]).T @ MpW[:, cols]).astype(np.int64)

    # First group: seed {view 0, view 1}, best third by shared-track count
    # (ties resolve to the lowest id, like the reference's strict-> scan)
    s0, s1 = ids.index(view_ids[0]), ids.index(view_ids[1])
    remaining = np.ones(V, bool)
    remaining[[s0, s1]] = False
    cand = np.flatnonzero(remaining)
    third = int(cand[np.argmax(slab(s0, [s1], cand)[0])])
    first = [s0, s1, third]
    remaining[third] = False

    # per candidate: best score over the used pairs so far, and the
    # smallest pair a * V + b attaining it
    best = np.full(V, -1, np.int64)
    best_pair = np.zeros(V, np.int64)
    used: List[int] = []

    def fold_in(n):
        """Use view n: score the pairs (u, n), u used before it, against
        every remaining candidate."""
        cand = np.flatnonzero(remaining)
        if used and cand.size:
            u = np.array(used)
            sub = slab(n, u, cand)  # (U, R)
            pair = np.minimum(u, n) * V + np.maximum(u, n)
            top = sub.max(axis=0)
            at = np.where(sub == top, pair[:, None], V * V).min(axis=0)
            take = (top > best[cand]) | ((top == best[cand]) & (at < best_pair[cand]))
            best[cand[take]], best_pair[cand[take]] = top[take], at[take]
        used.append(n)

    for n in first:
        fold_in(n)
    groups = [[ids[c] for c in first]]
    while remaining.any():
        cand = np.flatnonzero(remaining)
        score = best[cand]
        top = score.max()
        # the smallest (pair, candidate) among the maxima
        c = int(cand[np.argmin(np.where(score == top, best_pair[cand] * V + cand, V ** 3))])
        a, b = divmod(int(best_pair[c]), V)
        if top == 0:
            _warn_disconnected()
        groups.append([ids[a], ids[b], ids[c]])
        remaining[c] = False
        fold_in(c)
    return groups


def _warn_disconnected():
    import warnings

    warnings.warn(
        "A view did not contain any matches to any other views; "
        "the reconstruction may not succeed."
    )


def build_groups(view_ids, incidence, group_size: int = 3) -> List[List[int]]:
    """Ordered group schedule, always seeded with views 0 and 1
    (reference: group.cpp:13-88). Records its sizes in the active
    collector's trace (utils.profiling.record_grouping).

    view_ids: (V,) ids in track-tensor column order.
    incidence: (T, V) bool — track t observed in view column v.
    """
    view_ids = [int(v) for v in view_ids]
    if len(view_ids) < group_size:
        raise ValueError(f"need at least {group_size} views, got {len(view_ids)}")
    incidence = np.asarray(incidence, bool)
    if group_size == 3:
        patterns, counts = _support_patterns(incidence)
        groups = _build_groups3(view_ids, patterns, counts)
        n_patterns = len(counts)
    else:
        groups = _build_groups_generic(view_ids, incidence, group_size)
        n_patterns = None
    profiling.record_grouping(*incidence.shape, n_patterns, len(groups))
    return groups


def _build_groups_generic(view_ids, incidence, group_size: int) -> List[List[int]]:
    """Reference-faithful loop for group sizes ≠ 3."""
    to_assign = set(view_ids[2:])
    used: set = set()
    groups: List[List[int]] = []

    ids, n = complete_group(view_ids[:2], incidence, view_ids, to_assign, group_size)
    groups.append(ids)
    for i in ids:
        to_assign.discard(i)
        used.add(i)

    while to_assign:
        best_ids, best_score = None, -1
        # All (group_size-1)-combinations of used cameras as seeds
        for seed in itertools.combinations(sorted(used), group_size - 1):
            ids, score = complete_group(list(seed), incidence, view_ids, to_assign, group_size)
            if score > best_score:
                best_ids, best_score = ids, score
        if best_score == 0:
            _warn_disconnected()
        groups.append(best_ids)
        for i in best_ids:
            to_assign.discard(i)
            used.add(i)
    return groups
