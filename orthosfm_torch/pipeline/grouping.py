"""Greedy next-best-view group construction (host-side).

Replaces the reference's combinatorial loops (src/data_structures/group.cpp:
13-212) with vectorized NumPy scoring over the track-view incidence matrix.
For the reference's groupSize=3 the whole schedule reduces to ONE
pattern-compressed triple-co-occurrence tensor S3[a,b,c] = #tracks covering
views {a,b,c} (tracks dedupe by support pattern first, so the matmuls scale
with distinct patterns, not tracks); every group selection is then a masked
argmax — the reference's O(C(used,2)·remaining·tracks) re-scan per group
(group.cpp:42-83, omp-parallel at group.cpp:118) disappears entirely.
Control flow stays on the host — group construction is inherently sequential
and tiny next to the device work it schedules.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np


def complete_group(seed_ids, incidence, view_ids, remaining, group_size):
    """Greedily extend seed_ids to group_size by adding, at each step, the
    remaining view sharing the most full-size tracks with the current group
    (reference: group.cpp:90-155). Returns (ids, shared_track_count).

    Generic-group-size path (the vectorized groupSize=3 schedule below never
    calls this)."""
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


def triple_counts(incidence) -> np.ndarray:
    """S3[a,b,c] = number of tracks observed in all of views a, b, c.

    Tracks collapse to unique support patterns with multiplicities first
    (real track sets have few distinct patterns), then one (V, P)·(P, V)
    matmul per leading view builds the tensor: O(P·V³) instead of O(T·V³).
    """
    Mp, MpW = _pattern_matrices(incidence)
    V = Mp.shape[1]
    S3 = np.empty((V, V, V), np.int64)
    for a in range(V):
        S3[a] = np.rint((Mp * Mp[:, a:a + 1]).T @ MpW).astype(np.int64)
    return S3


# Above this view count the dense (V, V, V) int64 tensor (8·V³ bytes —
# 64 MB at V=200) gives way to the O(V²)-memory lazy schedule below.
DENSE_S3_MAX_VIEWS = 200


def _pattern_matrices(incidence):
    """Unique track support patterns Mp (P, V) and count-weighted MpW."""
    Mb = np.ascontiguousarray(np.asarray(incidence, bool))
    pat, counts = np.unique(Mb, axis=0, return_counts=True)
    Mp = pat.astype(np.float32)
    return Mp, Mp * counts.astype(np.float32)[:, None]


def _leading_slab(Mp, MpW, a_col) -> np.ndarray:
    """S3[a] = (V, V) triple-co-occurrence slab for leading view column a."""
    return np.rint((Mp * Mp[:, a_col:a_col + 1]).T @ MpW).astype(np.int64)


def _build_groups_lazy3(view_ids, incidence) -> List[List[int]]:
    """groupSize=3 schedule with O(V²) peak memory: instead of the dense
    (V, V, V) tensor, maintain per-candidate running maxima over used seed
    pairs, folding in one (V, P)·(P, V) slab per newly-used view. Selection
    order (including ties) matches the dense path exactly: each candidate
    keeps the lex-smallest (a, b) seed pair achieving its max, and the
    winner minimizes (pair, candidate) among maxima — the dense argmax's
    first-occurrence rule."""
    Mp, MpW = _pattern_matrices(incidence)
    col = {v: i for i, v in enumerate(view_ids)}

    # First group: seed {view 0, view 1}, best third by shared-track count
    to_assign = sorted(view_ids[2:])
    slab0 = _leading_slab(Mp, MpW, col[view_ids[0]])
    rem_cols = np.array([col[v] for v in to_assign])
    best = int(np.argmax(slab0[col[view_ids[1]], rem_cols]))
    first = [view_ids[0], view_ids[1], to_assign[best]]
    groups = [first]
    used: List[int] = []
    to_assign_set = set(to_assign)

    # best_score[v] / best_pair[v]: best used seed pair for candidate v so far
    best_score: dict = {}
    best_pair: dict = {}

    def fold_in_new_used(n):
        """Add view n to used; score pairs (n, u) for all previously-used u
        against every open candidate via n's slab."""
        if not used or not to_assign_set:
            used.append(n)
            return
        slab = _leading_slab(Mp, MpW, col[n])
        u_cols = np.array([col[u] for u in used])
        cands = sorted(to_assign_set)
        r_cols = np.array([col[v] for v in cands])
        sub = slab[np.ix_(u_cols, r_cols)]  # (U, R)
        # Vectorized per fold: column max per candidate, then resolve the
        # lex-min (a, b) seed-pair tie-break only among rows attaining the
        # max. Pair tie-breaking is order-independent, so this matches the
        # scalar (u × candidate) scan exactly while keeping the Python work
        # O(R) per fold (O(V²) overall) instead of O(U·R).
        pairs = [(min(u, n), max(u, n)) for u in used]
        order = sorted(range(len(used)), key=lambda ui: pairs[ui])
        rank = np.empty(len(used), np.int64)
        rank[order] = np.arange(len(used))
        m = sub.max(axis=0)  # (R,)
        attain_rank = np.where(sub == m[None, :], rank[:, None],
                               len(used)).min(axis=0)  # (R,)
        for ci, c in enumerate(cands):
            s = int(m[ci])
            pair = pairs[order[int(attain_rank[ci])]]
            if s > best_score.get(c, -1) or (
                    s == best_score.get(c, -1) and pair < best_pair[c]):
                best_score[c], best_pair[c] = s, pair
        used.append(n)

    for v in first:
        to_assign_set.discard(v)
        best_score.pop(v, None)
        best_pair.pop(v, None)
        fold_in_new_used(v)

    while to_assign_set:
        # min over (pair, candidate) among max scores = dense argmax order
        top = max(best_score[c] for c in to_assign_set)
        cand = min((best_pair[c], c) for c in to_assign_set
                   if best_score[c] == top)[1]
        a, b = best_pair[cand]
        if top == 0:
            _warn_disconnected()
        groups.append([a, b, cand])
        to_assign_set.discard(cand)
        best_score.pop(cand, None)
        best_pair.pop(cand, None)
        fold_in_new_used(cand)
    return groups


def _warn_disconnected():
    import warnings

    warnings.warn(
        "A view did not contain any matches to any other views; "
        "the reconstruction may not succeed."
    )


def build_groups(view_ids, incidence, group_size: int = 3) -> List[List[int]]:
    """Ordered group schedule, always seeded with views 0 and 1
    (reference: group.cpp:13-88).

    view_ids: (V,) ids in track-tensor column order.
    incidence: (T, V) bool — track t observed in view column v.
    """
    view_ids = [int(v) for v in view_ids]
    if len(view_ids) < group_size:
        raise ValueError(f"need at least {group_size} views, got {len(view_ids)}")
    if group_size != 3:
        return _build_groups_generic(view_ids, incidence, group_size)
    if len(view_ids) > DENSE_S3_MAX_VIEWS:
        return _build_groups_lazy3(view_ids, incidence)

    S3 = triple_counts(incidence)
    col = {v: i for i, v in enumerate(view_ids)}
    to_assign = sorted(view_ids[2:])
    groups: List[List[int]] = []

    # First group: seed {view 0, view 1}, best third by shared-track count
    # (ties resolve to the lowest id, like the reference's strict-> scan)
    c0, c1 = col[view_ids[0]], col[view_ids[1]]
    rem_cols = np.array([col[v] for v in to_assign])
    scores = S3[c0, c1, rem_cols]
    best = int(np.argmax(scores))
    first = [view_ids[0], view_ids[1], to_assign[best]]
    groups.append(first)
    used = sorted(first)
    to_assign = [v for v in to_assign if v not in first]

    while to_assign:
        u_cols = np.array([col[v] for v in used])
        r_cols = np.array([col[v] for v in to_assign])
        sub = S3[np.ix_(u_cols, u_cols, r_cols)]
        # Only a<b seed pairs, matching itertools.combinations(sorted(used))
        a_idx, b_idx = np.triu_indices(len(used), k=1)
        flat = sub[a_idx, b_idx]  # (n_pairs, R) in lexicographic (a, b) order
        best = int(np.argmax(flat))  # first maximum = reference scan order
        pair, cand = divmod(best, flat.shape[1])
        score = int(flat[pair, cand])
        ids = [used[int(a_idx[pair])], used[int(b_idx[pair])], to_assign[cand]]
        if score == 0:
            _warn_disconnected()
        groups.append(ids)
        for v in ids:
            if v in to_assign:
                to_assign.remove(v)
        used = sorted(set(used) | set(ids))
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
