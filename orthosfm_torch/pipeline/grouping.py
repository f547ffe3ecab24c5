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
and tiny next to the device work it schedules. schedule() then turns the
groups into the run's one index space, the track columns, on the device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List

import numpy as np
import torch

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


@dataclasses.dataclass
class GroupSchedule:
    """A run's groups in track columns, the pose driver's one index space
    (the global cameras' rows are the columns too). Host fields steer the
    loop, its records and prints; the device fields, views of one table
    copied once a run, are the only indices the loop uses. Lists hold one
    entry a group; ``present`` is as it is once that group is merged."""

    groups: List[List[int]]  # view ids
    cols: List[List[int]]  # track columns
    new: List[List[int]]  # positions in the group of the views it places
    present: np.ndarray  # (G, V) bool
    insertion_order: List[int]  # view ids in the order they are placed
    cols_t: torch.Tensor  # (G, S) long
    sizes_t: torch.Tensor  # (2, V) float32 every column's width and height
    wh_t: torch.Tensor  # (G, 2, S) float32 the groups' widths and heights
    view_ids_t: torch.Tensor  # (G, S) int32
    new_t: List[torch.Tensor]  # (2, k): positions and columns of the views it places
    overlap_t: List[torch.Tensor]  # (2, S - k): those of the views placed before it
    present_cols_t: List[torch.Tensor]  # present columns, ascending
    present_t: torch.Tensor  # (G, V) bool


def schedule(groups, view_ids, widths, heights, device) -> GroupSchedule:
    """The GroupSchedule of build_groups' ``groups`` (each of one size).
    view_ids: (V,) host array in track-column order; widths, heights: each
    column's image size, (V,) host arrays or one size for all.
    Present after group g is the union of groups 0..g."""
    col = {int(v): c for c, v in enumerate(view_ids)}
    cols = [[col[int(v)] for v in ids] for ids in groups]
    G, S, V = len(groups), len(cols[0]), len(view_ids)
    present = np.cumsum(np.eye(V, dtype=bool)[cols].any(axis=1), axis=0) > 0
    new = [[j for j in range(S) if g == 0 or not present[g - 1, c[j]]]
           for g, c in enumerate(cols)]
    parts = [np.ravel(cols)]
    for g, c in enumerate(cols):
        old = [j for j in range(S) if j not in new[g]]
        parts += [np.ravel([new[g], [c[j] for j in new[g]]]),
                  np.ravel([old, [c[j] for j in old]]), np.flatnonzero(present[g])]
    # float64 holds every index and every float32 size exactly: one table,
    # one copy to the device
    sizes = np.stack([np.broadcast_to(np.asarray(x, np.float32), (V,)) for x in (widths, heights)])
    host = [np.concatenate(parts), np.ravel(groups), sizes.ravel(), present.ravel()]
    table = torch.split(torch.as_tensor(np.concatenate(host).astype(np.float64), device=device),
                        [len(h) for h in host])
    index = torch.split(table[0].long(), [len(p) for p in parts])
    cols_t, sizes_t = index[0].view(G, S), table[2].float().view(2, V)
    new_t, overlap_t = ([t.view(2, -1) for t in index[1 + k::3]] for k in range(2))
    return GroupSchedule(
        groups=groups, cols=cols,
        new=new, present=present,
        insertion_order=[int(groups[g][j]) for g in range(G) for j in new[g]],
        cols_t=cols_t, sizes_t=sizes_t, wh_t=sizes_t[:, cols_t].transpose(0, 1).contiguous(),
        view_ids_t=table[1].int().view(G, S), new_t=new_t, overlap_t=overlap_t,
        present_cols_t=list(index[3::3]), present_t=table[3].bool().view(G, V))
