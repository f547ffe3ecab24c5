"""The port's two-way top-2 (ops.matching_kernels.top2_ref, the plain
version of the CUDA kernel) against the JAX package's Pallas kernel
(ops/matching_pallas.py::oneway_top2 → top2_similarity) run in interpret
mode on the CPU, in both directions; the pair table's range check; and the
front end's CUDA default.

Tolerances: the Pallas kernel ranks the similarity, the port the clamped
d2 = max(2 − 2·sim, 0), and the two libraries' f32 products sum in
different orders (a few 1e-7). So the best and second d2 agree with
2 − 2·sim, clamped, to 1e-5, and the indices agree except on rows whose
best and second d2 lie within 1e-5 of each other.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)

from orthosfm_tpu.ops import matching_pallas

from orthosfm_torch.config import ReconstructionConfig
from orthosfm_torch.data.views import View
from orthosfm_torch.ops import matching as match_ops
from orthosfm_torch.ops import matching_kernels as mk
from orthosfm_torch.pipeline import matching as pipe

NEAR_TIE = 1e-5
N = 300
# (view i, view j, valid rows of i, valid rows of j): ragged prefixes, a
# repeated view, a view against itself, one valid database row
PAIRS = [(0, 1, 300, 280), (2, 1, 257, 300), (1, 1, 300, 300), (3, 0, 131, 1), (1, 3, 300, 290)]


def _stack(D, seed=0, V=4):
    """Unit descriptors; view 1 holds rows 0..39 twice (exact ties) and view
    2 starts with them."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(V, N, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[1, 150:190] = d[1, :40]
    d[2, :40] = d[1, :40]
    return d


def _pallas_oneway(dA, nA, dB, nB):
    """The Pallas kernel, interpreted: (best d2, second d2, idx) of the
    first nA rows of dA over the first nB rows of dB."""
    vA = np.arange(dA.shape[0]) < nA
    vB = np.arange(dB.shape[0]) < nB
    best, second, idx = matching_pallas.oneway_top2(jnp.asarray(dA), jnp.asarray(vA),
                                                    jnp.asarray(dB), jnp.asarray(vB))
    d2 = lambda s: np.maximum(2.0 - 2.0 * np.asarray(s), 0.0)  # noqa: E731
    return d2(best)[:nA], d2(second)[:nA], np.asarray(idx)[:nA]


@pytest.mark.parametrize("D", [64, 128])
def test_top2_ref_matches_pallas_kernel_both_ways(D, monkeypatch):
    monkeypatch.setattr(jpl, "pallas_call", functools.partial(jpl.pallas_call, interpret=True))
    d = _stack(D)
    cols = [torch.as_tensor(np.array(c, np.int32)) for c in zip(*PAIRS)]
    got = [t.numpy() for t in mk.top2_ref(torch.as_tensor(d), *cols)]
    for p, (i, j, ci, cj) in enumerate(PAIRS):
        for (vq, nq, vb, nb), (best, second, idx) in (((i, ci, j, cj), got[:3]),
                                                      ((j, cj, i, ci), got[3:])):
            rb, rs, ri = _pallas_oneway(d[vq], nq, d[vb], nb)
            np.testing.assert_allclose(best[p, :nq], rb, atol=NEAR_TIE, rtol=0)
            if nb > 1:
                np.testing.assert_allclose(second[p, :nq], rs, atol=NEAR_TIE, rtol=0)
            far = (second[p, :nq] - best[p, :nq]) > NEAR_TIE
            np.testing.assert_array_equal(idx[p, :nq][far], ri[far])
            assert np.all(best[p, nq:] == 4.0) and np.all(idx[p, nq:] == 0)


def test_top2_ref_backward_is_the_swapped_forward():
    d = torch.as_tensor(_stack(64))
    cols = [torch.as_tensor(np.array(c, np.int32)) for c in zip(*PAIRS)]
    out = mk.top2_ref(d, *cols)
    swapped = mk.top2_ref(d, cols[1], cols[0], cols[3], cols[2])
    for a, b in zip(out[3:], swapped[:3]):
        assert torch.equal(a, b)
    # exact ties go to the lower index in both directions: view 1's rows
    # 150..189 repeat rows 0..39
    assert torch.equal(out[2][1, :40], torch.arange(40, dtype=torch.int32))
    assert torch.equal(out[5][2, 150:190], torch.arange(40, dtype=torch.int32))


@pytest.mark.parametrize("bad", [(0, 4, 300, 300), (-1, 1, 300, 300), (0, 1, 301, 300),
                                 (0, 1, 300, -1)])
def test_a_pair_out_of_range_is_marked_and_raises_at_the_pull(bad):
    """Its rows are (NaN, NaN, −1) both ways, the other pairs are untouched,
    match_pairs_batched marks its rows BAD_PAIR and the pipeline's pull
    raises."""
    d = torch.as_tensor(_stack(64))
    pairs = PAIRS[:2] + [bad]
    cols = [torch.as_tensor(np.array(c, np.int32)) for c in zip(*pairs)]
    out = mk.top2_ref(d, *cols)
    good = mk.top2_ref(d, *(c[:2] for c in cols))
    for t, g in zip(out, good):
        assert torch.equal(t[:2], g)
        assert bool(torch.all(t[2] == -1) if not t.is_floating_point() else torch.isnan(t[2]).all())
    m = match_ops.match_pairs_batched(d, *cols)
    assert bool(torch.all(m[2] == match_ops.BAD_PAIR)) and bool(torch.all(m[:2] >= -1))
    with pytest.raises(ValueError, match="out"):
        match_ops.check_pulled(m.numpy())
    with pytest.raises(ValueError, match="out"):
        pipe._batched_pair_matches(d, np.array([N + 1, N, N, N]), [(0, 1)], 0.8)


@pytest.mark.parametrize("call", ["extract_all_view_features", "build_tracks",
                                  "tracks_from_matches"])
def test_front_end_defaults_to_cuda_and_names_the_cpu(call, monkeypatch):
    """Like reconstruct(): CUDA by default, and without a CUDA device a
    RuntimeError that names device="cpu" before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    views = [View(0, "view_00.png", 8, 8, pixels=np.zeros((8, 8, 3), np.uint8))]
    args = {"extract_all_view_features": (views, ReconstructionConfig()),
            "build_tracks": (views, ReconstructionConfig()),
            "tracks_from_matches": (views, [], [])}[call]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(pipe, call)(*args)
