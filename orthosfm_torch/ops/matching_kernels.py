"""Two-way top-2 nearest neighbours of descriptor pairs: the hand-written
CUDA kernel (orthosfm_torch/csrc/match_kernels.cu) and, beside it, its plain
PyTorch version.

  kernel wrapper   plain version   replaces (JAX package)
  top2             top2_ref        ops/matching_pallas.py::top2_similarity,
                                   with a pair axis and both directions (the
                                   batched matcher's two einsum + top_k,
                                   ops/matching.py:106-117)

top2(stack, bi, bj, ci, cj): stack (V, N, D) f32, bi/bj/ci/cj (P,) int32.
For pair p, over the block d2 = max(2 − 2·<stack[bi[p], r], stack[bj[p], c]>, 0)
of query rows r < ci[p] and database rows c < cj[p], computed once:
  forward, per query row r: the smallest d2, the second smallest and the
    column of the smallest (the lower column among equal d2, as
    lax.top_k);
  backward, per database row c: the same over the query rows (the forward
    outputs of the swapped pair (bj, bi, cj, ci)).
An empty side gives (4, 4, 0); rows past a count give (4, 4, 0). A pair
whose views lie outside [0, V) or whose counts lie outside [0, N] is not
read: its rows give (NaN, NaN, −1) in both directions (ops.matching marks
them and the pipeline raises at its pull). Returns (fwd_best, fwd_second,
fwd_idx, bwd_best, bwd_second, bwd_idx), each (P, N), f32 / int32.

A wrapper given CPU tensors calls the plain version; given CUDA tensors it
launches its kernel or raises ("auto"; impl="torch" runs the plain version
on any device). It reads nothing back from the device. It counts its
launches in ``top2.launches``: one a call, unless the pairs' scratch would
pass SCRATCH_BYTES (then one for each slice of pairs). The kernel is built
for D = 64 (SURF) and 128 (SIFT); the plain version takes any width. The
library is built at first use by orthosfm_torch.kernel_build.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orthosfm_torch import kernel_build

SOURCE = kernel_build.CSRC / "match_kernels.cu"
BIG = 4.0  # > any squared distance between unit descriptors
TILE = 128  # rows of the kernel's query and database tiles
KERNEL_DS = (64, 128)  # the kernel's instantiations: SURF and SIFT descriptors
MAX_SEG = 511  # database tiles a CTA at most (its tickets' flags in shared memory)
#: The kernel's grid: enough CTAs (pair, query tile, database segment) that
#: the last wave is a small share of the work (see the kernel's header)
GRID_TARGET = 4096
#: Per-launch cap of the kernel's partials (12 bytes per row, per query tile
#: and per segment, of each pair)
SCRATCH_BYTES = 1 << 30
#: The plain version's pair chunk keeps its (B, N, N) block ≲ 1 GB, the
#: batch cap of the JAX package's matcher (pipeline/matching.py:259-260)
PLAIN_BLOCK_ELEMS = 1 << 28

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"osfm_top2": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P]}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, _SIGNATURES)


def _empty_outputs(P, N, device):
    f = [torch.full((P, N), BIG, dtype=torch.float32, device=device) for _ in range(4)]
    i = [torch.zeros((P, N), dtype=torch.int32, device=device) for _ in range(2)]
    return [f[0], f[1], i[0], f[2], f[3], i[1]]


def top2_ref(stack, bi, bj, ci, cj):
    """Plain version: per pair chunk, one bmm → the d2 block masked on both
    sides → the smallest d2 twice along each axis. torch.topk promises no
    order among equal values, so the first minimum (torch.min's documented
    choice) is taken, its entry set to +inf, the minimum taken again and the
    entry restored: the ranking of lax.top_k(−d2, 2), in each direction."""
    P = bi.shape[0]
    V, N, D = stack.shape
    out = _empty_outputs(P, N, stack.device)
    if P == 0 or N == 0:
        return tuple(out)
    bad = ((torch.minimum(bi, bj) < 0) | (torch.maximum(bi, bj) >= V)
           | (torch.minimum(ci, cj) < 0) | (torch.maximum(ci, cj) > N))
    vi = torch.where(bad, 0, bi).long()
    vj = torch.where(bad, 0, bj).long()
    iota = torch.arange(N, device=stack.device)
    B = max(1, min(P, PLAIN_BLOCK_ELEMS // (N * N)))
    for s in range(0, P, B):
        sl = slice(s, s + B)
        sim = torch.bmm(stack[vi[sl]], stack[vj[sl]].transpose(1, 2))
        d2 = torch.clamp(2.0 - 2.0 * sim, min=0.0)
        rows = iota[None, :] < ci[sl, None]
        cols = iota[None, :] < cj[sl, None]
        d2 = torch.where(rows[:, :, None] & cols[:, None, :], d2, BIG)
        for dim, valid, (best, second, idx) in ((2, rows, out[:3]), (1, cols, out[3:])):
            b, i = torch.min(d2, dim=dim)
            d2.scatter_(dim, i.unsqueeze(dim), float("inf"))
            sec = torch.min(d2, dim=dim).values if N > 1 else torch.full_like(b, BIG)
            d2.scatter_(dim, i.unsqueeze(dim), b.unsqueeze(dim))
            best[sl] = torch.where(valid, b, BIG)
            second[sl] = torch.where(valid, sec, BIG)
            idx[sl] = torch.where(valid, i, 0).to(torch.int32)
    for k, t in enumerate(out):
        out[k] = torch.where(bad[:, None], float("nan") if t.is_floating_point() else -1, t)
    return tuple(out)


def _check(name, t, shape, device, dtype):
    if t.device != device:
        raise ValueError(f"{name} is on device {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_plan(P, N):
    """(database tiles per CTA, pairs per launch) of the kernel for P pairs
    of N rows, from the shapes alone."""
    nt = -(-N // TILE)
    nseg = min(nt, max(1, -(-GRID_TARGET // max(P * nt, 1)), -(-nt // MAX_SEG)))
    seg = -(-nt // nseg)
    nseg = -(-nt // seg)
    per_pair = 12 * N * (nseg + nt)
    return seg, max(1, min(P, SCRATCH_BYTES // per_pair))


def top2(stack, bi, bj, ci, cj, impl: str = "auto"):
    """(fwd_best, fwd_second, fwd_idx, bwd_best, bwd_second, bwd_idx), each
    (P, N): see the module docstring."""
    if kernel_build.resolve_impl(impl, stack.device) == "torch":
        return top2_ref(stack, bi, bj, ci, cj)
    dev = stack.device
    if dev.type != "cuda":
        raise ValueError(f"the top2 kernel needs CUDA tensors, got {dev}")
    V, N, D = stack.shape
    P = bi.shape[0]
    _check("stack", stack, (V, N, D), dev, torch.float32)
    for name, t in (("bi", bi), ("bj", bj), ("ci", ci), ("cj", cj)):
        _check(name, t, (P,), dev, torch.int32)
    if D not in KERNEL_DS:
        raise ValueError(f"the top2 kernel is built for descriptor widths {KERNEL_DS}, got {D}")
    outs = [torch.empty((P, N), dtype=dt, device=dev)
            for dt in (torch.float32, torch.float32, torch.int32) * 2]
    if P == 0 or N == 0:
        return tuple(outs)
    seg, chunk = launch_plan(P, N)
    nt = -(-N // TILE)
    scratch = torch.empty(3 * min(P, chunk) * N * (-(-nt // seg) + nt), dtype=torch.int32,
                          device=dev)
    tickets = torch.zeros((P, 2 * nt), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = library()
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        n = min(chunk, P - s)
        err = lib.osfm_top2(stack.data_ptr(), V, N, D, *(t[sl].data_ptr() for t in (bi, bj, ci, cj)),
                            n, seg, *(o[sl].data_ptr() for o in outs), scratch.data_ptr(),
                            tickets[sl].data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"top2: CUDA error {err} at launch")
        top2.launches += 1
    return tuple(outs)


top2.launches = 0
