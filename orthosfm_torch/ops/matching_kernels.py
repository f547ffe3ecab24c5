"""Per-row top-2 nearest neighbours of descriptor pairs: the hand-written CUDA
kernel (orthosfm_torch/csrc/match_kernels.cu) and, beside it, its plain
PyTorch version.

  kernel wrapper   plain version   replaces (JAX package)
  top2             top2_ref        ops/matching_pallas.py::top2_similarity,
                                   with a pair axis (the batched matcher's
                                   einsum + top_k, ops/matching.py:106-114)

top2(stack, bi, bj, ci, cj): stack (V, N, D) f32, bi/bj/ci/cj (P,) int32.
For pair p and query row r < ci[p], over database rows c < cj[p] of view
bj[p]: the smallest d2 = max(2 − 2·<stack[bi[p], r], stack[bj[p], c]>, 0),
the second smallest, and the column of the smallest (the lower column among
equal d2, as lax.top_k). An empty database gives (4, 4, 0); rows r ≥ ci[p]
give (4, 4, 0). Outputs (P, N) f32, f32, int32.

A wrapper given CPU tensors calls the plain version; given CUDA tensors it
launches its kernel or raises ("auto"; impl="torch" runs the plain version
on any device). It counts its launches in ``top2.launches``. The library is
built at first use by orthosfm_torch.kernel_build.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orthosfm_torch import kernel_build

SOURCE = kernel_build.CSRC / "match_kernels.cu"
BIG = 4.0  # > any squared distance between unit descriptors
#: The plain version's pair chunk keeps its (B, N, N) block ≲ 1 GB, the
#: batch cap of the JAX package's matcher (pipeline/matching.py:259-260)
PLAIN_BLOCK_ELEMS = 1 << 28

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"osfm_top2": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P]}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, _SIGNATURES)


def top2_ref(stack, bi, bj, ci, cj):
    """Plain version: per pair chunk, bmm → mask → the smallest d2 twice.
    torch.topk promises no order among equal values, so the first minimum
    (torch.min's documented choice) is taken, its column set to +inf, and
    the minimum taken again: the ranking of lax.top_k(−d2, 2)."""
    P = bi.shape[0]
    V, N, D = stack.shape
    best = torch.full((P, N), BIG, dtype=torch.float32, device=stack.device)
    second = torch.full((P, N), BIG, dtype=torch.float32, device=stack.device)
    idx = torch.zeros((P, N), dtype=torch.int32, device=stack.device)
    if P == 0 or N == 0:
        return best, second, idx
    iota = torch.arange(N, device=stack.device)
    B = max(1, min(P, PLAIN_BLOCK_ELEMS // (N * N)))
    for s in range(0, P, B):
        sl = slice(s, s + B)
        sim = torch.bmm(stack[bi[sl].long()], stack[bj[sl].long()].transpose(1, 2))
        d2 = torch.clamp(2.0 - 2.0 * sim, min=0.0)
        d2 = torch.where(iota[None, None, :] < cj[sl, None, None], d2, BIG)
        b, i = torch.min(d2, dim=-1)
        d2.scatter_(-1, i[..., None], float("inf"))
        sec = torch.min(d2, dim=-1).values if N > 1 else torch.full_like(b, BIG)
        rows = iota[None, :] < ci[sl, None]
        best[sl] = torch.where(rows, b, BIG)
        second[sl] = torch.where(rows, sec, BIG)
        idx[sl] = torch.where(rows, i, 0).to(torch.int32)
    return best, second, idx


def _check(name, t, shape, device, dtype):
    if t.device != device:
        raise ValueError(f"{name} is on device {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def top2(stack, bi, bj, ci, cj, impl: str = "auto"):
    """(best_d2, second_d2, idx), each (P, N): see the module docstring."""
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
    if D % 32 or stack.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16-byte rows: descriptor width {D} must be a "
                         "multiple of 32 and the stack 16-byte aligned")
    if P > 65535:
        raise ValueError(f"{P} pairs exceed one launch's grid")
    # the kernel reads the rows these name: one check (and host sync) a call
    if P and bool(torch.any((torch.minimum(bi, bj) < 0) | (torch.maximum(bi, bj) >= V)
                            | (torch.minimum(ci, cj) < 0) | (torch.maximum(ci, cj) > N))):
        raise ValueError(f"pair views must lie in [0, {V}) and valid counts in [0, {N}]")
    best = torch.empty((P, N), dtype=torch.float32, device=dev)
    second = torch.empty((P, N), dtype=torch.float32, device=dev)
    idx = torch.empty((P, N), dtype=torch.int32, device=dev)
    err = library().osfm_top2(stack.data_ptr(), N, D, bi.data_ptr(), bj.data_ptr(),
                              ci.data_ptr(), cj.data_ptr(), P, best.data_ptr(),
                              second.data_ptr(), idx.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"top2: CUDA error {err} at launch")
    top2.launches += 1
    return best, second, idx


top2.launches = 0
