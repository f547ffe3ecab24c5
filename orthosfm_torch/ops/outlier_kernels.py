"""The outlier filter's nearest-neighbour search on the card: one
hand-written CUDA kernel (orthosfm_torch/csrc/outlier_kernels.cu) and,
beside it, its plain PyTorch version.

  kernel wrapper   plain version                  replaces (JAX package)
  outlier_nn       outliers.nearest_neighbor_     no Pallas kernel: the XLA
                   distances(impl="torch")        program ops/outliers.py:24
                                                  nearest_neighbor_distances

outlier_nn(pts, has_pt) -> nn (T,): pts (T, 4) f32 homogeneous points,
has_pt (T,) bool. nn[i] is the distance from track i to the nearest other
track with a point, from the plain version's expansion
max(|p_i|² + |p_j|² − 2 p_i·p_j, 0), BIG (1e12) where track i has no
pointed neighbour (so nn = 1e6), and 0 where track i has no point. The
kernel takes the plain version's own squared norms (torch.sum(pts * pts,
-1), whose order over a row of 4 follows the points' layout) and rounds its
dot products as the f32 GEMM does, so the two give the same bits on the
card; on the CPU, whose GEMM rounds otherwise, they agree to the
expansion's rounding, a few ulp of |p_i|² + |p_j|² (see the CUDA source's
header).

The wrapper launches the kernel on CUDA tensors or raises (no fallback):
one launch a call (``outlier_nn.launches``), on the current stream, with
no host sync and no copy to or from the host; beside it, the squared norms
and a contiguous copy of the points where they are not contiguous, and its
scratch, a key a track and a ticket a query block, zeroed on the stream
(torch.zeros); BIG is a kernel argument. ``launch_plan`` cuts the candidate axis from T alone.
The library is built at first use by orthosfm_torch.kernel_build (nvcc,
into orthosfm_torch/_build/) and bound with ctypes; ``host_library()`` is
the same source built for the host (tests only: the kernel's arithmetic,
every CTA one after another, on the CPU).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orthosfm_torch import kernel_build

SOURCE = kernel_build.CSRC / "outlier_kernels.cu"
BIG = 1e12  # the plain version's distance² of an excluded pair
# As in the CUDA source: threads of a CTA, query tracks a thread, candidates
# a shared-memory stage, CTAs resident on an SM
THREADS, ROWS, TILE, MIN_BLOCKS = 128, 8, 64, 6
QUERIES = THREADS * ROWS  # a CTA's query block
H100_SMS = 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGS = [_I, _I, _P, _P, _P, _F, _P, _P]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, {"osfm_outlier_nn": [*_ARGS, _P]})


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The same source built by the host C++ compiler (for tests)."""
    return kernel_build.load(SOURCE, {"osfm_outlier_nn_host": _ARGS}, host=True)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(T: int, sms: int = H100_SMS) -> int:
    """Candidates a CTA takes (its share of the candidate axis): the axis is
    split over S CTAs so that S x ceil(T / QUERIES) fills the card's
    resident CTAs (sms x MIN_BLOCKS) once, each share at least half a
    stage (TILE / 2; its last stage is padded)."""
    blocks = -(-T // QUERIES)
    splits = max(1, min(-(-T // (TILE // 2)), sms * MIN_BLOCKS // blocks))
    return -(-T // splits)


def _check(pts, has_pt, device):
    T = pts.shape[0]
    for name, t, shape, dtype in (("pts", pts, (T, 4), torch.float32),
                                  ("has_pt", has_pt, (T,), torch.bool)):
        if t.device != device:
            raise ValueError(f"{name} is on device {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _operands(pts, has_pt):
    """The kernel's inputs: the points and has_pt in contiguous memory, the
    plain version's squared norms (from the points as given), the zeroed
    scratch and the output."""
    T = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    keys = torch.zeros(T + -(-T // QUERIES), dtype=torch.int32, device=pts.device)
    nn = torch.empty((T,), dtype=torch.float32, device=pts.device)
    return pts.contiguous(), sq, has_pt.contiguous(), keys, nn


def outlier_nn(pts, has_pt):
    """nn (T,) of the tracks' points: see the module docstring."""
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"the outlier_nn kernel needs CUDA tensors, got {dev}")
    _check(pts, has_pt, dev)
    T = pts.shape[0]
    if T == 0:
        return torch.empty((0,), dtype=torch.float32, device=dev)
    ops = _operands(pts, has_pt)
    err = library().osfm_outlier_nn(T, launch_plan(T, _sms(dev.index)),
                                    *(t.data_ptr() for t in ops[:3]), BIG,
                                    *(t.data_ptr() for t in ops[3:]),
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"outlier_nn: CUDA error {err} at launch")
    outlier_nn.launches += 1
    return ops[-1]


outlier_nn.launches = 0


def outlier_nn_host(pts, has_pt, chunk: int):
    """The kernel's arithmetic on CPU tensors (host_library, tests only),
    the candidate axis cut in shares of `chunk` tracks."""
    _check(pts, has_pt, torch.device("cpu"))
    ops = _operands(pts, has_pt)
    if host_library().osfm_outlier_nn_host(pts.shape[0], chunk,
                                           *(t.data_ptr() for t in ops[:3]), BIG,
                                           *(t.data_ptr() for t in ops[3:])) != 0:
        raise ValueError(f"outlier_nn_host: {pts.shape[0]} tracks in shares of {chunk}")
    return ops[-1]
