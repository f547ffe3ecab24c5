"""The device mesh of the port's multi-device path: port of
orthosfm_tpu/parallel/mesh.py over torch.distributed.

The JAX package shards its track, pair and hypothesis axes over a 1-D mesh
axis ("tracks") with shard_map and psum. Here each process (a rank) holds
one shard of that axis on its own device; the control flow runs replicated
on every rank, as in the JAX package, and the ranks meet only in the
collectives of `Mesh`: all_reduce (psum) and all_gather. NCCL carries them
between cards, gloo between CPU processes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

TRACK_AXIS = "tracks"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process group (None for a mesh of
    one device and no group), this rank, the world size and the rank's
    device. Every rank calls the collectives in the same order."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str = TRACK_AXIS

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sums t over the ranks, in place (the JAX package's psum); no
        host sync on CUDA."""
        if self.size > 1 or self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t (of one shape on every rank), concatenated along
        dim 0 in rank order."""
        if self.size == 1 and self.group is None:
            return t
        t = t.contiguous()
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts)
        return out.view(torch.bool) if t.dtype == torch.bool else out

    def shard(self, n: int) -> slice:
        """This rank's slice of an axis of n entries, n a multiple of size."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _default_device(backend: str) -> torch.device:
    """NCCL: the card of this rank's local rank (LOCAL_RANK, set by torchrun,
    else the rank); gloo: the CPU."""
    if backend != "nccl":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the running process group (init_distributed), or with no
    group a mesh of one device (`device`, default CUDA). n_devices, where
    given, must be the group's world size."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} devices needs a process group: "
                               "call init_distributed on every rank first")
        return Mesh(None, 0, 1, torch.device("cuda" if device is None else device))
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the process group has {size} ranks, not {n_devices}")
    dev = _default_device(dist.get_backend()) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, dist.get_rank(), size, dev)


def init_distributed(init_method: str = "env://", world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device=None) -> Mesh:
    """Joins the process group and returns the mesh: the counterpart of
    jax.distributed.initialize. backend None: NCCL where a card is present,
    gloo on the CPU. init_method "env://" (torchrun, and multi-host
    launches) reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK; with
    "tcp://host:port" give world_size and rank. device: the rank's device
    (default: cuda:LOCAL_RANK under NCCL, the CPU under gloo)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return make_mesh(device=device)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
