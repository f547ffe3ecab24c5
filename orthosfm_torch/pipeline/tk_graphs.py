"""A group's Tomasi-Kanade initialization as one CUDA graph.

What run_pose_estimation does for a group before its filters
(pipeline/incremental.py, initial_rotations: the RANSAC draws, K5 on the
hypotheses, K6, the model choice with the fallback's Gram and K5 problem,
the mirror resolution and the cameras' rotation parameters) is a fixed chain
of some 300 small launches whose shapes do not change within a run. On a
CUDA device with no mesh it is captured once a shape as a CUDA graph and
replayed for every later group, and every later run, of that shape: one
launch from the host in place of the chain, and no host round trip.

A graph is kept a key, which TKGraphs.run derives from what the graph bakes
in: the function and its keyword arguments (initial_rotations with the
RANSAC configuration, the solver, the generator and the TK solver), and the
device, shape and dtype of each input (the tracks T, the group size, and
whether the group is a run's first, which has no anchor to read). GRAPHS_KEPT
are kept, the least recently used dropped first. Before a replay the group's
inputs are copied into the graph's own; its output is copied out right after
it, since the graphs of a device share one memory pool, their scratch (the
capture stream's cuBLAS workspace too) reserved there and not allocated.

The draws come from one generator a device (TKGraphs.generator), registered
with every graph captured there; a run reseeds it. Philox is counter-based:
a replay draws what the eager code draws from the same state, and leaves the
generator where the eager code leaves it.

A key's first call runs eagerly, which gives its answer, loads the kernels
and makes the constants the capture reads, and then captures the graph.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch


#: graphs kept: sweep16's mix uses 12 (3 clouds x 2 solvers, a run's first
#: group and the later ones)
GRAPHS_KEPT = 16


class _Graph(NamedTuple):
    """A captured graph, the input tensors it reads and the output it
    writes."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    output: torch.Tensor


class TKGraphs:
    """The kept graphs (least recently used first), and a TK generator, a
    memory pool and a capture stream a device. ``captures`` counts the
    graphs captured."""

    def __init__(self):
        self.captures = 0
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._generators = {}
        self._pools = {}

    def generator(self, device) -> torch.Generator:
        """The device's TK generator, which every graph captured there draws
        from (a card named without an index is the current one)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._generators:
            self._generators[device] = torch.Generator(device=device)
        return self._generators[device]

    def graphed(self, device: torch.device, mesh_active: bool, generator) -> bool:
        """Whether a TK initialization on ``device`` goes through a graph: a
        CUDA device, no mesh of more than one rank, and the draws from the
        device's TK generator (any other generator, or a CPU device, runs
        the eager code)."""
        return (device.type == "cuda" and not mesh_active
                and generator is self._generators.get(device))

    def run(self, fn: functools.partial, inputs: tuple):
        """(``fn(*inputs)``, the route) through the graph of fn (its function
        and arguments) and the inputs' device, shapes and dtypes. The key's
        first call ("capture") runs fn eagerly, then captures it on copies of
        the inputs, which the graph keeps; every later call ("replay")
        copies the inputs into them and replays."""
        key = (fn.func, fn.args, tuple(sorted(fn.keywords.items())),
               tuple((t.device, t.shape, t.dtype) for t in inputs))
        entry = self._graphs.get(key)
        if entry is None:
            answer = fn(*inputs)
            self._graphs[key] = self._capture(fn, tuple(t.clone() for t in inputs))
            while len(self._graphs) > GRAPHS_KEPT:
                self._graphs.popitem(last=False)
            return answer, "capture"
        self._graphs.move_to_end(key)
        for kept, t in zip(entry.inputs, inputs):
            kept.copy_(t)
        with torch.cuda.device(entry.inputs[0].device):
            entry.graph.replay()
        return entry.output.clone(), "replay"

    def _capture(self, fn, inputs) -> _Graph:
        device = inputs[0].device
        if device not in self._pools:
            self._pools[device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        pool, stream = self._pools[device]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generators[device])
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool, stream=stream):
            output = fn(*inputs)
        # cuBLAS keeps a workspace a stream (32 MiB on an H100); the capture stream's came
        # from the pool during the capture. Handed back to the pool, it is scratch that the
        # device's graphs, replayed one after another, share (as torch's CUDA graph trees
        # do); held, it would stay allocated for good.
        torch._C._cuda_clearCublasWorkspaces()
        self.captures += 1
        return _Graph(graph, inputs, output)


#: the process's graphs, kept across runs: the first run of a shape captures,
#: every later one replays
GRAPHS = TKGraphs()
