"""CUDA graphs of the port's steps — the counterpart of the JAX package's
compiled steps (triton_dist_tpu/models/engine.py: the jit'd decode step,
`_build_gen_fn`'s `lax.fori_loop`, the jit'd serve step), which its
module docstring names as its form of the reference's CUDA-graph capture
of the decode step (Triton-distributed models/engine.py:75-105).

`StepGraph(fn, device)` captures one call of a step into a
`torch.cuda.CUDAGraph` and replays it. `fn(commit)` runs the step over
tensors whose addresses stay fixed (static inputs the caller copies
into, the graph's `Resident` state, the weights) and returns its
outputs; with commit=False it must leave every state as it found it (it
may rewrite what the step writes, but advance no length and feed back no
token). The capture:

  1. warm-up: fn(False) once, eagerly, on a capture stream of the
     device's own, so every kernel is built and loaded, every launch grid
     queried (csrc/shmem.cuh grid_of) and every persistent pool entry
     (`_build.PoolCache`, keyed by stream) made on the stream the graph
     records;
  2. capture: fn(True) on that stream, under `_build.capturing()`: the
     kernels' launches are recorded (a cooperative launch too: stream
     capture takes `cudaLaunchCooperativeKernel` as a kernel node with
     the cooperative attribute), the pool entries the step takes are
     held by the graph (a PoolCache eviction cannot free what a replay
     writes to), and the fresh zeroed flag pools some kernels take a
     call (ag_gemm, the megakernel) are allocated from the graph's
     private memory pool with their memset recorded, so every replay
     starts them from zero. The capture calls no `empty_cache`: the
     private pool's size is what the device's reserved memory grew by.

A graph is fixed to the addresses it captured, so the state a step
updates in place (a KV cache, a serve pool) is the graph's own:
`Resident` holds it, and `bind` lends it to the caller's tensors. A
caller's tensor not yet bound is copied in once and then made a view
of the graph's memory (`Tensor.set_`), so later calls on it copy
nothing, its old memory is freed, and whatever writes it writes the
graph's state; the tensor bound before it to the same slot gets a copy
of its value first, so it keeps what it held. One graph a shape thus
serves every cache of that shape. A new graph's owner binds the call's
state and token first, so the warm-up runs on the step's own inputs.

A replay runs on the current stream and adds the captured launches to
the wrappers' counts. A failed capture raises (a refused launch names its
kernel, `_build.check`); nothing falls back to an eager step.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, Sequence

import torch

from triton_dist_tpu_torch.kernels import _build

_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's capture stream, one for every graph: the pool entries
    the warm-ups make are keyed by it, so graphs of one shape share
    them."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    s = _STREAMS.get(idx)
    if s is None:
        s = _STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


class StepGraph:
    """One captured call of `fn` (see the module docstring). `outputs` are
    the captured call's results, rewritten by every replay; `launches`
    the kernels' launches a replay makes; `capture_s` the wall time of
    the warm-up and the capture; `pool_bytes` the memory the capture
    added to the graph's pool. `pool` (`torch.cuda.graph_pool_handle()`)
    is a memory pool the graph shares with the other graphs captured
    into it, for graphs replayed one at a time whose capture leaves no
    memory of the pool holding a value from one replay to the next
    (their state lives outside it); by default the graph's pool is its
    own."""

    def __init__(self, fn: Callable[[bool], object], device, pool=None):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {dev}")
        t0 = time.perf_counter()
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn(False)
        self.graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: collecting another
        # graph (held in a reference cycle) destroys it, which a capture
        # does not permit, and the capture is lost
        gc.collect()
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with _build.capturing() as self.capture, \
                    torch.cuda.stream(stream):
                self.graph.capture_begin(pool=pool)
                try:
                    self.outputs = fn(True)
                finally:
                    self.graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = self.capture.launches
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Run the captured step on the current stream; returns outputs."""
        self.graph.replay()
        self.capture.replayed()
        return self.outputs


class Resident:
    """The state a graph updates in place: `tensors`, zeros shaped like
    `like`, lent to a caller's tensors by `bind` (the module
    docstring)."""

    def __init__(self, like: Sequence[torch.Tensor]):
        self.tensors = [torch.zeros_like(t) for t in like]
        self._holders = [None] * len(self.tensors)

    def bind(self, tensors: Sequence[torch.Tensor]) -> None:
        """Make each of `tensors` a view of the matching static tensor,
        copying its value in unless it is one already; a tensor bound
        before to that slot and still a view of it gets a copy."""
        for i, (t, s) in enumerate(zip(tensors, self.tensors)):
            if t.shape != s.shape or t.dtype != s.dtype:
                raise ValueError(f"state {i}: {tuple(t.shape)} {t.dtype}, "
                                 f"the graph's {tuple(s.shape)} {s.dtype}")
            if t.data_ptr() == s.data_ptr() and t.stride() == s.stride():
                continue
            held = self._holders[i] and self._holders[i]()
            if held is not None and held.data_ptr() == s.data_ptr():
                held.set_(s.clone())
            s.copy_(t)
            t.set_(s)
            self._holders[i] = weakref.ref(t)


class GraphCache:
    """An owner's graphs by key, at most `size`, the least recently used
    dropped first (a dropped graph frees its private pool), as the JAX
    Engine bounds its compiled executables (`_gen_cache_max`). `made`
    counts the captures."""

    def __init__(self, size: int = 8):
        self.size = size
        self.graphs: Dict[tuple, StepGraph] = {}
        self.made = 0

    def get(self, key, make: Callable[[], StepGraph]) -> StepGraph:
        g = self.graphs.pop(key, None)
        if g is None:
            while len(self.graphs) >= self.size:  # before the new capture
                self.graphs.pop(next(iter(self.graphs)))
            g = make()
            self.made += 1
        self.graphs[key] = g
        return g


def shape_key(*tensors: torch.Tensor) -> tuple:
    """The shapes and dtypes of the state a graph is made for."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)
