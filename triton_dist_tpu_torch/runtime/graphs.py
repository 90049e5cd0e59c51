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

`compiled(fn, state=..., static=...)` is the counterpart of `jax.jit` for
a step function that takes its state as arguments (the prefill, the SP
decode step, the EP layer, the PP schedule): a `Compiled`, whose first
call of a new signature runs `fn` eagerly on the capture stream (the
graph's warm-up, its result the call's) and captures it, and whose later
calls of that signature copy their inputs into the graph's static buffers,
bind their state and replay (module docstring of `Compiled`).
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
import time
import weakref
from typing import Callable, Dict, Optional, Sequence

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
    own. With `first_call`, `first` keeps the warm-up's result: the
    warm-up is then a step's real first call, fn's commit flag unused
    (`Compiled`)."""

    def __init__(self, fn: Callable[[bool], object], device, pool=None,
                 first_call: bool = False):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {dev}")
        t0 = time.perf_counter()
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warm = fn(False)
        self.first = warm if first_call else None
        del warm
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


def _state_leaves(x, name: str) -> list:
    """The tensors of a state argument, in order: a tensor, a tuple or
    list of them, or a dataclass of them (an LL context); None holds
    none."""
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _state_leaves(item, name)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in _state_leaves(getattr(x, f.name), name)]
    raise TypeError(f"state argument {name!r}: a {type(x).__name__} is not "
                    "a tensor, a tuple or list, or a dataclass of tensors")


def _input_key(x, name: str, tensors: list):
    """An input argument's part of a signature: each tensor's shape,
    dtype and device (the tensor appended to `tensors`), tuples and lists
    by their items, any other value by itself (it must hash)."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_input_key(i, name, tensors) for i in x))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"argument {name!r}: a {type(x).__name__} is neither "
                        "a tensor nor hashable; name it in static= or "
                        "state=") from None
    return (type(x), x)


def _tree_map(x, fn, into_dataclasses: bool):
    """x with fn applied to each of its tensors, through tuples, lists,
    named tuples and, with into_dataclasses, dataclasses (an LL context);
    other values as they are. Walks `_input_key`'s order (without
    dataclasses) and `_state_leaves`' (with)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(i, fn, into_dataclasses) for i in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(i, fn, into_dataclasses) for i in x)
    if into_dataclasses and dataclasses.is_dataclass(x) \
            and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _tree_map(getattr(x, f.name), fn, True)
            for f in dataclasses.fields(x)})
    return x


def _returned(x, state: Sequence[torch.Tensor],
              leaves: Sequence[torch.Tensor]):
    """A replay's outputs as the call returns them: a tensor that is a
    state tensor of the graph comes back as the caller's tensor bound to
    it, any other tensor as a copy (the next replay rewrites the graph's);
    tuples, lists and dataclasses item by item."""
    def one(t):
        for s, mine in zip(state, leaves):
            if (t.data_ptr() == s.data_ptr() and t.shape == s.shape
                    and t.stride() == s.stride()):
                return mine
        return t.clone()

    return _tree_map(x, one, True)


class Compiled:
    """A step function captured per signature, `jax.jit`'s counterpart
    (`compiled`). Its arguments are of three kinds, by name:

      state   updated in place by the step (a KV cache, an LL context, a
              device call count, a kv length): tensors, or tuples, lists
              or dataclasses of them. They are bound to the graph's
              `Resident` (one per shape of all of them, taken from
              `states`, which an owner may share with its other graphs),
              so every caller's state of that shape replays one graph,
              and after the call the caller's tensors hold the new state;
      static  held by reference: weights, tables, callables, geometry;
              the graph reads them at the addresses it captured, so a
              different object (by identity) is a new signature, and the
              graph keeps the objects it was made with;
      inputs  every other argument: tensors (in tuples and lists too),
              copied into the graph's static buffers before each replay,
              and hashable values.

    The signature is the inputs' shapes, dtypes and devices and their
    values, the state's shapes and dtypes, the statics' identities. The
    first call of a signature runs `fn` eagerly on the device's capture
    stream and returns its result (the graph's warm-up), then captures
    it; a later call replays. What a replay returns is the captured
    outputs with every state tensor replaced by the caller's and every
    other tensor copied, as a jitted function returns new arrays. At
    most `size` graphs, the least recently used dropped (`graphs`, a
    GraphCache; `graphs.made` counts captures); they share one memory
    pool, since each replay's outputs are copied out before the next. On
    the CPU, with no tensor argument, or with `cuda_graph` False (the A/B
    switch, settable) a call runs `fn`. A capture that fails raises."""

    def __init__(self, fn: Callable, state: Sequence[str] = (),
                 static: Sequence[str] = (), size: int = 8,
                 cuda_graph: bool = True,
                 states: Optional["weakref.WeakValueDictionary"] = None):
        self._sig = inspect.signature(fn)
        unknown = [a for a in (*state, *static)
                   if a not in self._sig.parameters]
        if unknown:
            raise ValueError(f"{unknown}: not arguments of {fn.__name__}")
        self.fn = fn
        self.state, self.static = tuple(state), tuple(static)
        self.cuda_graph = cuda_graph
        self.graphs = GraphCache(size)
        self.states = (weakref.WeakValueDictionary() if states is None
                       else states)
        self.pool = None

    def __call__(self, *args, **kwargs):
        call = self._sig.bind(*args, **kwargs)
        call.apply_defaults()
        leaves, inputs, key = [], [], []
        for name, value in call.arguments.items():
            if name in self.state:
                got = _state_leaves(value, name)
                leaves += got
                key.append(shape_key(*got))
            elif name in self.static:
                key.append(id(value))
            else:
                key.append(_input_key(value, name, inputs))
        dev = next((t.device for t in (*leaves, *inputs)), None)
        if self._eager(dev):
            return self.fn(*args, **kwargs)
        made = []

        def make():
            made.append(self._capture(call, leaves, inputs, dev))
            return made[0]

        g = self.graphs.get(tuple(key), make)
        if made:
            out, g.first = g.first, None
            return out
        if g.state is not None:
            g.state.bind(leaves)
        for buf, x in zip(g.inputs, inputs):
            buf.copy_(x)
        return _returned(g.replay(), g.state.tensors if g.state else (),
                         leaves)

    def _eager(self, dev) -> bool:
        """Whether a call on `dev` runs fn: off the card, or switched off."""
        return not self.cuda_graph or dev is None or dev.type != "cuda"

    def _capture(self, call, leaves, inputs, dev) -> StepGraph:
        """A new signature's graph: the state bound, the static input
        buffers made, the first call run eagerly on the caller's own
        arguments, then the step captured on the buffers and the graph's
        state tensors (so the graph holds no caller's object)."""
        state = None
        if leaves:
            skey = shape_key(*leaves)
            state = self.states.get(skey)
            if state is None:
                state = self.states[skey] = Resident(leaves)
            state.bind(leaves)
        bufs = [x.clone() for x in inputs]
        it, own = iter(bufs), iter(state.tensors if state else ())
        on_bufs = {n: (_tree_map(v, lambda _: next(own), True)
                       if n in self.state else v if n in self.static
                       else _tree_map(v, lambda _: next(it), False))
                   for n, v in call.arguments.items()}
        calls = [call, inspect.BoundArguments(self._sig, on_bufs)]

        def step(commit: bool):  # the caller's arguments, then the buffers
            c = calls.pop(0) if len(calls) > 1 else calls[0]
            return self.fn(*c.args, **c.kwargs)

        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        g = StepGraph(step, dev, pool=self.pool, first_call=True)
        g.state, g.inputs = state, bufs
        g.statics = [call.arguments[n] for n in self.static]
        return g


def compiled(fn: Callable, state: Sequence[str] = (),
             static: Sequence[str] = (), size: int = 8,
             cuda_graph: bool = True, states=None) -> Compiled:
    """`fn` captured per signature as a CUDA graph on the card: the
    counterpart of `jax.jit(fn)` (with its state donated). See
    `Compiled`."""
    return Compiled(fn, state, static, size, cuda_graph, states)
