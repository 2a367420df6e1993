"""CUDA graphs: the port's counterpart of `jax.jit` over `lax.while_loop`.

The reference package compiles a solve, an MPC step and a control step of
the closed loop into one XLA program each, its data-dependent loops (the
iterations, the rho retry) as `lax.while_loop`s.  Here each of them is one
CUDA graph, captured once per static signature and replayed:

  * `while_loop(cond, body, max_trips)` is the loop.  Under capture it is a
    conditional WHILE node (`csrc/graph_nodes.cu`): the body is captured
    once, and the device decides how often it runs, so the host reads
    nothing.  On the CPU it is a host loop that reads the test before each
    trip (the reads are returned, the `host_syncs` of the callers).  Inside
    `masked()` the body runs for its whole budget with no test at all; the
    body commits every result under the test (`torch.where`), so a trip the
    test would have stopped changes nothing.  That is how the CPU tests hold
    the graph's semantics against the host loop, and, with one trip, how a
    capture's warm-up runs every body once.
  * `Captured(fn, args)` captures fn on static copies of args: a warm-up on
    a side stream first (every loop body once, so every lazy cache is built
    outside the capture), then the capture.  A call copies its inputs into
    the static buffers, replays, and returns clones of the outputs, so a
    later call never changes what an earlier one returned.
  * `GraphCache` keys the captures by signature: the structure, shapes,
    dtypes and device of the arguments plus whatever static values the
    caller bakes in (flags, cost weights).

A capture that fails raises with the CUDA error; nothing falls back to eager
execution.  Each capture keeps its seconds, nodes and pool bytes
(`Captured.stats`, `GraphCache.stats`).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from parallel_ddp_tpu_torch.ops import build

# cudaStreamCaptureModeGlobal: the mode torch.cuda.graph captures in
_CAPTURE_MODE_GLOBAL = 0


class _State(threading.local):
    masked: Optional[int] = None     # None: loops test; 0: whole budget; k: k trips
    emulate: bool = False            # CPU tensors take the graph route too
    depth: int = 0                   # WHILE nodes open around the capture point
    bodies: Optional[list] = None    # body graphs made during the current capture


_state = _State()
_body_streams: dict = {}             # (device, depth) -> torch.cuda.Stream


def capturing(t: torch.Tensor) -> bool:
    """Whether work on t's device is being captured into a graph now."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def replayed(device: torch.device) -> bool:
    """Whether an entry point runs on device by replaying its graph: always
    on the card; on the CPU only inside `emulate()`."""
    return device.type == "cuda" or _state.emulate


@contextlib.contextmanager
def emulate():
    """Send CPU tensors down the graph route too, to test it without a card:
    a "capture" keeps the callable and its static buffers, and a replay runs
    it eagerly on them with every loop masked over its whole budget (what
    the WHILE nodes compute, trip for trip)."""
    prev = _state.emulate
    _state.emulate = True
    try:
        yield
    finally:
        _state.emulate = prev


def in_masked() -> bool:
    return _state.masked is not None


@contextlib.contextmanager
def masked(trips: Optional[int] = None):
    """Run every `while_loop` inside for `trips` trips (default: each
    loop's whole budget) with no test; the bodies commit under the test."""
    prev = _state.masked
    _state.masked = 0 if trips is None else int(trips)
    try:
        yield
    finally:
        _state.masked = prev


def while_loop(cond: Callable[[], torch.Tensor], body: Callable[[torch.Tensor], Any],
               max_trips: int) -> int:
    """Run body(go) while cond() (a 0-d bool tensor) holds, at most max_trips
    times; body commits its results in place under go.  Returns the host
    reads of the test (0 under capture and inside `masked`)."""
    go = cond()
    if capturing(go):
        _while_node(go, cond, body)
        return 0
    if _state.masked is not None:
        trips = max_trips if _state.masked == 0 else min(_state.masked, max_trips)
        for trip in range(trips):
            if trip:
                go = cond()
            body(go)
        return 0
    reads = 0
    for trip in range(max_trips):
        if trip:
            go = cond()
        reads += 1
        if not bool(go):
            break
        body(go)
    return reads


def _body_stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    key = (device, depth)
    if key not in _body_streams:
        _body_streams[key] = torch.cuda.Stream(device=device)
    return _body_streams[key]


def _while_node(go, cond, body) -> None:
    """Capture a WHILE node whose first test is go and whose body is
    body(go) followed by the next test, cond()."""
    lib = build.library()
    parent = torch.cuda.current_stream(go.device)
    _state.depth += 1
    try:
        stream = _body_stream(go.device, _state.depth)
        handle, graph = ctypes.c_ulonglong(), ctypes.c_void_p()
        build.check(lib.pddp_while_begin(parent.cuda_stream, go.data_ptr(), stream.cuda_stream,
                                         _CAPTURE_MODE_GLOBAL, ctypes.byref(handle),
                                         ctypes.byref(graph)), "while node")
        if _state.bodies is not None:
            _state.bodies.append(graph.value)
        with torch.cuda.stream(stream):
            body(go)
            nxt = cond()
            build.check(lib.pddp_while_end(stream.cuda_stream, handle, nxt.data_ptr()),
                        "while node end")
    finally:
        _state.depth -= 1


def _nodes(graph) -> int:
    count = ctypes.c_ulonglong()
    build.check(build.library().pddp_graph_nodes(graph, ctypes.byref(count)), "graph nodes")
    return count.value


class CaptureStats(NamedTuple):
    label: str
    seconds: float       # warm-up excluded: capture and instantiation
    nodes: int           # the graph's nodes and those of every WHILE body
    pool_bytes: int      # device memory the graph's pool reserved
    body_nodes: tuple = ()   # each WHILE body's nodes, in capture order


def _static_copy(leaf, device):
    if leaf is None:                     # an absent optional argument
        return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    if isinstance(leaf, (bool, int, float)):
        return torch.full((), leaf, device=device)
    raise TypeError(f"cannot capture an argument of type {type(leaf).__name__}")


class Captured:
    """fn captured on static copies of args (see the module docstring)."""

    def __init__(self, fn: Callable, args: tuple, label: str):
        leaves, self._spec = pytree.tree_flatten(args)
        device = next(t.device for t in leaves if isinstance(t, torch.Tensor))
        self._static = [_static_copy(t, device) for t in leaves]
        self.args = pytree.tree_unflatten(self._static, self._spec)
        if device.type == "cpu":             # `emulate()`: no capture
            self._fn, self.out, self.graph = fn, None, None
            self.stats = CaptureStats(label, 0.0, 0, 0)
            return
        self._fn = None

        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)
        with torch.cuda.stream(side), masked(1):
            fn(*self.args)
        current.wait_stream(side)
        build.prepare_counters(device)

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()         # what stays reserved is the pools'
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        _state.bodies = bodies = []
        try:
            with torch.cuda.graph(graph, pool=pool):
                _allocate_thread_to_pool(device, pool)
                out = fn(*self.args)
        finally:
            _state.bodies = None
        # the routing to the pool took a reference of its own on it
        torch._C._cuda_releasePool(device.index, pool)
        body_nodes = tuple(_nodes(b) for b in bodies)
        nodes = _nodes(graph.raw_cuda_graph()) + sum(body_nodes)
        graph.instantiate()
        torch.cuda.synchronize(device)
        self.stats = CaptureStats(label, time.perf_counter() - t0, nodes,
                                  torch.cuda.memory_reserved(device) - reserved, body_nodes)
        self.graph = graph
        self.out = out

    def load(self, *args) -> None:
        """Copy args (the capture's structure) into the static buffers."""
        for buf, new in zip(self._static, pytree.tree_leaves(args)):
            if new is None:
                continue
            if isinstance(new, torch.Tensor):
                buf.copy_(new)
            else:
                buf.fill_(new)

    def replay(self) -> None:
        if self.graph is None:
            with masked():
                self.out = self._fn(*self.args)
        else:
            self.graph.replay()

    def outputs(self):
        """Clones of the outputs: nothing a later replay writes."""
        return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                               self.out)

    def __call__(self, *args):
        self.load(*args)
        self.replay()
        return self.outputs()


def _allocate_thread_to_pool(device: torch.device, pool) -> None:
    """Send every allocation of this thread to the graph's pool until the
    capture ends.  torch routes only the capturing stream's allocations
    there; a WHILE body is captured from a stream of its own, whose tensors
    must live in the graph's memory too.  The capture's own routing is
    replaced (the caching allocator keeps one per pool) and the capture's
    end removes this one."""
    torch._C._cuda_endAllocateToPool(device.index, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, pool)


def signature(args, *static) -> tuple:
    """A hashable key: the structure, shapes, dtypes and devices of args'
    tensors and the types of its other leaves, plus the static values."""
    leaves, spec = pytree.tree_flatten(args)
    return (str(spec), tuple((tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor)
                             else type(t) for t in leaves)) + static


class GraphCache:
    """Captures of one callable's variants, by signature."""

    def __init__(self, label: str):
        self.label = label
        self._graphs: dict = {}

    def get(self, key, fn: Callable, args: tuple) -> Captured:
        found = self._graphs.get(key)
        if found is None:
            found = self._graphs[key] = Captured(fn, args, self.label)
        return found

    def __len__(self) -> int:
        return len(self._graphs)

    def stats(self) -> list:
        return [g.stats for g in self._graphs.values()]
