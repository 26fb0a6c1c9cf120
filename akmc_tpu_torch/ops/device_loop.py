"""Loops kept on the device: k guarded steps between two host reads.

``akmc_tpu`` runs each event loop as one ``lax.while_loop`` on the device. The
port keeps a loop's whole state in tensors on the device and runs ``k`` steps
of its body between two reads of one packed vector of flags and counters. On a
CUDA device the k steps are captured once into a ``torch.cuda.CUDAGraph`` and
replayed; on the CPU the same steps run eagerly. Each step works out on the
device whether the loop is still running (``live``) and guards every write
with it, so steps past the loop's end change nothing and k changes no result.

A captured graph reads and writes fixed tensors. A program therefore owns its
state tensors: the caller copies its inputs in before the first replay and
its results out after the last one. ``LoopGraphs`` keeps programs by a key of
everything that shapes the graph, so that an owner (``VCMModel``) captures
each of its loops once. A capture that fails raises: nothing falls back to a
host loop.

Uniforms cannot be drawn inside a capture from a host ``ReplayDraws``, and a
``torch.Generator``'s offset is fixed when a graph is captured. ``Prefill``
draws the k steps' uniforms from such a source into static buffers before
each replay, in the order the plain loop draws them, and after the last
replay gives back the draws of the steps that were dead (``mark``/``rewind``
of the draws source), so the source ends where the plain loop leaves it.
``akmc_tpu``'s threefry key (``ops/threefry.py::KeyDraws``) needs none of
that: the loop holds the key on the device and each step draws from it
inside the graph, moving it on only when live. Draws in a graph come from
such a device key, never from a host generator.

Inside a program (``models/step_program.py``: a whole superstep as one CUDA
graph, the counterpart of ``akmc_tpu``'s one executable per superstep) a loop
is no chain of replays but a ``while_loop``: on a card a conditional WHILE
node of the enclosing capture (``csrc/graph_while.cu``), elsewhere the same
body run eagerly while its device flag is set. A program's body reads nothing
back: what its loops count (passes, live steps, launches, iterations) it
``record``s as device tensors, and the program reads them all at once with
its result.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import gc
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from akmc_tpu_torch.runtime import profiling


class StepProgram:
    """``body`` (k steps of a loop and the pack of its flags, over tensors
    the caller owns) as one CUDA graph on a card, or eagerly on the CPU.
    ``capture`` must run while the state is dead: with ``warm`` it first runs
    the body once eagerly on a side stream, as PyTorch asks before a
    capture (a program whose steps were warmed by another needs none); the
    cyclic collector is off during the capture, so that no dropped graph is
    freed inside it."""

    def __init__(self, body: Callable[[], None], device: torch.device):
        self.body, self.device = body, device
        self.graph = None
        self.capture_s = 0.0        # host seconds of the warm body, capture and instantiation
        self.launches: List = []    # kernel wrappers the graph launches, once each per replay
        self.bound: List[tuple] = []    # what the graph binds from outside its pools (``tracing_bindings``)

    def capture(self, warm: bool = True) -> None:
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        if warm:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), _launches_into([]), profiling.suspended():
                self.body()       # the warm run is not counted
            torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a dropped program keeps its graphs in a reference cycle until the
        # cyclic collector runs; run inside a capture, it would destroy them
        # there, which CUDA does not permit and which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tracing_bindings(self.device) as bound, torch.cuda.graph(graph), \
                    _launches_into([]) as fns, profiling.suspended():
                self.body()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.launches, self.bound = graph, fns, bound
        self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        if self.device.type == "cuda":
            self.graph.replay()
            for fn in self.launches:
                fn.launches += 1
        else:
            with profiling.suspended():
                self.body()


class LoopGraphs:
    """The programs of one owner, by key (shapes, types, options, the static
    tables' addresses): each is built, and on a card captured, once."""

    def __init__(self):
        self.programs: Dict[Hashable, object] = {}

    def get(self, key: Hashable, make: Callable[[], object]):
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = make()
        return prog

    def capture_s(self) -> float:
        """Host seconds spent capturing all programs so far."""
        return sum(p.capture_s for p in self.programs.values())


def program(graphs, key: Hashable, make: Callable[[], object]):
    """The cached program of ``key``, or with no cache a new one. A program
    owns tensors that outlive the call, so none is made inside a while
    body under capture: its tensors would lie in the bodies' shared pool
    (``body_pool``), where later bodies write. Build it before the capture."""
    made = graphs.programs.get(key) if graphs is not None else None
    if made is None and _WHILE_DEPTH and torch.cuda.is_available() \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a loop program would be made inside a captured while body; "
                           "build it before the capture")
    return make() if graphs is None else graphs.get(key, make)


class Prefill:
    """Uniforms of a replay's n steps drawn ahead into static buffers:
    ``bufs[i]`` are step i's buffers in the order the plain loop draws them.
    ``fill(draws, n)`` before a replay; ``settle(live, n)`` after its read,
    with the steps that ran live.

    A source that cannot hand out a step's vectors (a ``ReplayDraws`` that
    is exhausted or out of step) fails only if that step runs live: the
    error is kept and raised by ``settle``. When fewer than n steps ran live
    the source is rewound to where the fill began and the live steps' draws
    are made again, so it ends exactly where the plain loop leaves it."""

    def __init__(self, bufs: Sequence[Sequence[torch.Tensor]]):
        self.bufs: List[Sequence[torch.Tensor]] = list(bufs)
        self.draws = self.mark = self.error = None
        self.supplied = 0

    def fill(self, draws, n: int) -> None:
        self.draws, self.mark = draws, draws.mark()
        self.supplied, self.error = n, None
        for i, step in enumerate(self.bufs[:n]):
            try:
                for buf in step:
                    draws.fill(buf)
            except (RuntimeError, ValueError) as e:
                self.supplied, self.error = i, e
                return

    def settle(self, live: int, n: int) -> None:
        if live > self.supplied:
            raise self.error
        if live < n:
            self.draws.rewind(self.mark)
            for step in self.bufs[:live]:
                for buf in step:
                    self.draws.fill(buf)


# steps of a loop's first replay: a loop that ends within them (a sweep's
# superstep fires a handful of events) pays for no more dead steps
FIRST_K = 4


class GraphLoop:
    """The replays of one loop. ``body(n)`` runs steps 0..n-1 over the
    loop's state and packs its flags into ``flags``: ``flags[0]`` whether the
    loop is live after them, ``flags[live_at]`` the live steps so far. The
    first replay runs min(``first``, k) steps and every later one k; each
    length is one ``StepProgram``, both captured at once while the state is
    dead, after one eager run of the shorter. ``prefill``: the loop's
    uniforms, drawn before each replay."""

    def __init__(self, body, k: int, device: torch.device, flags: torch.Tensor, live_at: int,
                 prefill: "Prefill" = None, first: int = FIRST_K):
        self.k, self.first = k, min(first, k)
        self.flags, self.live_at, self.prefill = flags, live_at, prefill
        self.programs = {n: StepProgram(functools.partial(body, n), device)
                         for n in sorted({self.first, k})}
        for i, prog in enumerate(self.programs.values()):
            prog.capture(warm=i == 0)   # the shorter body warms the step's operations

    @property
    def capture_s(self) -> float:
        return sum(p.capture_s for p in self.programs.values())

    def run(self, draws=None):
        """Replays until the loop is dead: (the flags as read last,
        replays, steps run)."""
        replays = steps = live_before = 0
        while True:
            n = self.first if replays == 0 else self.k
            if draws is not None:
                self.prefill.fill(draws, n)
            self.programs[n].run()
            replays, steps = replays + 1, steps + n
            flags = self.flags.tolist()        # the replay's one host read
            live = int(flags[self.live_at])
            if draws is not None:
                self.prefill.settle(live - live_before, n)
            live_before = live
            if not flags[0]:
                return flags, replays, steps


# ----------------------------------------------------------------------
# what a captured graph binds from outside its private pools, and memory it
# does not own filled with NaN: two checks of a graph's lifetimes, which
# ``chip_smoke.py`` turns on (``TRACE_BINDINGS``); the main path runs neither
# ----------------------------------------------------------------------
TRACE_BINDINGS = False
_BINDS: Optional[List[tuple]] = None     # (address, bytes) of each storage touched


def _span(t: torch.Tensor) -> tuple:
    st = t.untyped_storage()
    return st.data_ptr(), st.nbytes()


def bind(*tensors: Optional[torch.Tensor]) -> None:
    """The tensors whose addresses a kernel wrapper hands to CUDA itself (a
    raw pointer, which no PyTorch operation shows): noted for the binding
    trace of a capture under way, else nothing."""
    if _BINDS is not None:
        _BINDS.extend(_span(t) for t in tensors if t is not None and t.is_cuda)


class _Touches(TorchDispatchMode):
    """Notes the storage of every CUDA tensor an operation takes or gives."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        bind(*(t for t in _pytree.tree_leaves((args, kwargs, out))
               if isinstance(t, torch.Tensor)))
        return out


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def live_blocks(device: torch.device) -> List[tuple]:
    """(start, end) of every block the caching allocator has handed out on
    ``device`` and not taken back, sorted (``torch.cuda.memory_snapshot``)."""
    idx = _index(device)
    return sorted((b["address"], b["address"] + b["size"])
                  for seg in torch.cuda.memory_snapshot() if seg["device"] == idx
                  for b in seg["blocks"] if b["state"] == "active_allocated")


def _inside(blocks: List[tuple], ptr: int, n: int) -> bool:
    i = bisect.bisect_right(blocks, (ptr, float("inf"))) - 1
    return i >= 0 and blocks[i][0] <= ptr and ptr + n <= blocks[i][1]


@contextlib.contextmanager
def tracing_bindings(device: torch.device):
    """Around a capture: yields a list that, once the block has ended, holds
    the (address, bytes) of each storage the capture touched (an operation's
    tensors, a kernel wrapper's ``bind``) that lay in a block handed out
    before it began: what the graph binds from outside its private pools
    (operands, loaded inputs, key state, a kernel's workspace), which must
    outlive it. Empty unless ``TRACE_BINDINGS``."""
    global _BINDS
    bound: List[tuple] = []
    if not TRACE_BINDINGS or device.type != "cuda":
        yield bound
        return
    before = live_blocks(device)
    prev, _BINDS = _BINDS, []
    try:
        with _Touches():
            yield bound
    finally:
        seen, _BINDS = _BINDS, prev
    bound.extend(sorted({(p, n) for p, n in seen if n and _inside(before, p, n)}))


def stale_bindings(bound: Sequence[tuple], device: torch.device) -> List[tuple]:
    """The spans of ``bound`` (``tracing_bindings``) that lie inside no live
    block now: a replay would read or write memory the allocator has taken
    back or handed to another tensor's block."""
    blocks = live_blocks(device)
    return [(p, n) for p, n in bound if not _inside(blocks, p, n)]


def private_pools(device: torch.device) -> List[tuple]:
    """The while bodies' pools on ``device`` (``body_pool``), every depth."""
    return [pool for (idx, _), pool in _BODY_POOLS.items() if idx == _index(device)]


def poison_free_blocks(device: torch.device, pools: Sequence[tuple] = ()) -> int:
    """Fill every free block of the caching allocator on ``device``, in the
    default pool and in each private pool of ``pools`` (a graph's, the while
    bodies'), with 0xFF bytes (NaN as f64, -1 as an integer), then give them
    back: a replay that reads memory it does not own, or a temporary before
    writing it, then reads those. Each block is taken by an allocation of its
    size on its own stream, largest first. Returns the bytes filled."""
    idx = _index(device)
    groups: Dict[tuple, List[int]] = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg["segment_pool_id"])
        if seg["device"] != idx or (any(pool) and pool not in pools):
            continue
        for b in seg["blocks"]:
            if b["state"] == "inactive":
                groups.setdefault((pool, seg["stream"]), []).append(b["size"])
    held, filled = [], 0
    for (pool, stream), sizes in groups.items():
        s = (torch.cuda.default_stream(device) if stream == 0
             else torch.cuda.ExternalStream(stream, device=device))
        with torch.cuda.stream(s):
            if any(pool):
                torch._C._cuda_beginAllocateCurrentStreamToPool(idx, pool)
            try:
                for n in sorted(sizes, reverse=True):
                    held.append(torch.empty(n, dtype=torch.uint8, device=device).fill_(255))
                    filled += n
            finally:
                if any(pool):    # each begin counts a user of the pool: give it back
                    torch._C._cuda_endAllocateToPool(idx, pool)
                    torch._C._cuda_releasePool(idx, pool)
    torch.cuda.synchronize(device)
    del held
    return filled


# ----------------------------------------------------------------------
# programs: a body that runs its loops as while nodes and reads nothing back
# ----------------------------------------------------------------------
class Recording:
    """What a program's body registers while it runs: device tensors to read
    with its result, each with the host action that takes their values
    (``apply``; a warm run's recording is dropped, not applied)."""

    def __init__(self):
        self.entries: List[tuple] = []     # (tensors, apply)

    def pack(self, dtype=torch.float64) -> List[torch.Tensor]:
        """The recorded tensors as 1-D pieces of ``dtype``, in order."""
        return [t.reshape(-1).to(dtype) for ts, _ in self.entries for t in ts]

    def apply(self, values: Sequence[float]) -> None:
        """Hand each entry its values, as read."""
        at = 0
        for ts, fn in self.entries:
            n = sum(t.numel() for t in ts)
            fn(values[at: at + n])
            at += n


_RECORDING: Optional[Recording] = None


@contextlib.contextmanager
def recording(rec: Recording):
    """Runs a program's body: while it is open, the loops are while loops,
    and counts are recorded in ``rec`` instead of made on the host."""
    global _RECORDING
    prev, _RECORDING = _RECORDING, rec
    try:
        yield rec
    finally:
        _RECORDING = prev


def in_program() -> bool:
    """Whether a program's body is running (or being captured)."""
    return _RECORDING is not None


def record(tensors: Sequence[torch.Tensor], apply: Callable[[Sequence[float]], None]) -> None:
    """Inside a program, keep ``tensors`` to be read with its result and
    handed to ``apply``; outside one, read them now and apply."""
    rec = _RECORDING
    if rec is None:
        apply([v for t in tensors for v in t.reshape(-1).tolist()])
        return
    if _LOOP_DEPTH:
        raise RuntimeError("a count inside a while loop's body would be made once per "
                           "capture, not once per pass: record it after the loop")
    rec.entries.append((tuple(tensors), apply))


# kernel wrappers launched inside the body being captured or run: a while
# loop's body (counted per pass) or a ``StepProgram``'s (counted per replay)
_PER_PASS: Optional[List] = None


def count_launch(fn) -> None:
    """One launch of a kernel wrapper ``fn`` (``fn.launches``): now, or in a
    program once per run of the program (not per capture or warm run), or
    inside a while loop's body or a ``StepProgram``'s once per pass or
    replay that runs it."""
    if _PER_PASS is not None:
        _PER_PASS.append(fn)
        return

    def add(_):
        fn.launches += 1
    record((), add)


@contextlib.contextmanager
def _launches_into(fns: List):
    """While open, ``count_launch`` appends to ``fns`` instead of counting."""
    global _PER_PASS
    prev, _PER_PASS = _PER_PASS, fns
    try:
        yield fns
    finally:
        _PER_PASS = prev


_CONDITION_READS = 0     # > 0 while an eager while loop reads its flag
_WHILE_DEPTH = 0         # while loops (and conds) open around the code that runs
_LOOP_DEPTH = 0          # of which while loops that may pass more than once


def condition_read() -> bool:
    """Whether the read under way is an eager while loop's read of its flag
    (on a card the node's condition, which the device reads itself)."""
    return _CONDITION_READS > 0


def _condition(live: torch.Tensor) -> bool:
    global _CONDITION_READS
    _CONDITION_READS += 1
    try:
        return bool(live)
    finally:
        _CONDITION_READS -= 1


def _while_lib():
    """``csrc/graph_while.cu`` (while nodes, span stamps), built and typed on
    first use."""
    from akmc_tpu_torch.ops import cuda_build

    lib = cuda_build.load("graph_while")
    if lib.graph_while_begin.argtypes is None:
        v = ctypes.c_void_p
        lib.graph_while_begin.argtypes = [v, v, v, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.graph_while_begin.restype = ctypes.c_int
        lib.graph_while_end.argtypes = [v, ctypes.c_ulonglong, v]
        lib.graph_while_end.restype = ctypes.c_int
        lib.graph_while_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.graph_while_versions.restype = ctypes.c_int
        lib.span_stamp_launch.argtypes = [v, v, ctypes.c_int]
        lib.span_stamp_launch.restype = ctypes.c_int
        lib.globaltimer_samples_launch.argtypes = [v, v, ctypes.c_int]
        lib.globaltimer_samples_launch.restype = ctypes.c_int
    return lib


def cuda_versions() -> tuple:
    """(runtime, driver) CUDA versions as the while nodes' library sees them,
    e.g. (12090, 13000); conditional nodes need 12030 or later of both."""
    rt, drv = ctypes.c_int(), ctypes.c_int()
    err = _while_lib().graph_while_versions(ctypes.byref(rt), ctypes.byref(drv))
    if err:
        raise RuntimeError(f"cudaRuntimeGetVersion failed: CUDA error {err}")
    return rt.value, drv.value


# per device and nesting depth: the stream the while bodies are captured on
# and the private pool their allocations go to
_BODY_STREAMS: Dict[tuple, torch.cuda.Stream] = {}
_BODY_POOLS: Dict[tuple, tuple] = {}


def body_pool(device: torch.device, depth: int = 0):
    """The private memory pool of the while bodies captured on ``device`` at
    nesting ``depth``. A body's temporaries are made and dropped in each pass
    in the same order, and the graphs that hold bodies of one depth replay
    one after the other on one stream, so they share it. Each depth has its
    own: ending a nested body's allocation to a pool ends the first one
    registered for that pool, which would be the enclosing body's."""
    pool = _BODY_POOLS.get((device.index, depth))
    if pool is None:
        pool = _BODY_POOLS[(device.index, depth)] = torch.cuda.graph_pool_handle()
    return pool


@contextlib.contextmanager
def refuse_syncs():
    """PyTorch's synchronisation check set to raise while the block runs: an
    operation that would read back (and so invalidate a capture under way)
    raises before it reaches CUDA, and the capture can still be ended."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _while_node(live: torch.Tensor, body: Callable[[], None], depth: int) -> None:
    dev = live.device
    lib = _while_lib()
    outer = torch.cuda.current_stream(dev)
    side = _BODY_STREAMS.get((dev.index, depth))
    if side is None:
        side = _BODY_STREAMS[(dev.index, depth)] = torch.cuda.Stream(dev)
    handle = ctypes.c_ulonglong()
    bind(live)
    err = lib.graph_while_begin(outer.cuda_stream, side.cuda_stream, live.data_ptr(),
                                ctypes.byref(handle))
    if err:
        raise RuntimeError(
            "could not open a CUDA graph while node "
            + ("(the stream is not capturing)" if err == -1 else f"(CUDA error {err})"))
    pool = body_pool(dev, depth)
    with torch.cuda.stream(side):
        torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
        try:
            with refuse_syncs():
                body()
        finally:
            torch._C._cuda_endAllocateToPool(dev.index, pool)
            err = lib.graph_while_end(side.cuda_stream, handle.value, live.data_ptr())
    if err:
        raise RuntimeError(f"could not close a CUDA graph while node (CUDA error {err})")


def while_loop(live: torch.Tensor, body: Callable[[], None], _once: bool = False) -> None:
    """``while live: body()`` for a 0-d bool device flag that ``body`` sets
    again as its last step. In a CUDA stream capture: a conditional while
    node of the graph being captured, with the body captured once into it
    (a capture that cannot take one raises; nothing falls back). Elsewhere
    (the CPU, an eager run on a card) the body runs eagerly while a read of
    the flag is true. Kernels the body launches (``count_launch``) count
    once per pass: in a program's capture the node counts its passes on the
    device and records them, and its condition kernel counts in
    ``while_loop.launches``."""
    global _WHILE_DEPTH, _LOOP_DEPTH
    if live.dtype != torch.bool or live.dim() != 0:
        raise ValueError("while_loop needs a 0-d bool flag")
    captured = live.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if captured:
        passes = torch.zeros((), dtype=torch.int64, device=live.device)

        def counted():
            body()
            passes.add_(1)
    loops = 0 if _once else 1
    _WHILE_DEPTH += 1
    _LOOP_DEPTH += loops
    try:
        with _launches_into([]) as fns:
            if captured:
                _while_node(live, counted, _WHILE_DEPTH - 1)
            else:
                while _condition(live):
                    body()
    finally:
        _WHILE_DEPTH -= 1
        _LOOP_DEPTH -= loops
    if not captured:
        for fn in fns:           # the launches made, counted where the loop stands
            count_launch(fn)
        return
    if _RECORDING is None:       # a graph of the caller's own: its replays are not counted
        return

    def add(v):
        # the node's condition kernel runs at entry and after every pass;
        # the body's kernels once per pass
        n = int(v[0])
        while_loop.launches += n + 1
        for fn in fns:
            fn.launches += n
    record((passes,), add)


while_loop.launches = 0     # runs of the while nodes' condition kernel (csrc/graph_while.cu)


# values a cond's body may record (``cond``)
COND_SLOTS = 8


def cond(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """``if pred: body()`` for a 0-d bool device flag: the counterpart of
    ``lax.cond``'s branch that is not always taken. Outside a program it
    reads ``pred`` and runs ``body`` or not. Inside one it is a
    ``while_loop`` whose body clears its own flag (on a card a conditional
    while node that passes at most once). What ``body`` records is copied
    into ``COND_SLOTS`` values allocated outside the node, and handed to
    its ``apply`` only after a read that shows the branch ran. ``body``
    must leave its results in tensors made before the call."""
    if _RECORDING is None:
        if _condition(pred):
            body()
        return
    live = pred.clone()
    taken = pred.to(torch.float64)
    slots = torch.zeros(COND_SLOTS, dtype=torch.float64, device=pred.device)
    sub = Recording()
    used = [0]

    def once():
        with recording(sub):
            body()
        vals = sub.pack()
        if vals:
            flat = torch.cat(vals)
            if flat.numel() > COND_SLOTS:
                raise RuntimeError(f"a cond's body recorded {flat.numel()} values, more "
                                   f"than its {COND_SLOTS} slots")
            slots[: flat.numel()].copy_(flat)
            used[0] = flat.numel()
        live.fill_(False)

    while_loop(live, once, _once=True)

    def apply(v):
        if v[0]:
            sub.apply(v[1:])
    record((taken, slots[: used[0]]), apply)
