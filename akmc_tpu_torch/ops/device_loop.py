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
``torch.Generator`` needs a graph-safe registration there. ``Prefill`` draws
the k steps' uniforms into static buffers before each replay, in the order the
plain loop draws them, and after the last replay gives back the draws of the
steps that were dead (``mark``/``rewind`` of the draws source), so the source
ends where the plain loop leaves it.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Hashable, List, Sequence

import torch


class StepProgram:
    """``body`` (k steps of a loop and the pack of its flags, over tensors
    the caller owns) as one CUDA graph on a card, or eagerly on the CPU.
    ``capture`` must run while the state is dead: with ``warm`` it first runs
    the body once eagerly on a side stream, as PyTorch asks before a
    capture (a program whose steps were warmed by another needs none)."""

    def __init__(self, body: Callable[[], None], device: torch.device):
        self.body, self.device = body, device
        self.graph = None
        self.capture_s = 0.0        # host seconds of the warm body, capture and instantiation

    def capture(self, warm: bool = True) -> None:
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        if warm:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.body()
            torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.body()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        if self.device.type == "cuda":
            self.graph.replay()
        else:
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
        return sum(p.loop.capture_s for p in self.programs.values())


def program(graphs, key: Hashable, make: Callable[[], object]):
    """The cached program of ``key``, or with no cache a new one."""
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
    first replay runs min(FIRST_K, k) steps and every later one k; each
    length is one ``StepProgram``, both captured at once while the state is
    dead, after one eager run of the shorter. ``prefill``: the loop's
    uniforms, drawn before each replay."""

    def __init__(self, body, k: int, device: torch.device, flags: torch.Tensor, live_at: int,
                 prefill: "Prefill" = None):
        self.k, self.first = k, min(FIRST_K, k)
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
