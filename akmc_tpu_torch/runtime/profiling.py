"""Tracing and profiling utilities, the counterparts of
``akmc_tpu/runtime/profiling.py``.

The reference instruments with manual MPI_Wtime brackets written into the
output buffer, rocm-smi VRAM polling via popen, and CG iteration prints
(SURVEY.md §5). Here:

  * ``span``: a named span of a program's work, stamped on the device where
    it runs (``SpanTable``; the one switch is ``VCMModel.spans``);
  * ``HostSpans``: the host phases of one dispatch (``load``, ``launch``,
    ``read``, ``unpack``), each also a ``torch.profiler`` range;
  * ``align``: a profile's clock put on the device spans of its dispatches;
  * ``trace``: a ``torch.profiler`` capture of a block, written as a Chrome
    trace (chrome://tracing, Perfetto) into a directory, with the device
    spans of the block's dispatches on a track of their own;
  * ``device_memory_stats``: the CUDA caching allocator's accounting;
  * ``pull_sync``: wait until the device has computed a result.

**Spans.** A program's body (``models/step_program.py``) runs with its
``SpanTable`` active (``spanning``); each ``span(name)`` in the code it runs
opens and closes a row of the table by a stamp where it stands: on a card a
one-thread kernel that reads ``%globaltimer`` (``csrc/graph_while.cu``),
captured into the program's graph with the rest of the body; on the CPU the
eager body writes ``time.perf_counter_ns()``. A row keeps [sum, count, first
start, last end] in ns; a span inside a while body adds up the node's
passes. The table is zeroed by the body's first node and read with the
program's packed vector (``device_loop.record``): a dispatch still makes one
host read. With no table active ``span`` launches nothing, so a program
captured with spans off is node for node the one without spans. A span's
parent is the span open around it when it is first opened, so the table
gives each span's self time too. Loops replayed from the host
(``device_loop.StepProgram``) carry no spans.

**One clock.** With spans on, a dispatch launches one anchor stamp
(``span_anchor``) eagerly just before its replay: the profiler sees it as a
kernel, and its start there minus the ``%globaltimer`` value it wrote is the
offset that puts the dispatch's device spans on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

SPAN_ROWS = 32             # rows of a span table: distinct span names a program may open
_WORDS = 5                 # int64 words a row: sum, count, first start, last end, open start
OPEN, CLOSE, ANCHOR = 0, 1, 2    # the stamp kernel's ops (csrc/graph_while.cu)
ANCHOR_KERNEL = "span_anchor"    # the anchor stamp's kernel name, as a trace shows it


def stamp(row: torch.Tensor, op: int) -> None:
    """One stamp of ``op`` on a table row (five int64 words; an anchor: one) where the
    calling code stands: on a card the kernel ``span_stamp`` (or
    ``span_anchor``) on the current stream, into the graph a capture under
    way records; on the CPU the host clock, now."""
    if row.device.type == "cuda":
        from akmc_tpu_torch.ops import device_loop

        device_loop.bind(row)
        err = device_loop._while_lib().span_stamp_launch(
            torch.cuda.current_stream(row.device).cuda_stream, row.data_ptr(), op)
        if err:
            raise RuntimeError(f"span stamp launch failed (CUDA error {err})")
        return
    r = row.numpy()
    now = time.perf_counter_ns()
    if op == OPEN:
        r[4] = now
        if r[1] == 0:
            r[2] = now
    elif op == CLOSE:
        r[0] += now - r[4]
        r[1] += 1
        r[3] = now
    else:
        r[0] = now


def _int64s(values: Sequence[float]) -> np.ndarray:
    """int64 words from the f64 values of their int32 halves (low, high), as
    ``Recording.pack`` hands a tensor viewed as int32 back: exact, where an
    int64 nanosecond clock would lose its last bits as an f64."""
    w = np.asarray(values, dtype=np.float64).astype(np.int64)
    return (w[1::2] << 32) | (w[0::2] & 0xFFFFFFFF)


class SpanTable:
    """The spans of one program (or of one per-loop dispatch) on
    ``device``: ``SPAN_ROWS`` rows of stamps, allocated once, before any
    capture; the names and parents in the order the body first opened them;
    the anchor word of the last dispatch. ``last`` holds what the last read
    gave (``read``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stamps = torch.zeros((SPAN_ROWS, _WORDS), dtype=torch.int64, device=device)
        self.anchor = torch.zeros(1, dtype=torch.int64, device=device)
        self.rows: Dict[str, int] = {}
        self.parents: List[Optional[str]] = []
        self._open: List[str] = []
        self.last: Dict[str, dict] = {}

    def reset(self) -> None:
        """Zero the table (a program's first node) and forget the open spans."""
        self.stamps.zero_()
        self._open.clear()

    def open(self, name: str) -> None:
        i = self.rows.get(name)
        if i is None:
            if len(self.rows) == SPAN_ROWS:
                raise RuntimeError(f"more than {SPAN_ROWS} span names in one program")
            i = self.rows[name] = len(self.rows)
            self.parents.append(self._open[-1] if self._open else None)
        self._open.append(name)
        stamp(self.stamps[i], OPEN)

    def close(self, name: str) -> None:
        self._open.pop()
        stamp(self.stamps[self.rows[name]], CLOSE)

    def abandon(self) -> None:
        """The innermost open span left by an exception: no stamp."""
        self._open.pop()

    def stamp_anchor(self) -> None:
        """The dispatch's anchor, before its replay (or its eager body)."""
        stamp(self.anchor, ANCHOR)

    def tensors(self) -> tuple:
        """What a program records for its read: the rows and the anchor as
        int32 halves (``_int64s`` joins them again)."""
        return self.stamps[:, :4].reshape(-1).view(torch.int32), self.anchor.view(torch.int32)

    def read(self, values: Sequence[float]) -> Dict[str, dict]:
        """``last`` from the values of ``tensors`` as read: per span ``ms``,
        ``self_ms`` (less its children's), ``n`` (closes: passes of a while
        node), ``parent``, ``start_ns`` (first open) and ``end_ns`` (last
        close) on the device's clock (``clock`` "device"; on the CPU the
        host's ``perf_counter_ns``), and the ``anchor`` word as a span of
        zero length."""
        words = _int64s(values)
        rows = words[: SPAN_ROWS * 4].reshape(SPAN_ROWS, 4)
        out = {}
        for name, i in self.rows.items():
            total, n, first, last = (int(v) for v in rows[i])
            out[name] = {"ms": total * 1e-6, "self_ms": total * 1e-6, "n": n,
                         "parent": self.parents[i], "start_ns": first, "end_ns": last,
                         "clock": "device"}
        for name, s in out.items():
            if s["parent"] in out:
                out[s["parent"]]["self_ms"] -= s["ms"]
        anchor = int(words[SPAN_ROWS * 4])
        out["anchor"] = {"ms": 0.0, "self_ms": 0.0, "n": 1, "parent": None,
                         "start_ns": anchor, "end_ns": anchor, "clock": "device"}
        self.last = out
        return out


_ACTIVE: Optional[SpanTable] = None


@contextlib.contextmanager
def spanning(table: Optional[SpanTable]):
    """While open, ``span`` stamps into ``table`` (None: nothing is stamped)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, table
    try:
        yield table
    finally:
        _ACTIVE = prev


def suspended():
    """No span stamped inside the block (a loop replayed from the host)."""
    return spanning(None)


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A named span of the work the block issues, stamped into the active
    table where it stands (on a card, in the stream or graph under way).
    Nothing happens when no table is active."""
    table = _ACTIVE
    if table is None:
        yield
        return
    table.open(name)
    try:
        yield
    except BaseException:
        table.abandon()
        raise
    table.close(name)


class HostSpans:
    """The host phases of one dispatch of ``label`` (``akmc.<program>``):
    each ``span(phase)`` timed by ``perf_counter_ns`` and opened as a
    ``torch.profiler.record_function`` range ``<label>.<phase>``, so that a
    profile holds it on its own clock. A phase entered twice adds up."""

    def __init__(self, label: str):
        self.label = label
        self.spans: Dict[str, dict] = {}

    @contextlib.contextmanager
    def span(self, phase: str) -> Iterator[None]:
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(f"{self.label}.{phase}"):
            yield
        t1 = time.perf_counter_ns()
        s = self.spans.get(phase)
        if s is None:
            self.spans[phase] = {"ms": (t1 - t0) * 1e-6, "self_ms": (t1 - t0) * 1e-6, "n": 1,
                                 "parent": None, "start_ns": t0, "end_ns": t1, "clock": "host"}
        else:
            s["ms"] += (t1 - t0) * 1e-6
            s["self_ms"] = s["ms"]
            s["n"] += 1
            s["end_ns"] = t1


def host_span(spans: Optional[HostSpans], phase: str):
    """``spans.span(phase)``, or nothing when spans are off (None)."""
    return contextlib.nullcontext() if spans is None else spans.span(phase)


# dispatches' spans as each is read, for every open ``collecting`` block
_COLLECTORS: List[List[dict]] = []


def dispatched(spans: Dict[str, dict]) -> None:
    """A dispatch's spans (``VCMModel.last_spans``) handed to the open
    ``collecting`` blocks."""
    for c in _COLLECTORS:
        c.append(spans)


@contextlib.contextmanager
def collecting() -> Iterator[List[dict]]:
    """A list that receives the spans of every dispatch made inside the block."""
    got: List[dict] = []
    _COLLECTORS.append(got)
    try:
        yield got
    finally:
        _COLLECTORS.remove(got)


@dataclasses.dataclass
class Aligned:
    """Device spans on a profile's clock: ``spans`` as (name, parent, start
    µs, end µs, n, dispatch) in the profile's time; ``offsets_us``, each
    dispatch's anchor offset (profile time less ``%globaltimer``)."""

    spans: List[tuple]
    offsets_us: List[float]

    @property
    def offset_spread_us(self) -> float:
        return max(self.offsets_us) - min(self.offsets_us) if self.offsets_us else 0.0


def align_starts(anchor_starts_us: Sequence[float], dispatches: Sequence[dict]) -> Aligned:
    """``align`` on the anchor kernels' start times in a profile (µs, in
    order) and the dispatches' spans in order. A profile may hold more
    anchors than the dispatches given (a redone dispatch, one outside the
    list): the run of consecutive anchors whose offsets spread least is
    taken."""
    disp = [d for d in dispatches if d.get("anchor", {}).get("start_ns")]
    n, m = len(disp), len(anchor_starts_us)
    if not n or m < n:
        return Aligned([], [])
    best = None
    for s in range(m - n + 1):
        offs = [anchor_starts_us[s + i] - disp[i]["anchor"]["start_ns"] * 1e-3
                for i in range(n)]
        spread = max(offs) - min(offs)
        if best is None or spread < best[0]:
            best = (spread, offs)
    offs = best[1]
    out = []
    for k, (d, off) in enumerate(zip(disp, offs)):
        for name, s in d.items():
            if s.get("clock") != "device" or name == "anchor" or not s["n"]:
                continue
            out.append((name, s["parent"], s["start_ns"] * 1e-3 + off,
                        s["end_ns"] * 1e-3 + off, s["n"], k))
    return Aligned(out, offs)


def device_events(prof) -> List[tuple]:
    """(start µs, end µs, name) of every device operation of a profile: its
    kernels, copies and sets, not the device ranges it draws for the host's
    ``record_function`` ranges (user annotations)."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def host_ranges(prof, prefix: str) -> List[tuple]:
    """(start µs, end µs, name) of the host's ``record_function`` ranges of a
    profile whose name starts with ``prefix`` (``HostSpans``' phases)."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU
            and e.name.startswith(prefix)]


def align(prof, dispatches: Sequence[dict]) -> Aligned:
    """The device spans of ``dispatches`` (each a ``VCMModel.last_spans``, in
    the order they ran) on the clock of ``prof`` (a ``torch.profiler``
    session over them), by their anchor kernels."""
    starts = sorted(s for s, _, name in device_events(prof) if ANCHOR_KERNEL in name)
    return align_starts(starts, dispatches)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile this block (host operations, and the device's kernels when a
    card is present) and write it to a new ``trace_*.json`` Chrome trace in
    ``logdir``. Yields the profiler (``key_averages()`` for sums). With
    ``VCMModel.spans`` on, the device spans of the block's dispatches go
    into the file as well, aligned, on a track of their own ("akmc spans",
    a row per nesting depth): the work inside conditional while nodes,
    which the profiler does not see, shows there. Once a session has ended
    in a process, a program captured afterwards must not be profiled: its
    replays under the next session end in an illegal memory access
    (ROADMAP §3 A)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with collecting() as dispatches, torch.profiler.profile(activities=activities) as prof:
        yield prof
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=logdir)
    os.close(fd)
    prof.export_chrome_trace(path)
    if dispatches:
        _add_span_track(path, dispatches)


def _add_span_track(path: str, dispatches: Sequence[dict]) -> None:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    starts = sorted(float(e["ts"]) for e in events
                    if e.get("ph") == "X" and ANCHOR_KERNEL in str(e.get("name", "")))
    got = align_starts(starts, dispatches)
    depth = {}
    for name, parent, *_ in got.spans:
        depth[name] = depth.get(parent, -1) + 1 if parent is not None else 0
    for name, parent, t0, t1, n, k in got.spans:
        events.append({"ph": "X", "name": name, "cat": "akmc_span", "pid": "akmc spans",
                       "tid": depth.get(name, 0), "ts": t0, "dur": t1 - t0,
                       "args": {"passes": n, "dispatch": k, "parent": parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


def clock_resolution_ns(device, n: int = 4096) -> dict:
    """How fine ``%globaltimer`` is on ``device``: ``n`` reads back to back
    in one thread (``globaltimer_samples``), their smallest nonzero step
    and the median of the nonzero steps, in ns."""
    from akmc_tpu_torch.ops import device_loop

    out = torch.zeros(n, dtype=torch.int64, device=device)
    err = device_loop._while_lib().globaltimer_samples_launch(
        torch.cuda.current_stream(device).cuda_stream, out.data_ptr(), n)
    if err:
        raise RuntimeError(f"globaltimer_samples launch failed (CUDA error {err})")
    steps = np.diff(out.cpu().numpy())
    nz = steps[steps > 0]
    return {"min_step_ns": int(nz.min()) if nz.size else None,
            "median_step_ns": float(statistics.median(nz.tolist())) if nz.size else None,
            "distinct": int(nz.size + 1), "samples": n}


def device_memory_stats(device=None) -> Optional[dict]:
    """The caching allocator's bytes in use, their peak and the card's
    memory (the reference shells out to rocm-smi, kmc_main.cpp:42-53); None
    on the CPU."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))


def pull_sync(out):
    """Wait until every CUDA device that holds a tensor of ``out`` (tensors,
    and dicts, lists, tuples and dataclasses of them) has finished its work;
    returns ``out``. PyTorch returns before the device finishes, so a timing
    bracket ends with this."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out
