"""Tracing and profiling utilities, the counterparts of
``akmc_tpu/runtime/profiling.py``.

The reference instruments with manual MPI_Wtime brackets written into the
output buffer, rocm-smi VRAM polling via popen, and CG iteration prints
(SURVEY.md §5). Here:

  * ``PhaseTimers``: wall-clock phase timers accumulated into a dict;
  * ``trace``: a ``torch.profiler`` capture of a block, written as a Chrome
    trace (chrome://tracing, Perfetto) into a directory;
  * ``device_memory_stats``: the CUDA caching allocator's accounting;
  * ``pull_sync``: wait until the device has computed a result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class PhaseTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.last: Dict[str, float] = {}
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.last[name] = dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": self.totals[k],
                "mean_s": self.totals[k] / max(1, self.counts[k]),
                "count": self.counts[k],
            }
            for k in self.totals
        }


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile this block (host operations, and the device's kernels when a
    card is present) and write it to a new ``trace_*.json`` Chrome trace in
    ``logdir``. Yields the profiler (``key_averages()`` for sums)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=logdir)
    os.close(fd)
    prof.export_chrome_trace(path)


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
