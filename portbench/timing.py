"""Timing and counting helpers, copied from ``chip_smoke.py`` (its
``cuda_time_ms`` and ``count_syncs``) so that the yardstick lives with the
benchmark; and the reduction of a profiler session to device busy time,
the heaviest device operations and the longest idle gaps."""

from __future__ import annotations

import contextlib
import warnings

import torch


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device milliseconds a call: CUDA events around ``reps`` calls after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def count_syncs(dev):
    """A list that receives one warning per host synchronisation made inside
    the block (CUDA only; on a CPU device it stays empty)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)


def n_syncs(caught) -> int:
    return sum("synchroniz" in str(w.message) for w in caught)


NAME_CHARS = 120   # kernel names are cut to their head: templates run to kilobytes


def _device_events(prof):
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            tr = e.time_range
            out.append((tr.start, tr.end, e.name))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_profile(prof, top: int = 10) -> dict:
    """busy seconds (the union of device operations' intervals), the ``top``
    device operations by summed time and the ``top`` longest gaps between
    them, each named by the innermost host operation open at the gap's
    start. Empty when the trace holds no device operation."""
    dev_ev = _device_events(prof)
    if not dev_ev:
        return {}
    merged = _union([(s, e) for s, e, _ in dev_ev])
    busy_us = sum(e - s for s, e in merged)
    by_name: dict = {}
    for s, e, name in dev_ev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((merged[k + 1][0] - merged[k][1], merged[k][1])
                   for k in range(len(merged) - 1)), reverse=True)[:top]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU]
    named = []
    for length, at in gaps:
        open_ops = [(e - s, name) for s, e, name in host if s <= at <= e]
        named.append([(min(open_ops)[1] if open_ops else "host")[:NAME_CHARS], length * 1e-6])
    return {
        "busy_s": busy_us * 1e-6,
        "device_ops": [[name[:NAME_CHARS], us * 1e-6] for name, us in ops],
        "idle_gaps": named,
    }
