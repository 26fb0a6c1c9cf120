"""The program's own spans over one pass of the cell's mix, read by the
span metrics (``metrics/*_device_ms.py``, ``batch_*_us.py``,
``untraced_idle_pct.py``, ``dispatch_host_ms.py``).

After the window, as ``pairwise_ms`` measures after it, on a card in a
process of its own that builds the cell again (``run_apart`` says why): one
pass of the mix with the spans off, then with the model's spans on
(``VCMModel.spans``: every program captured again with device stamps at its
module boundaries, ``runtime/profiling.py``) one pass uncounted
(``"spans_warm"``: the captures), the first pass again on the same stream,
unprofiled, for the spans' cost, bracketed by the same pass with the spans
off before and after (``"spans_cost"`` all three), and one under
``torch.profiler`` (``"spans"``), the streams drawn from the seed. Then the spans go off again and the spanned programs are dropped.

The profiled pass gives each dispatch's device spans (the stamps inside
its CUDA graph, while nodes included, which the profiler does not see) and
its host phases; each dispatch's anchor kernel puts its spans on the
profiler's clock (``profiling.align``). The summary keeps, a superstep, each
span's device ms and self ms; the mean time of a batch's race and
resolution; the share of the pass's window (first ``load`` to last
``unpack``) in which neither a profiler device operation nor an aligned
device span is open, beside the profiler's own idle share over the same
window; the ten longest gaps between profiler device operations, each with
the span or host phase open across it; the anchors' offsets; the host
phases of a dispatch as the timed pass takes them (beside the profiled
pass's); the spans' cost; ``%globaltimer``'s resolution.

A program without spans (no ``last_spans``), or a run without a card,
gives None: every reader then reports nothing.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.timing import _union  # noqa: E402

DEVICE = "device"
HOST_PHASES = ("load", "launch", "read", "unpack")
CHILD_SECONDS = 900     # the child's limit: set-up (about a minute at the cell's size) and four passes


def _covered(merged, lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def _cover(at: float, spans: list, host: list) -> str:
    """The innermost aligned device span open at ``at`` (one closed once in
    its dispatch: a span of many passes has no one interval), else the host
    phase open then, else "none"."""
    best = None
    for name, _, s, e, n, _ in spans:
        if n == 1 and s <= at <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    if best is not None:
        return best[1]
    for s, e, name in host:
        if s <= at <= e:
            return name
    return "none"


def reduce(steps: List[dict], aligned, device_ops: list, host: list, top: int = 10) -> dict:
    """The summary of one spanned pass: ``steps``, each superstep's last
    dispatch spans (``VCMModel.last_spans``); ``aligned``, the pass's
    dispatches on the profiler's clock (``profiling.Aligned``);
    ``device_ops`` and ``host``, the profiler's device operations and the
    host phases of the dispatches as (start µs, end µs, name)."""
    n = len(steps)
    names = [k for k, v in steps[0].items() if v["clock"] == DEVICE and k != "anchor"]
    per_step = {k: {"ms": sum(s[k]["ms"] for s in steps if k in s) / n,
                    "self_ms": sum(s[k]["self_ms"] for s in steps if k in s) / n,
                    "n": sum(s[k]["n"] for s in steps if k in s) / n} for k in names}

    def mean_us(name):
        count = sum(s[name]["n"] for s in steps if name in s)
        return 1e3 * sum(s[name]["ms"] for s in steps if name in s) / count if count else None

    phases = {p: sum(s[p]["ms"] for s in steps if p in s) / n for p in HOST_PHASES}
    out = {"steps": n, "spans": per_step,
           "batch_race_us": mean_us("batch.race"), "batch_resolve_us": mean_us("batch.resolve"),
           "host_phases_ms": phases,
           "dispatch_host_ms": phases["load"] + phases["launch"] + phases["unpack"]}
    top_ms = per_step.get("superstep", {}).get("ms")
    if top_ms:
        kids = sum(v["ms"] for k, v in per_step.items()
                   if steps[0][k]["parent"] == "superstep")
        out["superstep_children_pct"] = 100.0 * kids / top_ms
    loads = [s for s, _, name in host if name.endswith(".load")]
    unpacks = [e for _, e, name in host if name.endswith(".unpack")]
    if not (aligned.spans and loads and unpacks):
        return out
    lo, hi = min(loads), max(unpacks)
    width = hi - lo
    ops = _union([(s, e) for s, e, _ in device_ops])
    both = _union([(s, e) for s, e, _ in device_ops]
                  + [(s, e) for _, _, s, e, _, _ in aligned.spans])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(ops, ops[1:])
                   if a[1] >= lo and b[0] <= hi), reverse=True)[:top]
    out.update(
        window_ms=width * 1e-3,
        untraced_idle_pct=100.0 * (width - _covered(both, lo, hi)) / width,
        profiler_idle_pct=100.0 * (width - _covered(ops, lo, hi)) / width,
        longest_gaps=[[length * 1e-3, _cover((a + b) / 2, aligned.spans, host)]
                      for length, a, b in gaps],
        anchor_offsets_us=aligned.offsets_us,
        anchor_offset_spread_us=aligned.offset_spread_us,
        dispatches_aligned=len(aligned.offsets_us))
    return out


def _stamp_cost_us(dev, pairs: int = 256) -> float:
    """µs of one stamp as a graph runs it: a CUDA graph of ``pairs`` spans
    opened and closed back to back, timed by CUDA events over replays."""
    from akmc_tpu_torch.runtime import profiling

    table = profiling.SpanTable(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), profiling.spanning(table):
        for _ in range(pairs):
            with profiling.span("stamp"):
                pass
    graph.replay()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return 1e3 * start.elapsed_time(end) / (5 * 2 * pairs)


def _pass(entry, setup, traffic, seed, tag, model):
    """One pass of the mix: (each step's ``last_spans``, host seconds)."""
    tables = []
    harness.sync(model.device)
    t0 = time.perf_counter()
    for _ in entry.steps(setup, traffic, seed, tag):
        tables.append(model.last_spans)
    harness.sync(model.device)
    return tables, time.perf_counter() - t0


def passes(setup, cell: str, seed: int) -> Optional[dict]:
    """On a built cell (``setup``, its warm pass run): one pass with the
    spans off (the cost's base), then with the spans on a warm pass (the
    captures), the first pass again (the same stream: the same work) and a
    profiled pass, the spanned programs dropped afterwards; the summary
    (None where the program has no spans). ``seed`` draws the passes'
    streams."""
    from torch.profiler import ProfilerActivity, profile

    from akmc_tpu_torch.runtime import profiling

    model = setup.model
    if not hasattr(model, "last_spans"):
        return None
    traffic = harness.load("traffic", harness.cell_entry(cell)["traffic"])
    entry = harness.module("entries", traffic["entry"])
    dev = model.device
    cuda = dev.type == "cuda"
    plain, plain_s = _pass(entry, setup, traffic, seed, "spans_cost", model)
    model.spans = True
    try:
        _pass(entry, setup, traffic, seed, "spans_warm", model)
        timed, timed_s = _pass(entry, setup, traffic, seed, "spans_cost", model)
        model.spans = False       # the base again, after: the two bracket the spanned pass
        _, plain2_s = _pass(entry, setup, traffic, seed, "spans_cost", model)
        plain_s = (plain_s + plain2_s) / 2
        model.spans = True
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profiling.collecting() as dispatches, profile(activities=acts) as prof:
            steps, pass_s = _pass(entry, setup, traffic, seed, "spans", model)
    finally:
        model.spans = False
        progs = model.step_graphs.programs
        for key in [k for k, p in progs.items() if getattr(p, "spans", None) is not None]:
            del progs[key]
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    if not steps or not steps[0]:
        return None
    aligned = profiling.align(prof, dispatches)
    labels = tuple(f".{p}" for p in HOST_PHASES)
    host = [r for r in profiling.host_ranges(prof, "akmc.") if r[2].endswith(labels)]
    out = reduce(steps, aligned, profiling.device_events(prof) if cuda else [], host)
    # the host phases as a dispatch takes them unprofiled (the profiler's own
    # hooks lengthen a replay's launch several times over)
    phases = {p: sum(t[p]["ms"] for t in timed if p in t) / len(timed) for p in HOST_PHASES}
    plain_ms, timed_ms = 1e3 * plain_s / len(plain), 1e3 * timed_s / len(timed)
    out.update(host_phases_ms_profiled=out["host_phases_ms"], host_phases_ms=phases,
               dispatch_host_ms=phases["load"] + phases["launch"] + phases["unpack"],
               pass_host_ms_per_step=1e3 * pass_s / len(steps),
               spans_off_ms_per_step=plain_ms, spans_on_ms_per_step=timed_ms,
               spans_on_cost_pct=100.0 * (timed_ms / plain_ms - 1.0),
               stamps_per_step=sum(2 * v["n"] for v in out["spans"].values()))
    if cuda:
        out["stamp_us_in_graph"] = _stamp_cost_us(dev)
        out["globaltimer"] = profiling.clock_resolution_ns(dev)
    return out


def _seed(ctx) -> int:
    """The passes' streams, drawn from the run's seed through the stream of
    the window's first step."""
    return harness.mix(0, "spans", json.dumps(ctx.window.steps[0].stream, sort_keys=True))


def run(ctx) -> Optional[dict]:
    """``passes`` on the traced run's own model, in this process."""
    if ctx.model is None:
        return None
    return passes(ctx.setup, ctx.cell, _seed(ctx))


def run_apart(ctx) -> Optional[dict]:
    """``passes`` in a process of its own, on the cell built there again
    (``python3 portbench/spans.py --workload <cell> --seed <n>``): in a
    process where a ``torch.profiler`` session has ended (the traced
    window's), a CUDA graph with conditional nodes captured afterwards ends
    the next session over its replays in an illegal memory access (my chip
    run, PR 19), and the spanned programs are captured afterwards. The child
    has had no session before its own. None, with the child's last errors in
    ``measured``, if it fails."""
    if ctx.model is None or not hasattr(ctx.model, "last_spans"):
        return None
    cmd = [sys.executable, os.path.abspath(__file__), "--workload", ctx.cell,
           "--seed", str(_seed(ctx))]
    got = subprocess.run(cmd, cwd=str(harness.ROOT), capture_output=True, text=True,
                         timeout=CHILD_SECONDS)
    lines = got.stdout.strip().splitlines()
    if got.returncode != 0 or not lines:
        ctx.measured["spans_child"] = {"rc": got.returncode,
                                       "stderr": got.stderr.strip().splitlines()[-8:]}
        return None
    return json.loads(lines[-1])


def measure(ctx) -> None:
    """The spanned passes once per traced run (in a process of their own
    on a card: ``run_apart``), their summary kept in ``ctx.measured`` (the
    ``info:`` line); nothing without a card."""
    if "spans" in ctx.measured:
        return
    ctx.measured["spans"] = run_apart(ctx) if ctx.device.type == "cuda" else None


def value(ctx, key: str, span: Optional[str] = None) -> Optional[float]:
    """A number of the summary: ``key`` of it, or with ``span`` that span's
    ``key`` a superstep; None where there is none."""
    got: Optional[Dict] = ctx.measured.get("spans")
    if not got:
        return None
    if span is not None:
        got = got["spans"].get(span)
        if got is None:
            return None
    v = got.get(key)
    return None if v is None else float(v)


def main(argv=None) -> int:
    """The child of ``run_apart``: the cell built on the card, its warm pass
    run, then ``passes``; prints the summary as one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    *_, setup = harness.prepare(args.workload, args.seed, "cuda:0")
    print(json.dumps(passes(setup, args.workload, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
