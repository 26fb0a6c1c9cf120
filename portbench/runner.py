"""One run of a cell: set-up, the window, the traced run's readings, the
check, and the result line's fields."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import torch

from portbench import check, harness, timing


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    cell: str
    device: torch.device
    setup: object
    window: object
    setup_s: float
    recorder: object = None
    model: object = None
    last_state: object = None
    last_Vd: float = 0.0
    ref: object = None
    measured: dict = dataclasses.field(default_factory=dict)


def metric_module(name: str):
    return harness.module("metrics", name)


def metrics_for(cell: str, trace: bool) -> list:
    """The manifest's metrics that a cell reports in this kind of run: the
    end-to-end ones with ``--trace 0``, the per-layer ones with ``--trace
    1``; a metric without ``workloads`` in every cell that reports the
    metric it ``moves``."""
    m = harness.manifest()
    e2e = [x for x in m["end_to_end"] if cell in x.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {x["name"] for x in e2e}
    return [x for x in m["per_layer"]
            if cell in x.get("workloads", [cell] if x["moves"] in names else [])]


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            overrides: Optional[dict] = None, t_start: Optional[float] = None) -> dict:
    """The result line's fields and the numbers compared (``checks``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    entry, config, traffic, work, setup = harness.prepare(cell, seed, device, overrides)
    setup.physics = {**setup.physics, "rate_normalize": bool(config["model"]["rate_normalize"])}
    dev = setup.model.device
    sample_at = harness.sample_indices(seed, work["check"])
    recorder = harness.Recorder(dev, int(work["profile_steps"])) if trace else None
    setup_s = time.perf_counter() - t_start
    if recorder is None:
        window = harness.run_window(setup, traffic, seed, seconds, sample_at)
    else:
        with recorder:
            window = harness.run_window(setup, traffic, seed, seconds, sample_at, recorder)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    ctx = Context(cell, dev, setup, window, setup_s, recorder)
    wanted = [(x, metric_module(x["name"])) for x in metrics_for(cell, trace)]
    if trace:
        ctx.model, ctx.last_state, ctx.last_Vd = setup.model, window.last_post, window.last_Vd
        for _, mod in wanted:
            if hasattr(mod, "measure"):
                mod.measure(ctx)
        ctx.model = ctx.last_state = None
    # the program's state is freed before the reference runs
    window.last_post = None
    setup.model = setup.state0 = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = check.Reference(setup.structure, setup.physics, dev)
    sites = check.pair_sites(ref, harness.mix(seed, "sites"), int(work["check"]["pair_sites"]))
    nums = check.compare(ref, harness.module("entries", traffic["entry"]), traffic,
                         window.samples, sites)
    correct, checks = check.verdict(nums, work["limits"], len(window.samples))
    ctx.ref = ref
    check_s = time.perf_counter() - t_check

    metrics = {}
    for spec, mod in wanted:
        value = mod.read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(entry["chips"]),
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(correct), "attempted": len(window.steps), "failed": 0,
           "metrics": metrics, "device": dev_info}
    if trace and recorder.prof is not None:
        red = timing.reduce_profile(recorder.prof)
        if red:
            dev_info["busy_s"] = red["busy_s"]
            dev_info["window_s"] = recorder.prof_s
            out["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    out["checks"] = checks
    out["_info"] = {"passes": window.passes, "setup_parts": {
        k: v for k, v in setup.parts.items() if isinstance(v, float)},
        "warmup_parts": setup.parts.get("warmup_parts"), "measured": ctx.measured,
        "check_s": check_s, "window_s": window.seconds, "steps": len(window.steps)}
    return out
