"""The span readers (``portbench/spans.py``, ``metrics/*_device_ms.py`` and
the rest): the reduction of a spanned pass on hand-made spans and traces,
the spanned passes of the crossbar cell at a test size on the CPU, and
nothing read from a program without spans or from a run without a card."""

import types

import pytest
import torch

from conftest import TINY
from portbench import harness, runner, spans

READERS = ("superstep_device_ms", "k_solve_device_ms", "pairwise_device_ms",
           "event_loop_device_ms", "batch_race_us", "batch_resolve_us", "untraced_idle_pct",
           "dispatch_host_ms")


def _span(ms, n=1, parent="superstep", clock="device"):
    return {"ms": ms, "self_ms": ms, "n": n, "parent": parent, "clock": clock,
            "start_ns": 0, "end_ns": 0}


def _step(race_ms, resolve_ms, batches):
    s = {"superstep": _span(10.0, parent=None), "k_solve": _span(1.0),
         "pairwise": _span(4.0), "event_loop": _span(4.9),
         "batch.race": _span(race_ms, batches, "event_loop"),
         "batch.resolve": _span(resolve_ms, batches, "event_loop"),
         "anchor": _span(0.0, parent=None)}
    for phase, ms in zip(("load", "launch", "read", "unpack"), (0.1, 0.05, 9.0, 0.2)):
        s[phase] = _span(ms, parent=None, clock="host")
    return s


def test_reduce_on_hand_made_spans():
    """Means a superstep and a batch, children's share, host phases; on the
    profile clock the untraced idle share counts only what neither the
    profiler nor a span covers, and each long gap is named by the span open
    across it, else by the host phase."""
    from akmc_tpu_torch.runtime.profiling import Aligned

    steps = [_step(2.0, 1.0, 10), _step(4.0, 1.0, 30)]
    aligned = Aligned([("superstep", None, 10.0, 60.0, 1, 0),
                       ("event_loop", "superstep", 30.0, 55.0, 1, 0),
                       ("batch.race", "event_loop", 31.0, 54.0, 10, 0)], [1.0])
    ops = [(10.0, 20.0, "k"), (25.0, 30.0, "k"), (58.0, 60.0, "k"), (66.0, 67.0, "copy")]
    host = [(5.0, 8.0, "akmc.production.load"), (8.0, 9.0, "akmc.production.launch"),
            (9.0, 62.0, "akmc.production.read"), (62.0, 70.0, "akmc.production.unpack")]
    out = spans.reduce(steps, aligned, ops, host)
    assert out["spans"]["superstep"]["ms"] == 10.0 and out["spans"]["batch.race"]["n"] == 20
    assert out["batch_race_us"] == pytest.approx(1e3 * 6.0 / 40)
    assert out["batch_resolve_us"] == pytest.approx(1e3 * 2.0 / 40)
    assert out["superstep_children_pct"] == pytest.approx(99.0)
    assert out["dispatch_host_ms"] == pytest.approx(0.35)
    # window 5..70 µs: ops and spans cover 10..60 and 66..67
    assert out["untraced_idle_pct"] == pytest.approx(100.0 * (65 - 51) / 65)
    assert out["profiler_idle_pct"] == pytest.approx(100.0 * (65 - 18) / 65)
    assert out["longest_gaps"][0] == [pytest.approx(0.028), "event_loop"]
    assert out["longest_gaps"][1] == [pytest.approx(0.006), "akmc.production.unpack"]
    assert out["longest_gaps"][2] == [pytest.approx(0.005), "superstep"]


def _tiny_run():
    """The crossbar cell at its test size on the CPU, traced: (context as
    the readers see it before the check, the setup)."""
    cell = "crossbar40.batched"
    entry, config, traffic, work, setup = harness.prepare(cell, 2**31 + 9, "cpu", TINY[cell])
    window = harness.run_window(setup, traffic, 2**31 + 9, 0.2, set())
    ctx = runner.Context(cell, setup.model.device, setup, window, 1.0, None,
                         model=setup.model, last_state=window.last_post)
    return ctx, setup


def test_spanned_passes_at_a_test_size():
    """The spanned passes on the CPU, in this process: the batched
    superstep's spans a superstep (a batch's race and resolution once a
    batch), the spanned programs dropped and the spans off afterwards; a
    card's numbers (the profile clock, the idle shares) are not made up on
    the CPU, and the readers read nothing there."""
    ctx, setup = _tiny_run()
    before = len(setup.model.step_graphs.programs)
    got = spans.run(ctx)
    assert setup.model.spans is False and len(setup.model.step_graphs.programs) == before
    names = set(got["spans"])
    assert {"superstep", "charge", "k_solve", "pairwise", "rates", "key_split", "event_loop",
            "batch.race", "batch.resolve"} == names
    assert got["spans"]["batch.race"]["n"] == got["spans"]["batch.resolve"]["n"] > 0
    assert got["spans"]["k_solve"]["n"] == 1 and got["steps"] == 6
    assert 90.0 <= got["superstep_children_pct"] <= 100.0
    assert "untraced_idle_pct" not in got and "globaltimer" not in got
    assert got["spans_off_ms_per_step"] > 0 and got["spans_on_ms_per_step"] > 0
    spans.measure(ctx)
    assert ctx.measured["spans"] is None
    for name in READERS:
        assert runner.metric_module(name).read(ctx) is None


def test_a_program_without_spans_gives_nothing():
    """A program that predates spans (no ``last_spans``): no pass, no child
    process, no value."""
    old = object()
    ctx = types.SimpleNamespace(model=old, measured={}, device=torch.device("cuda"),
                                setup=types.SimpleNamespace(model=old), cell="crossbar40.batched")
    assert spans.run_apart(ctx) is None and "spans_child" not in ctx.measured
    assert spans.passes(ctx.setup, ctx.cell, 1) is None
    ctx.measured["spans"] = None
    for name in READERS:
        assert runner.metric_module(name).read(ctx) is None


def test_readers_read_their_numbers():
    ctx = types.SimpleNamespace(measured={"spans": {
        "spans": {"superstep": {"ms": 360.0}, "k_solve": {"ms": 12.0},
                  "pairwise": {"ms": 180.0}, "event_loop": {"ms": 165.0}},
        "batch_race_us": 150.0, "batch_resolve_us": 250.0, "untraced_idle_pct": 0.4,
        "dispatch_host_ms": 0.5}})
    want = [360.0, 12.0, 180.0, 165.0, 150.0, 250.0, 0.4, 0.5]
    assert [runner.metric_module(n).read(ctx) for n in READERS] == want
