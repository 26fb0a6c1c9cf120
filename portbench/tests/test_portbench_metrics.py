"""The metric arithmetic on hand-made windows and a hand-counted operator."""

import types

import pytest
import torch

from portbench import harness, roofline, runner


def _ctx(seconds, step_seconds, stats):
    steps = [harness.Step(i, 0, s, st, 1.0, {}) for i, (s, st) in enumerate(zip(step_seconds, stats))]
    window = types.SimpleNamespace(steps=steps, seconds=seconds)
    return types.SimpleNamespace(window=window, recorder=None, device=torch.device("cpu"),
                                 measured={}, ref=None, setup_s=12.5,
                                 setup=types.SimpleNamespace(parts={"structure_s": 1.0,
                                                                    "lattice_s": 0.5,
                                                                    "model_s": 2.0,
                                                                    "warmup_s": 3.0,
                                                                    "warm_pass_s": 0.25}))


def test_rates_are_over_the_whole_window():
    ctx = _ctx(10.0, [2.0, 3.0, 4.0, 0.5],
               [{"n_events": 100, "n_batches": 4, "cg_iterations": 10}] * 4)
    assert runner.metric_module("step_ms").read(ctx) == pytest.approx(2500.0)
    # 400 events over 10 s, not over the 9.5 s the steps' own clocks add up to
    assert runner.metric_module("events_per_s").read(ctx) == pytest.approx(40.0)
    assert runner.metric_module("events_per_batch").read(ctx) == pytest.approx(25.0)
    assert runner.metric_module("k_solve_iters_per_step").read(ctx) == pytest.approx(10.0)
    assert runner.metric_module("setup_s").read(ctx) == 12.5
    assert runner.metric_module("setup_structure_s").read(ctx) == pytest.approx(3.5)
    assert runner.metric_module("setup_warmup_s").read(ctx) == pytest.approx(3.25)


def test_metrics_with_nothing_to_read_return_none():
    ctx = _ctx(1.0, [1.0], [{"n_events": 1}])
    for name in ("events_per_batch", "host_reads_per_step", "dispatch_gap_pct",
                 "pairwise_ms", "k_solve_roofline"):
        assert runner.metric_module(name).read(ctx) is None


def test_roofline_count_on_a_small_operator():
    # a chain of 6 sites, contacts of one site each side: rows 1..4 are the
    # interface; interface-interface neighbor pairs (1,2),(2,3),(3,4) both ways
    nbr = torch.tensor([[1, -1], [0, 2], [1, 3], [2, 4], [3, 5], [4, -1]])
    n_rows, nnz = roofline.k_solve_nnz(nbr, 1)
    assert (n_rows, nnz) == (4, 4 + 6)
    flops = 2 * 10 + 12 * 4
    bytes_ = 10 + 7 * 8 * 4
    want = max(flops / 34e12, bytes_ / 3.35e12)
    assert roofline.k_iteration_least_s(n_rows, nnz) == pytest.approx(want)
    assert roofline.k_solve_least_s(nbr, 1, 7) == pytest.approx(7 * want)


def test_dispatch_gap_share_from_event_pairs():
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    ev = [(Ev(0.0), Ev(4.0)), (Ev(5.0), Ev(9.0)), (Ev(10.0), Ev(10.0))]
    ctx = types.SimpleNamespace(recorder=types.SimpleNamespace(events=ev))
    assert runner.metric_module("dispatch_gap_pct").read(ctx) == pytest.approx(20.0)
