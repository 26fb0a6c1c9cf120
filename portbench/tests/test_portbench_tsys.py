"""The transmission-system cell (``tsys102k.iv_set``) on the CPU at n_yz = 6:
the run comes out correct; the control, and a timed path broken underneath
(an altered element, a perturbed site power), do not; its new readers give
a value or None off the card, and their arithmetic on a hand-made summary."""

import types

import pytest
import torch

from portbench import check, control, harness, roofline, roofline_power, runner

CELL = "tsys102k.iv_set"
TINY = {"builder_args": {"n_yz": 6},
        "workload": {"check": {"steps": 2, "among_first": 2, "pair_sites": 512}}}
SEED = 2**31 + 9
READERS = ("cb_edge_device_ms", "wkb_build_device_ms", "power_solve_device_ms",
           "power_cg_iters_per_step", "power_cg_roofline", "wkb_build_roofline")


def test_the_cell_runs_correct_and_its_readers_report_off_the_card():
    out = runner.execute(CELL, SEED, 3.0, True, "cpu", overrides=TINY)
    assert out["correct"], out["checks"]
    assert out["checks"]["steps_checked"]["value"] >= 1
    assert out["checks"]["cb_res"]["value"] > 0.0
    got = out["metrics"]
    assert got["power_cg_iters_per_step"]["value"] > 0
    # the span readers have no spans off the card: nothing, not a raise
    for name in ("cb_edge_device_ms", "wkb_build_device_ms", "power_solve_device_ms",
                 "power_cg_roofline", "wkb_build_roofline"):
        assert name not in got
    # the spanned pass's work: its six supersteps, each on its own state
    steps = out["_info"]["measured"]["power_work"]["steps"]
    assert len(steps) == 6 and all(s["iterations"] > 0 for s in steps)
    assert all(s["power"]["nv"] > 0 and s["power"]["nc"] > 0 for s in steps)
    assert all(s["terms"]["ct"] > s["terms"]["cc"] > 0 for s in steps)


def _broken(monkeypatch, fault):
    from akmc_tpu_torch.models.vcm import VCMModel

    real = VCMModel.superstep_full

    def step(self, state, *args, **kw):
        new, stats, m = real(self, state, *args, **kw)
        if fault == "element":
            element = new.element.clone()
            element[int(torch.nonzero(element == 3)[0])] = 2
            return new.replace(element=element), stats, m
        power = new.power.clone()
        i = int(torch.argmax(power.abs()))
        power[i] = power[i] * (1.0 + 1e-6)
        return new.replace(power=power), stats, m

    monkeypatch.setattr(VCMModel, "superstep_full", step)


@pytest.mark.parametrize("fault", ["element", "power"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    out = runner.execute(CELL, SEED, 0.5, False, "cpu", overrides=TINY)
    assert not out["correct"], out["checks"]
    bad = "power_err" if fault == "power" else "elem_mm"
    assert out["checks"][bad]["value"] > out["checks"][bad]["limit"]


def test_the_control_is_not_correct():
    got = control.readings(CELL, 7, 0.5, "cpu", TINY)
    limits = harness.load("workloads", CELL)["limits"]
    prog_ok, _ = check.verdict(got["program"], limits, got["steps_checked"])
    ctrl_ok, _ = check.verdict(got["control"], limits, got["steps_checked"])
    assert prog_ok and not ctrl_ok, got
    assert got["control_dtypes"] == {k: "torch.float32" for k in ("k", "pair", "events",
                                                                    "current")}


def test_the_spanned_pass_carries_each_bias_cb_edge_in_its_first_superstep(monkeypatch):
    """With spans on, the entry hands a bias's first superstep the ``cb_edge``
    span of the CB edge solved before it, outside the superstep's span; the
    other supersteps carry none; a program without the span carries nothing."""
    from akmc_tpu_torch.models.vcm import VCMModel

    config, setup = _tiny_setup()
    traffic = harness.load("traffic", "iv_set")
    entry = harness.module("entries", traffic["entry"])
    model = setup.model
    model.spans = True
    tables, cb_tables = [], []
    real_cb = VCMModel.update_cb_edge

    def cb_edge(self, state, Vd):
        out = real_cb(self, state, Vd)
        cb_tables.append(dict(self.last_spans))
        return out

    monkeypatch.setattr(VCMModel, "update_cb_edge", cb_edge)
    for _ in entry.steps(setup, traffic, SEED, "spans"):
        tables.append(model.last_spans)
    per_bias = int(traffic["supersteps_per_bias"])
    assert len(cb_tables) == 2 and len(tables) == 2 * per_bias
    for k, table in enumerate(tables):
        if k % per_bias:
            assert "cb_edge" not in table
            continue
        cb = cb_tables[k // per_bias]["cb_edge"]
        assert cb["parent"] == "superstep" and cb["n"] == 1
        assert table["cb_edge"] == {**cb, "parent": None}
        assert table["superstep"]["start_ns"] >= cb["end_ns"]

    def bare(self, state, Vd):
        out = real_cb(self, state, Vd)
        self.last_spans = {k: v for k, v in self.last_spans.items() if k != "cb_edge"}
        return out

    monkeypatch.setattr(VCMModel, "update_cb_edge", bare)
    assert not any("cb_edge" in model.last_spans
                   for _ in entry.steps(setup, traffic, SEED, "spans"))


def _tiny_setup():
    config = harness.load("configs", "tsys102k")
    config["builder_args"] = {**config["builder_args"], **TINY["builder_args"]}
    return config, harness.module("builders", config["builder"]).build(
        config, "cpu", config["model"], {})


def test_readers_on_a_hand_made_summary():
    counts = {"n": 1000, "nnz": 9000, "nv": 10, "nc": 100}
    work = {"steps": [
        {"iterations": 30, "power": counts, "terms": {"tt": 45.0, "cc": 4950.0, "ct": 20000.0}},
        {"iterations": 50, "power": counts, "terms": {"tt": 45.0, "cc": 4950.0, "ct": 30000.0}}]}
    steps = [harness.Step(i, i // 3, 1.0, {"power_cg_iterations": it}, 7.0, {})
             for i, it in enumerate([100, 10, 10, 50, 10, 10, 100])]
    ctx = types.SimpleNamespace(
        measured={"power_work": work, "spans": {"spans": {
            "cb_edge": {"ms": 2.0, "n": 1 / 3}, "wkb_build": {"ms": 40.0, "n": 1.0},
            "power_solve": {"ms": 8.0, "n": 1.0}}}},
        window=types.SimpleNamespace(steps=steps, passes=3))
    read = {name: runner.metric_module(name).read(ctx) for name in READERS}
    assert read["cb_edge_device_ms"] == pytest.approx(6.0)
    assert read["wkb_build_device_ms"] == 40.0 and read["power_solve_device_ms"] == 8.0
    assert read["power_cg_iters_per_step"] == pytest.approx(290 / 7)
    # the spanned pass's own iterations (40 a step) and terms over its spans
    bytes_ = 8.0 * (100 + 1000 + 10000) + 9000 + 56.0 * 1000
    least = 40 * max(bytes_ / roofline.PEAK_HBM_BYTES,
                     (2.0 * 10100 + 4.0 * 1000 + 18000 + 12000) / roofline.PEAK_F64_FLOPS)
    assert read["power_cg_roofline"] == pytest.approx(100.0 * least / 8e-3)
    assert read["wkb_build_roofline"] == pytest.approx(
        100.0 * roofline_power.TERM_FLOPS * 29995.0 / roofline.PEAK_F64_FLOPS / 40e-3)
    ctx.measured = {}
    assert all(runner.metric_module(name).read(ctx) is None for name in READERS
               if name != "power_cg_iters_per_step")
