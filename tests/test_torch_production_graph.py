"""The production supersteps as one program each (``models/step_program.py::
ProductionProgram``), drawing from ``akmc_tpu``'s threefry key, on the CPU.

On a card ``superstep_native`` and ``superstep_native_batched`` on a
``KeyDraws`` source are one CUDA graph each, their event loop a conditional
while node that draws inside its body (``csrc/threefry.cu``); here the same
body runs eagerly. Held here:

* the program against the per-loop path (``step_program=False``) and against
  the plain host loops on the same fields, bit for bit (state, stats, the key
  left behind), with k = 1 and 3 steps a pass, f64 and f32 clocks, and
  ``k_extrap`` 0 and 0.5;
* a cap below the population redone from the same key: the same draws;
* the port's loops on ``akmc_tpu``'s fields, from the same key, against
  ``akmc_tpu``'s ``run_event_loop_batched`` and ``run_event_loop_native``:
  events, batches and cuts exact, waiting times within 1e-12 (f64 clocks)
  and 1e-6 (f32), the bounds of ``test_batched_loop_replays_akmc_tpu``;
  and the production supersteps of the two packages side by side;
* both drivers' ``--batched-events 8`` sweeps at ``--synthesize-crossbar 6``:
  rows and final elements equal, KMC times within the sweep golden's rtol.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
# one PyTorch thread in a process that runs JAX (ROADMAP §3, "CPU test flake")
torch.set_num_threads(1)

from akmc_tpu.models.vcm import VCMModel as JModel  # noqa: E402
from akmc_tpu.ops import events as jev  # noqa: E402
from akmc_tpu.state import make_device_state as j_state  # noqa: E402
from akmc_tpu_torch import convert  # noqa: E402
from akmc_tpu_torch.models.vcm import VCMModel as TModel  # noqa: E402
from akmc_tpu_torch.ops import device_loop  # noqa: E402
from akmc_tpu_torch.ops import events as tev  # noqa: E402
from akmc_tpu_torch.ops import threefry  # noqa: E402
from akmc_tpu_torch.ops.threefry import KeyDraws  # noqa: E402
from akmc_tpu_torch.runtime import golden  # noqa: E402
from tests.test_torch_events_batched import _toy_frozen  # noqa: E402
from tests.test_torch_fields import _toy  # noqa: E402

DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "decks",
                    "iv_sweep_5nm.txt")
FIELDS = ("element", "charge", "potential_boundary", "potential_charge", "kmc_time")
BIASES = (2.0, 2.0, 3.0)
GOLDEN_KMC_RTOL = 2.78e-4    # the sweep golden's bound (chip_smoke.py, PERF.md §2)


def _port(p, lat, **kw):
    return TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)


def _drive(model, lat, p, batch, seed=11, **kw):
    """Production supersteps at BIASES on a fresh key: (states, stats, the
    key left behind), the batched ones carrying ``pb_prev2``. Every state is
    kept as returned: a later superstep must not write into an earlier's."""
    state = convert.state(j_state(lat, p.background_temp))
    draws = KeyDraws.seeded(seed, "cpu")
    states, stats, pb_prev2 = [], [], None
    for Vd in BIASES:
        if batch:
            pb_before = state.potential_boundary
            state, st = model.superstep_native_batched(state, Vd, draws, batch=batch,
                                                       pb_prev2=pb_prev2, **kw)
            pb_prev2 = pb_before
        else:
            state, st = model.superstep_native(state, Vd, draws)
        states.append(state)
        stats.append(st)
    return states, stats, draws.key.tolist()


def _same(a, b):
    for sa, sb in zip(a[0], b[0]):
        for name in FIELDS:
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    assert a[1] == b[1]
    assert a[2] == b[2]


CASES = {
    "native": (0, {}),
    "batched": (8, {}),
    "batched-f32-clocks": (8, dict(clock_f32=True, mass_eps=0.1)),
    "batched-k-extrap": (8, dict(k_extrap=0.5)),
}


@pytest.mark.parametrize("node_k", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_per_loop_path(monkeypatch, case, node_k):
    """The program and the per-loop path, from one key: the same supersteps
    to the bit, the same key left behind; one program run per superstep."""
    batch, kw = CASES[case]
    monkeypatch.setattr(tev, "BATCHED_NODE_K", node_k)
    monkeypatch.setattr(tev, "SERIAL_NODE_K", node_k)
    p, lat = _toy()
    loops, prog = _port(p, lat, step_program=False), _port(p, lat)
    a, b = _drive(loops, lat, p, batch, **kw), _drive(prog, lat, p, batch, **kw)
    _same(a, b)
    assert sum(s["n_events"] for s in b[1]) >= len(BIASES)
    assert prog.step_counts["runs"] == len(BIASES) and prog.step_counts["per_loop"] == 0
    assert loops.step_counts["per_loop"] == len(BIASES) and loops.step_counts["runs"] == 0


@pytest.mark.parametrize("batch,clock_f32", [(0, False), (8, False), (8, True)],
                         ids=["native", "batched", "batched-f32-clocks"])
def test_program_equals_the_plain_loops(batch, clock_f32):
    """One superstep through the program against the fields and the plain
    host loop, drawn as akmc_tpu draws them: ``key, sub = split(key)``, the
    loop on ``sub``."""
    p, lat = _toy()
    model = _port(p, lat)
    state = convert.state(j_state(lat, p.background_temp))
    draws = KeyDraws.seeded(3, "cpu")
    t = model.tables
    fr = model.fields(state, 2.0)
    plain_draws = KeyDraws(draws.key.clone())
    sub = plain_draws.split()
    if batch:
        res = tev.run_event_loop_batched_plain(
            state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, sub, p.freq,
            batch=batch, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S,
            clock_f32=clock_f32)
        new, st = model.superstep_native_batched(state, 2.0, draws, batch=batch,
                                                 clock_f32=clock_f32)
        assert (st["n_batches"], st["n_cut_conflict"], st["n_cut_mass"], st["done"]) == (
            res.n_batches, res.n_cut_conflict, res.n_cut_mass, res.done)
    else:
        res = tev.run_event_loop_native_plain(
            state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, sub, p.freq,
            act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S, zero_rows=t.act_zero_rows)
        new, st = model.superstep_native(state, 2.0, draws)
    assert st["n_events"] == res.n_events >= 1
    assert st["event_time"] == res.event_time_h
    assert torch.equal(new.element, res.element) and torch.equal(new.charge, res.charge)
    assert torch.equal(new.potential_boundary, fr.potential_boundary)
    assert draws.key.tolist() == plain_draws.key.tolist()


@pytest.mark.parametrize("batch", [0, 8], ids=["native", "batched"])
@pytest.mark.parametrize("caps", [dict(vmax=8), dict(qmax=8)], ids=["vmax", "qmax"])
def test_a_small_cap_is_redone_from_the_same_key(caps, batch):
    """A cap below the population is flagged by the program's one read; the
    cap doubles and the superstep is redone from the same key: the roomy
    model's trajectory and key."""
    p, lat = _toy(cfg=(10, 4, 4, 2, 0.2, 5))          # 19 vacancies
    roomy, small = _port(p, lat), _port(p, lat, **caps)
    a, b = _drive(roomy, lat, p, batch), _drive(small, lat, p, batch)
    _same(a, b)
    name, cap = next(iter(caps.items()))
    assert getattr(small, name) >= 2 * cap
    assert small.step_counts["redos"] >= 1 and roomy.step_counts["redos"] == 0
    caps_now = (small.qmax, small.vmax, small.pair_cand_cap)
    assert all(key[3:6] == caps_now for key in small.step_graphs.programs)


def _words(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("clock_f32", [False, True], ids=["f64-clocks", "f32-clocks"])
@pytest.mark.parametrize("mass_eps", [1e-3, 0.1])
@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("shifted", [False, True], ids=["toy", "toy-shifted"])
def test_batched_loop_on_akmc_tpus_key(shifted, B, mass_eps, clock_f32):
    """``run_event_loop_batched`` (device loop and plain loop) on akmc_tpu's
    fields and key against akmc_tpu's loop: the same events, batches and
    cuts, elements and zero pattern, waiting time within 1e-12 (f32 clocks
    1e-6), and the key moved on by the live batches alone."""
    p, lat, jm, js, fr = _toy_frozen(shifted)
    t, tt, tf = jm.tables, convert.tables(jm.tables), convert.fields(fr)
    key = jax.random.PRNGKey(1000 * B + int(clock_f32))
    rj = jev.run_event_loop_batched(
        js.element, fr.charge, fr.P, fr.etype, t.act_neigh, key, p.freq, batch=B,
        mass_eps=mass_eps, clock_f32=clock_f32, act_idx=t.act_idx, abs2act=t.abs2act,
        ln_S=fr.ln_S)
    for loop in (tev.run_event_loop_batched, tev.run_event_loop_batched_plain):
        draws = KeyDraws(_words(key))
        rt = loop(torch.from_numpy(np.array(js.element)), tf.charge, tf.P.clone(), tf.etype,
                  tt.act_neigh, draws, p.freq, batch=B, mass_eps=mass_eps,
                  clock_f32=clock_f32, act_idx=tt.act_idx, abs2act=tt.abs2act, ln_S=tf.ln_S)
        np.testing.assert_array_equal(rt.element.numpy(), np.asarray(rj.element))
        np.testing.assert_array_equal(rt.charge.numpy(), np.asarray(rj.charge))
        np.testing.assert_array_equal(rt.P.numpy() == 0.0, np.asarray(rj.P) == 0.0)
        assert (rt.n_events, rt.n_batches, rt.n_cut_conflict, rt.n_cut_mass, rt.done) == (
            int(rj.n_events), int(rj.n_batches), int(rj.n_cut_conflict), int(rj.n_cut_mass),
            bool(rj.done))
        assert float(rt.event_time) == pytest.approx(float(rj.event_time),
                                                     rel=1e-6 if clock_f32 else 1e-12)
        want = _words(key)
        for _ in range(rt.n_batches):
            want = threefry.split(want, 3)[0]
        assert draws.key.tolist() == want.tolist()
        assert rt.n_events >= 1 and rt.done


@pytest.mark.parametrize("shifted", [False, True], ids=["toy", "toy-shifted"])
def test_native_loop_on_akmc_tpus_key(shifted):
    """``run_event_loop_native`` (device loop and plain loop) on akmc_tpu's
    fields and key against akmc_tpu's: the same events and elements,
    waiting time within 1e-12."""
    p, lat, jm, js, fr = _toy_frozen(shifted)
    t, tt, tf = jm.tables, convert.tables(jm.tables), convert.fields(fr)
    key = jax.random.PRNGKey(77)
    rj = jev.run_event_loop_native(js.element, fr.charge, fr.P, fr.etype, t.act_neigh, key,
                                   p.freq, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S)
    for loop in (tev.run_event_loop_native, tev.run_event_loop_native_plain):
        rt = loop(torch.from_numpy(np.array(js.element)), tf.charge, tf.P.clone(), tf.etype,
                  tt.act_neigh, KeyDraws(_words(key)), p.freq, act_idx=tt.act_idx,
                  abs2act=tt.abs2act, ln_S=tf.ln_S, zero_rows=tt.act_zero_rows)
        np.testing.assert_array_equal(rt.element.numpy(), np.asarray(rj.element))
        np.testing.assert_array_equal(rt.charge.numpy(), np.asarray(rj.charge))
        assert rt.n_events == int(rj.n_events) >= 1 and rt.done == bool(rj.done)
        assert float(rt.event_time) == pytest.approx(float(rj.event_time), rel=1e-12)


@pytest.mark.parametrize("batch", [0, 8], ids=["native", "batched"])
def test_production_supersteps_match_akmc_tpu(batch):
    """The two packages' production supersteps from one key on the toy
    device: events (and batches and cuts) and elements equal, the key in
    step, KMC times within 1e-6 (the bound of tests/test_torch_fields.py:
    the K-CG fixes the fields only to its stop tolerance)."""
    p, lat = _toy()
    jm, tm = JModel(p, lat), _port(p, lat)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    key, draws = jax.random.PRNGKey(21), KeyDraws.seeded(21, "cpu")
    for Vd in BIASES:
        if batch:
            js, a, key = jm.superstep_native_batched(js, Vd, key, batch=batch)
            ts, b = tm.superstep_native_batched(ts, Vd, draws, batch=batch)
            assert (b["n_batches"], b["n_cut_conflict"], b["n_cut_mass"]) == (
                a["n_batches"], a["n_cut_conflict"], a["n_cut_mass"])
        else:
            js, a, key = jm.superstep_native(js, Vd, key)
            ts, b = tm.superstep_native(ts, Vd, draws)
        assert b["n_events"] == a["n_events"] >= 1
        assert b["event_time"] == pytest.approx(a["event_time"], rel=1e-6)
        assert draws.key.tolist() == _words(key).tolist()
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
    assert float(ts.kmc_time) == pytest.approx(float(js.kmc_time), rel=1e-6)


def test_drivers_batched_sweep_n6(tmp_path):
    """Both drivers with ``--batched-events 8`` on the whole n_yz = 6 sweep:
    superstep count, every row's events, batches and cuts, and the final
    elements equal; KMC times within the sweep golden's rtol."""
    from akmc_tpu.runtime import driver as jdriver
    from akmc_tpu_torch.runtime import driver as tdriver

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdriver.run(DECK, workdir=str(jdir), synthesize_crossbar=6, batched_events=8, log=False)
    summary = tdriver.run(DECK, workdir=str(tdir), synthesize_crossbar=6, batched_events=8,
                          device="cpu", log=False)
    rj, rt = golden.summarize(str(jdir)), golden.summarize(str(tdir))
    assert golden.compare(rj, rt, GOLDEN_KMC_RTOL) == []
    rows = []
    for d in (jdir, tdir):
        with open(d / "metrics.jsonl") as f:
            rows.append([{k: r[k] for k in ("bias", "n_events", "n_batches", "n_cut_conflict",
                                            "n_cut_mass")}
                         for r in map(json.loads, filter(str.strip, f))])
    assert rows[0] == rows[1] and len(rows[1]) == summary["total_steps"]
    assert sum(r["n_events"] for r in rows[1]) >= len(rows[1])


@pytest.mark.parametrize("batch", [0, 8], ids=["native", "batched"])
def test_production_body_reads_nothing(batch, monkeypatch):
    """The program's body, threefry draws included, under the dispatch mode
    of tests/test_torch_superstep_graph.py that refuses every host read but
    a while loop's read of its flag (on a card the node's condition): the
    diagnostics a run reads."""
    from tests.test_torch_superstep_graph import _NoReads

    p, lat = _toy()
    model = _port(p, lat)
    state = convert.state(j_state(lat, p.background_temp))
    prog = model._production_program(state, batch, False)
    key = threefry.prng_key(4)
    prog.load(state, 2.0, key)
    _, diag = prog.run()
    assert diag[3] == 1.0 and diag[0] > 0

    def refuse(*args, **kwargs):
        raise AssertionError("a host read in the superstep's body")

    prog.load(state, 2.0, key)
    guard = _NoReads()
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", refuse)
        m.setattr(torch.Tensor, "tolist", refuse)
        with guard, device_loop.recording(device_loop.Recording()):
            _, stats = prog.body()
    assert guard.flag_reads > 0
    assert stats.tolist()[: len(diag)] == diag
    # the body leaves its inputs as they were (a capture runs it twice before
    # the first dispatch): a run without a new load gives the same superstep
    assert prog.run()[1] == diag
