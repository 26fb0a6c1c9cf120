"""The deck modes and the per-bias CB edge as one program each
(``models/step_program.py``: ``FieldsProgram``, ``EventsOnlyProgram``,
``CbEdgeProgram``), on the CPU.

``VCMModel.fields_only``, ``superstep_events_only`` and ``update_cb_edge`` run
as one program a call with one read of a packed vector, as ``akmc_tpu`` runs
``_fields_jit``, ``_events_only_jit`` and ``_cb_jit``; their loops are while
loops (on a card conditional while nodes of one CUDA graph; here the same
body, eagerly). Held here, on the toy device and a grid-native crossbar at
n_yz = 6:

* each program against the per-loop path (``step_program=False``) bit for
  bit: state, stats, the stream, K solves and their iterations, the CG
  loops' counts; the events-only step (on ``akmc_tpu``'s fields at 8 V) at
  the default window and at a window of 4 draws that runs out (continued in
  events-only chunks), the fields with a vmax below the vacancies (redone
  at the doubled cap);
* each against ``akmc_tpu``'s ``fields_only``, ``superstep_events_only`` and
  ``update_cb_edge`` at the bounds of tests/test_torch_driver_modes.py and
  tests/test_torch_current.py;
* each body reads nothing back and makes no tensor from host data.
"""

import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.vcm import RAND_CHUNK
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops import device_loop
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from tests.test_torch_fields import _toy
from tests.test_torch_full_program import _NoReads

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

STATE = ("element", "charge", "potential_boundary", "potential_charge", "kmc_time",
         "cb_edge")
BIASES = (2.0, 3.0, 3.0)
EVENTS_VD = 8.0             # the events-only steps' stale fields: akmc_tpu's at this bias
KMC_RTOL = 1e-12            # tests/test_torch_driver_modes.py


def _structure(name):
    if name == "toy":
        return _toy()
    return build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                               defect_fraction=0.3, vacancy_concentration=0.1, seed=3)


_STALE = {}


def _start(p, lat, kind, name):
    """akmc_tpu's initial state; for the events-only step the state after
    akmc_tpu's ``fields_only`` at EVENTS_VD, whose stale potential fires
    several events a superstep (on the zero potential one fires one)."""
    js = j_state(lat, p.background_temp)
    if kind != "events_only":
        return js
    if name not in _STALE:
        _STALE[name] = JModel(p, lat).fields_only(js, EVENTS_VD)[0]
    return _STALE[name]


def _port(p, lat, **kw):
    return TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (NaN compares equal to the same NaN): the crossbar's CB
    edge is NaN on the interface in both packages."""
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _drive(model, js, kind, chunk=RAND_CHUNK):
    """Three calls of ``kind`` at BIASES from akmc_tpu's state ``js``:
    (state, stats, the stream's next draw, K solves, K iterations, CG counts
    after each call, CB-edge iterations)."""
    state = convert.state(js)
    stream = TStream(TRNG(1))
    stats, cg, cb = [], [], []
    for Vd in BIASES:
        if kind == "fields":
            state, st = model.fields_only(state, Vd)
        elif kind == "events_only":
            state, st = model.superstep_events_only(state, stream, rand_chunk=chunk)
        else:
            state, st = model.update_cb_edge(state, Vd), {}
            cb.append(model.cb_iterations)
        stats.append(st)
        cg.append(dict(model.cg_step_counts))
    return state, stats, stream.peek(1)[0], model.k_solves, model.k_iterations, cg, cb


CASES = {
    "fields-toy": ("fields", "toy", {}, RAND_CHUNK),
    "fields-crossbar": ("fields", "crossbar", {}, RAND_CHUNK),
    "fields-toy-banded": ("fields", "toy", dict(use_dia_k=False), RAND_CHUNK),
    "fields-toy-redo": ("fields", "toy", dict(vmax=8), RAND_CHUNK),
    "events-toy": ("events_only", "toy", {}, RAND_CHUNK),
    "events-crossbar": ("events_only", "crossbar", {}, RAND_CHUNK),
    "events-toy-window4": ("events_only", "toy", {}, 4),
    "events-crossbar-window4": ("events_only", "crossbar", {}, 4),
    "cb-toy": ("cb_edge", "toy", {}, RAND_CHUNK),
    "cb-crossbar": ("cb_edge", "crossbar", {}, RAND_CHUNK),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_per_loop(case):
    """The program and the per-loop path give the same calls to the bit:
    state, stats, draws consumed, K solves and iterations, CG loop counts;
    every call one program run (a redo or a continuation counted apart)."""
    kind, name, kw, chunk = CASES[case]
    p, lat = _structure(name)
    loops, prog = _port(p, lat, step_program=False, **kw), _port(p, lat, **kw)
    js = _start(p, lat, kind, name)
    a, b = _drive(loops, js, kind, chunk), _drive(prog, js, kind, chunk)
    for field in STATE:
        assert torch.equal(_bits(getattr(a[0], field)), _bits(getattr(b[0], field))), field
    assert a[1:] == b[1:]
    counts = (prog.cb_counts if kind == "cb_edge" else prog.step_counts)
    per_loop = (loops.cb_counts if kind == "cb_edge" else loops.step_counts)
    assert counts["per_loop"] == 0 and per_loop["per_loop"] == len(BIASES)
    assert counts["runs"] == len(BIASES) + prog.step_counts["redos"]
    if case == "fields-toy-redo":
        assert prog.step_counts["redos"] >= 1 and prog.vmax > 8
        assert all(key[3:6] == (prog.qmax, prog.vmax, prog.pair_cand_cap)
                   for key in prog.step_graphs.programs)
    if chunk == 4:
        assert prog.step_counts["continues"] >= 1
    if kind == "events_only":
        assert sum(s["n_events"] for s in b[1]) >= len(BIASES)
    if kind == "fields":
        assert b[3] == len(BIASES) + prog.step_counts["redos"]


def _akmc_tpu(jm, js, kind, chunk):
    stream = JStream(JRNG(1))
    stats, cb = [], []
    for Vd in BIASES:
        if kind == "fields":
            js, st = jm.fields_only(js, Vd)
        elif kind == "events_only":
            js, st = jm.superstep_events_only(js, stream, rand_chunk=chunk)
        else:           # update_cb_edge, its CG's iteration count kept
            cb_edge, res = jm._cb_jit(jm.tables, js.element, js.charge, js.cb_edge, Vd)
            js, st = js._replace(cb_edge=cb_edge), {}
            cb.append(int(res.iterations))
        stats.append(st)
    return js, stats, stream.peek(1)[0], cb


@pytest.mark.parametrize("case", ["fields-toy", "fields-crossbar", "events-toy-window4",
                                  "events-crossbar-window4", "cb-toy", "cb-crossbar"])
def test_program_matches_akmc_tpu(case):
    """Each program against akmc_tpu's call: fields only, charges exact and
    potentials to rtol 1e-8 / atol 1e-9 with the CG count equal (within 3 on
    the DIA operator, whose dots are the port's kernel's blocked order);
    events only, events, draws and elements exact and KMC times to rtol
    1e-12; the CB edge within 1e-12 of its largest entry, NaN where
    akmc_tpu's is, with the CG count equal."""
    kind, name, kw, chunk = CASES[case]
    p, lat = _structure(name)
    tm = _port(p, lat, **kw)
    jm = JModel(p, lat, **kw)
    js0 = _start(p, lat, kind, name)
    ts, tst, nt, *_, tcb = _drive(tm, js0, kind, chunk)
    js, jst, nj, jcb = _akmc_tpu(jm, js0, kind, chunk)
    assert tm.step_counts["per_loop"] == tm.cb_counts["per_loop"] == 0
    if kind == "fields":
        for a, b in zip(tst, jst):
            assert abs(a["cg_iterations"] - b["cg_iterations"]) <= (3 if tm.dia is not None
                                                                    else 0)
        np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))
        for field in ("potential_boundary", "potential_charge"):
            want = np.asarray(getattr(js, field))
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(getattr(ts, field).numpy(), want, rtol=1e-8, atol=1e-9)
    elif kind == "events_only":
        assert nt == nj
        assert [s["n_events"] for s in tst] == [s["n_events"] for s in jst]
        assert tm.step_counts["continues"] >= 1
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
        np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))
        np.testing.assert_allclose([s["event_time"] for s in tst],
                                   [s["event_time"] for s in jst], rtol=KMC_RTOL, atol=0)
        np.testing.assert_allclose(float(ts.kmc_time), float(js.kmc_time), rtol=KMC_RTOL)
    else:
        assert tcb == jcb
        want = np.asarray(js.cb_edge)
        got = ts.cb_edge.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=1e-12 * np.abs(want[finite]).max())


@pytest.mark.parametrize("kind", ["fields", "events_only", "cb_edge"])
def test_body_reads_nothing(kind, monkeypatch):
    """Each program's body under ``_NoReads`` with ``Tensor.item`` and
    ``tolist`` refused gives the diagnostics a call reads: every loop of it
    (K-CG, events, CB-edge CG) reads only its flag."""
    p, lat = _structure("toy")
    model = _port(p, lat, use_dia_k=False)
    state = convert.state(_start(p, lat, kind, "toy"))
    chunk = 16 if kind == "events_only" else 0
    prog = model._deck_program(kind, state, chunk)
    if kind == "events_only":
        prog.load(state, TStream(TRNG(1)).peek(chunk))
    else:
        prog.load(state, 2.0)
    _, want = prog.run()

    def refuse(*args, **kwargs):
        raise AssertionError("a host read in the program's body")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    with _NoReads(), device_loop.recording(device_loop.Recording()):
        _, stats = prog.body()
    monkeypatch.undo()
    got = stats.tolist()[: prog.n_diag]
    assert got == ([v for d in want for v in d] if kind == "events_only" else want)
