"""The serial superstep as one program (``models/step_program.py``), on the CPU.

``VCMModel.superstep`` and ``superstep_multi`` run the fields and the event
loop as one program with one read of a packed diagnostics vector, its loops
as while loops (on a card one CUDA graph with conditional while nodes; here
the same body, eagerly). Held here:

* the program against the per-loop path (``step_program=False``: fields with
  caps grown, then each loop a device loop of its own), bit for bit: state,
  stats, draws consumed, K solves and their iterations, CG counts; on the DIA
  stand-in, banded (open and ``pbc = 1``, and with the carried residual),
  ELL and the tiled pairwise path;
* the program against ``akmc_tpu``'s ``superstep`` (events, draws and
  elements equal; KMC time to 1e-6, the bound of tests/test_torch_fields.py);
* a cap below the population redone from the same inputs, a window too
  small continued in events-only chunks, a ``superstep_multi`` batch that
  must be discarded and replayed, each as ``akmc_tpu`` does it;
* ``compact_mask`` against ``akmc_tpu``'s at counts 0, below, at and above
  its size;
* the body reads nothing back: under a dispatch mode that refuses every read
  but a while loop's own read of its flag (on a card the node's condition).
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops.compact import compact_mask as j_compact_mask
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.vcm import RAND_CHUNK
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops import device_loop
from akmc_tpu_torch.ops.compact import compact_mask
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from tests.test_torch_fields import _toy

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

FIELDS = ("element", "charge", "potential_boundary", "potential_charge", "kmc_time")
CASES = {
    "dia": (False, {}),
    "banded-open": (False, dict(use_dia_k=False)),
    "banded-pbc": (True, dict(use_dia_k=False)),
    "banded-carry": (False, dict(use_dia_k=False, k_carry_residual=True)),
    "ell": (False, dict(use_dia_k=False, use_banded_k=False)),
    "tiled-pairwise": (False, dict(use_dia_k=False, pair_table_budget=0, pair_tiling_min_n=1)),
}
KOP = {"dia": "dia", "banded-open": "banded", "banded-pbc": "banded",
       "banded-carry": "banded", "ell": "ell", "tiled-pairwise": "banded"}


def _port(p, lat, **kw):
    return TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)


def _drive(model, lat, p, steps=4, k=3, chunk=RAND_CHUNK, biases=(2.0, 2.0, 3.0, 3.0)):
    """``steps`` supersteps, then one ``superstep_multi`` of k: (state, stats,
    the stream's next draw, K solves, K iterations, CG counts per superstep)."""
    state = convert.state(j_state(lat, p.background_temp))
    stream = TStream(TRNG(1))
    stats, cg = [], []
    for Vd in biases[:steps]:
        state, st = model.superstep(state, Vd, stream, rand_chunk=chunk)
        stats.append(st)
        cg.append(dict(model.cg_step_counts))
    state, more = model.superstep_multi(state, biases[-1], stream, k=k)
    cg.append(dict(model.cg_step_counts))
    return state, stats + more, stream.peek(1)[0], model.k_solves, model.k_iterations, cg


@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_per_loop_path(case):
    """The program and the per-loop path give the same supersteps to the bit,
    and count the same K solves, iterations and CG loop work."""
    pbc, kw = CASES[case]
    p, lat = _toy(pbc)
    loops, prog = _port(p, lat, step_program=False, **kw), _port(p, lat, **kw)
    assert prog.describe()["k_operator"] == KOP[case]
    if case == "tiled-pairwise":
        assert prog.describe()["pairwise"] == "tiled"
    a, b = _drive(loops, lat, p), _drive(prog, lat, p)
    for name in FIELDS:
        assert torch.equal(getattr(a[0], name), getattr(b[0], name)), name
    assert a[1] == b[1]
    assert a[2:5] == b[2:5]
    if case != "banded-carry":       # the per-loop batch counts per step, the program per batch
        assert a[5][:4] == b[5][:4]
    assert sum(s["n_events"] for s in b[1]) >= 4
    assert len(prog.step_graphs.programs) == 2 and not loops.step_graphs.programs


@pytest.mark.parametrize("case", ["dia", "banded-pbc"])
def test_program_matches_akmc_tpu(case):
    """Supersteps of the program against akmc_tpu's fused superstep: events,
    draws and elements equal, KMC times within 1e-6, CG counts equal off the
    DIA operator (the port's DIA dots are its kernel's blocked order)."""
    pbc, kw = CASES[case]
    p, lat = _toy(pbc)
    jm, tm = JModel(p, lat, **kw), _port(p, lat, **kw)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    jstream, tstream = JStream(JRNG(1)), TStream(TRNG(1))
    for Vd in (2.0, 2.0, 3.0):
        js, a = jm.superstep(js, Vd, jstream)
        ts, b = tm.superstep(ts, Vd, tstream)
        assert b["n_events"] == a["n_events"]
        if case != "dia":
            assert b["cg_iterations"] == a["cg_iterations"]
        assert b["event_time"] == pytest.approx(a["event_time"], rel=1e-6)
        assert tstream.peek(1)[0] == jstream.peek(1)[0]
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
        np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))
    assert float(ts.kmc_time) == pytest.approx(float(js.kmc_time), rel=1e-6)


@pytest.mark.parametrize("caps", [dict(vmax=8), dict(qmax=8)], ids=["vmax", "qmax"])
def test_a_small_cap_is_redone(caps):
    """A cap below the population is flagged by the program's one read; the
    cap doubles and the step is redone from the same inputs (the stream has
    not moved): the roomy model's trajectory, each redone pass counted as a
    K solve as akmc_tpu's model counts it."""
    p, lat = _toy(cfg=(10, 4, 4, 2, 0.2, 5))          # 19 vacancies
    roomy, small = _port(p, lat), _port(p, lat, **caps)
    a, b = _drive(roomy, lat, p), _drive(small, lat, p)
    for name in FIELDS:
        assert torch.equal(getattr(a[0], name), getattr(b[0], name)), name
    assert a[1] == b[1] and a[2] == b[2]
    name, cap = next(iter(caps.items()))
    assert getattr(small, name) >= 2 * cap
    assert small.k_solves > roomy.k_solves
    # the programs of outgrown caps are gone; those of the grown ones stay
    assert all(key[3:6] == (small.qmax, small.vmax, small.pair_cand_cap)
               for key in small.step_graphs.programs)


def test_a_small_window_continues_as_akmc_tpu():
    """With 4 draws a window the program's loop runs out mid-superstep and
    goes on in events-only chunks, as akmc_tpu's superstep does."""
    p, lat = _toy()
    jm, tm = JModel(p, lat), _port(p, lat)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    jstream, tstream = JStream(JRNG(1)), TStream(TRNG(1))
    events = 0
    for _ in range(3):
        js, a = jm.superstep(js, 5.0, jstream, rand_chunk=4)
        ts, b = tm.superstep(ts, 5.0, tstream, rand_chunk=4)
        assert (b["n_events"], b["cg_iterations"]) == (a["n_events"], a["cg_iterations"])
        assert tstream.peek(1)[0] == jstream.peek(1)[0]
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
        events += b["n_events"]
    assert events > 6            # more than one window's two events in some superstep


def test_a_discarded_batch_equals_akmc_tpu():
    """A ``superstep_multi`` batch whose windows run out is discarded and
    replayed with ``superstep``, as akmc_tpu's is: the same stats, elements
    and stream, step for step; and the per-loop path's result."""
    p, lat = _toy()
    jm, tm = JModel(p, lat), _port(p, lat)
    loops = _port(p, lat, step_program=False)
    js = j_state(lat, p.background_temp)
    ts = ls = convert.state(js)
    jstream, tstream, lstream = JStream(JRNG(1)), TStream(TRNG(1)), TStream(TRNG(1))
    for _ in range(2):
        js, jst = jm.superstep_multi(js, 5.0, jstream, k=3, rand_chunk=4)
        ts, tst = tm.superstep_multi(ts, 5.0, tstream, k=3, rand_chunk=4)
        ls, lst = loops.superstep_multi(ls, 5.0, lstream, k=3, rand_chunk=4)
        assert [(s["n_events"], s["cg_iterations"]) for s in tst] == [
            (s["n_events"], s["cg_iterations"]) for s in jst]
        assert tst == lst
        assert tstream.peek(1)[0] == jstream.peek(1)[0] == lstream.peek(1)[0]
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
    for name in FIELDS:
        assert torch.equal(getattr(ts, name), getattr(ls, name)), name
    # the batch's program ran and was discarded, then each step's own ran
    runs = {key[:2]: prog.runs for key, prog in tm.step_graphs.programs.items()}
    assert runs == {(3, 4): 2, (1, 4): 6}


@pytest.mark.parametrize("count", [0, 5, 16, 40], ids=["none", "below", "at", "above"])
def test_compact_mask_matches_akmc_tpu(count):
    """Ascending indices, -1 padded or truncated to ``size``: akmc_tpu's
    ``compact_mask`` entry for entry, its valid mask too."""
    rng = np.random.default_rng(count)
    mask = np.zeros(300, bool)
    mask[rng.choice(300, count, replace=False)] = True
    idx, valid = compact_mask(torch.from_numpy(mask), 16)
    j_idx, j_valid = j_compact_mask(mask, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))


class _NoReads(TorchDispatchMode):
    """Refuses every operation that reads a value back to the host, but an
    eager while loop's read of its own flag."""

    READS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.is_nonzero.default,
             torch.ops.aten.item.default, torch.ops.aten.nonzero.default)

    def __init__(self):
        super().__init__()
        self.flag_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            if not device_loop.condition_read():
                raise AssertionError(f"a host read in the superstep's body: {func}")
            self.flag_reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case, k", [("dia", 1), ("banded-pbc", 1), ("banded-carry", 3),
                                     ("ell", 1), ("tiled-pairwise", 2)])
def test_superstep_body_reads_nothing(case, k, monkeypatch):
    """The program's body, run under ``_NoReads`` with ``Tensor.item`` and
    ``tolist`` refused, gives the diagnostics a dispatch reads; only the
    while loops read their flags (the card's nodes read them on the device)."""
    pbc, kw = CASES[case]
    p, lat = _toy(pbc)
    model = _port(p, lat, **kw)
    state = convert.state(j_state(lat, p.background_temp))
    carry = case == "banded-carry"
    prog = model._superstep_program(state, k, RAND_CHUNK, carry)
    window = TStream(TRNG(1)).peek(k * RAND_CHUNK)
    prog.load(state, 2.0, window)
    _, diag = prog.run()
    assert len(diag) == k and all(d[3] == 1.0 and d[0] > 0 for d in diag)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read in the superstep's body")

    prog.load(state, 2.0, window)
    guard = _NoReads()
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", refuse)
        m.setattr(torch.Tensor, "tolist", refuse)
        with guard, device_loop.recording(device_loop.Recording()):
            _, stats = prog.body()
        with pytest.raises(AssertionError):
            with guard:
                float(torch.ones(()))          # the guard does refuse a read
    assert guard.flag_reads > 0
    vals = stats.tolist()
    assert [vals[8 * i: 8 * i + 8] for i in range(k)] == diag
    assert not any(math.isnan(v) for v in vals)
