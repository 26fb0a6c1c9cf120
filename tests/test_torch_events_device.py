"""The event loops kept on the device (``ops/events.py``: ``run_event_loop``,
``run_event_loop_native``, ``run_event_loop_batched``) against their plain
host loops (``*_plain``), run eagerly on the CPU with k steps between two
host reads.

Every write of a step is guarded by the loop's ``live`` flag, so the device
loop must equal the plain loop to the bit for every k: integer state, the
rate table, the waiting time, the draws used and every counter. k = 3 divides
none of the loops' iteration counts here, so the last replay ends in dead
steps; k = 64 is more steps than any loop here runs. The uniforms of the
native and batched loops are drawn ahead per replay and given back for dead
steps: a generator ends where the plain loop leaves it, a ``ReplayDraws``
with just the vectors the loop needs is enough, and one short of them raises.
"""

import numpy as np
import pytest
import torch

from akmc_tpu_torch.lattice import ELEM, EVENT
from akmc_tpu_torch.models.crossbar import build_grid_crossbar
from akmc_tpu_torch.models.vcm import VCMModel
from akmc_tpu_torch.ops import events as ev
from akmc_tpu_torch.ops.device_loop import LoopGraphs
from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
from akmc_tpu_torch.state import make_device_state

torch.set_num_threads(1)

KS = [1, 3, 64]
SERIAL_FIELDS = ("element", "charge", "P", "event_time", "n_events", "draws_used", "done",
                 "event_time_h")
BATCHED_FIELDS = ("element", "charge", "P", "event_time", "n_events", "n_batches", "done",
                  "n_cut_conflict", "n_cut_mass", "event_time_h")


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f
        else:
            assert x == y, (f, x, y)


def _frozen(n_yz, oxide, normalize, Vd):
    p, lat = build_grid_crossbar(n_yz=n_yz, contact_slices=2, oxide_slices=oxide, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    model = VCMModel(p, lat, device="cpu", rate_normalize=normalize)
    state = make_device_state(lat, p.background_temp, torch.device("cpu"))
    return p, model, state, model.fields(state, Vd)


@pytest.fixture(scope="module")
def tables():
    """The n_yz = 6 crossbar's frozen fields at 15 V (one block of 256 rows)
    with shifted-exponent rates and with absolute ones, and the n_yz = 16
    crossbar's at 8 V (18 blocks: the incremental selection sums the touched
    blocks alone)."""
    return {"shifted": _frozen(6, 6, True, 15.0), "absolute": _frozen(6, 6, False, 15.0),
            "wide": _frozen(16, 22, True, 8.0)}


def _serial(loop, case, rand, **kw):
    p, model, state, fr = case
    t = model.tables
    return loop(state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, rand, p.freq,
                t.act_idx, t.abs2act, t.act_zero_rows, ln_S=fr.ln_S, **kw)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("incremental", [False, True], ids=["fresh", "incremental"])
@pytest.mark.parametrize("name", ["shifted", "absolute", "wide"])
def test_serial_loop_equals_plain(tables, name, incremental, k):
    rand = torch.from_numpy(ReferenceRNG(7).uniform(8192))
    plain = _serial(ev.run_event_loop_plain, tables[name], rand, incremental_select=incremental)
    dev = _serial(ev.run_event_loop, tables[name], rand, incremental_select=incremental, k=k)
    assert plain.done and plain.n_events >= 3
    _same(dev, plain, SERIAL_FIELDS)


@pytest.mark.parametrize("k", KS)
def test_serial_loop_resumes_from_a_spent_buffer_as_plain(tables, k):
    """Seven draws run out after three events (not done); the second call
    resumes with the mutated table and the carried waiting time."""
    rng = ReferenceRNG(11)
    first, second = (torch.from_numpy(rng.uniform(n)) for n in (7, 8192))
    runs = []
    for loop, kw in ((ev.run_event_loop_plain, {}), (ev.run_event_loop, {"k": k})):
        a = _serial(loop, tables["shifted"], first, **kw)
        p, model, state, fr = tables["shifted"]
        t = model.tables
        b = loop(a.element, a.charge, a.P, fr.etype, t.act_neigh, second, p.freq, t.act_idx,
                 t.abs2act, t.act_zero_rows, event_time_in=a.event_time, ln_S=fr.ln_S, **kw)
        runs.append((a, b))
    (pa, pb), (da, db) = runs
    assert (pa.n_events, pa.draws_used, pa.done) == (3, 6, False) and pb.done
    _same(da, pa, SERIAL_FIELDS)
    _same(db, pb, SERIAL_FIELDS)


@pytest.mark.parametrize("k", KS)
def test_serial_loops_on_an_empty_table(tables, k):
    p, model, state, fr = tables["shifted"]
    t = model.tables
    rand = torch.from_numpy(ReferenceRNG(7).uniform(64))
    res = ev.run_event_loop(state.element, fr.charge, fr.P * 0.0, fr.etype, t.act_neigh, rand,
                            p.freq, t.act_idx, t.abs2act, t.act_zero_rows, ln_S=fr.ln_S, k=k)
    assert (res.n_events, res.draws_used, res.done, res.event_time_h) == (0, 0, True, np.inf)
    assert torch.equal(res.element, state.element)
    nat = ev.run_event_loop_native(state.element, fr.charge, fr.P * 0.0, fr.etype, t.act_neigh,
                                   ev.GeneratorDraws.seeded(1, "cpu"), p.freq, act_idx=t.act_idx,
                                   abs2act=t.abs2act, ln_S=fr.ln_S, k=k)
    assert (nat.n_events, nat.done, nat.event_time_h) == (0, True, np.inf)


class Recording(ev.GeneratorDraws):
    """A seeded generator that keeps every vector it hands out."""

    def __init__(self, seed):
        g = torch.Generator()
        g.manual_seed(seed)
        super().__init__(g)
        self.vectors = []

    def uniform(self, shape, dtype, device):
        u = super().uniform(shape, dtype, device)
        self.vectors.append(u.clone())
        return u


def _native(loop, case, draws, **kw):
    p, model, state, fr = case
    t = model.tables
    return loop(state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, draws, p.freq,
                act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S, zero_rows=t.act_zero_rows,
                **kw)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["shifted", "absolute"])
def test_native_loop_equals_plain(tables, name, k):
    rec = Recording(3)
    plain = _native(ev.run_event_loop_native_plain, tables[name], rec)
    gen = ev.GeneratorDraws.seeded(3, "cpu")
    dev = _native(ev.run_event_loop_native, tables[name], gen, k=k)
    assert plain.done and plain.n_events >= 3
    _same(dev, plain, SERIAL_FIELDS)
    # the generator ends where the plain loop left it
    assert torch.equal(gen.uniform((5,), torch.float64, "cpu"),
                       rec.uniform((5,), torch.float64, "cpu"))
    # just the vectors the plain loop drew are enough; one fewer raises
    replay = ev.ReplayDraws(rec.vectors[:-1])
    _same(_native(ev.run_event_loop_native, tables[name], replay, k=k), plain, SERIAL_FIELDS)
    assert replay.handed_out == len(rec.vectors) - 1 == plain.n_events
    with pytest.raises(RuntimeError, match="exhausted"):
        _native(ev.run_event_loop_native, tables[name], ev.ReplayDraws(rec.vectors[:-2]), k=k)
    # a vector out of step on a live event raises; past the end it is never asked for
    bad = [v.clone() for v in rec.vectors[:-1]]
    bad[1] = bad[1].float()
    with pytest.raises(ValueError, match="asked for"):
        _native(ev.run_event_loop_native, tables[name], ev.ReplayDraws(bad), k=k)
    _native(ev.run_event_loop_native, tables[name],
            ev.ReplayDraws(rec.vectors[:-1] + [torch.zeros(3)]), k=k)


@pytest.mark.parametrize("k", KS)
def test_native_loop_cut_by_max_events_equals_plain(tables, k):
    plain = _native(ev.run_event_loop_native_plain, tables["shifted"],
                    ev.GeneratorDraws.seeded(4, "cpu"), max_events=2)
    dev = _native(ev.run_event_loop_native, tables["shifted"],
                  ev.GeneratorDraws.seeded(4, "cpu"), max_events=2, k=k)
    assert (plain.n_events, plain.done) == (2, False)
    _same(dev, plain, SERIAL_FIELDS)


def _batched(loop, case, draws, **kw):
    p, model, state, fr = case
    t = model.tables
    return loop(state.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, draws, p.freq,
                batch=8, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S, **kw)


# f32 clocks on the shifted rates at 15 V: some live rows' clocks underflow to
# inf and the loop runs until ``max_batches`` (as akmc_tpu's does), not done
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name, clock_f32, mass_eps, max_batches", [
    ("shifted", False, 1e-3, 1 << 14), ("absolute", False, 0.1, 1 << 14),
    ("shifted", True, 1e-3, 40), ("wide", False, 1e-3, 1 << 14), ("wide", False, 0.1, 5),
], ids=["shifted", "absolute", "f32-clocks-max-batches", "wide", "wide-max-batches"])
def test_batched_loop_equals_plain(tables, name, clock_f32, mass_eps, max_batches, k):
    kw = dict(clock_f32=clock_f32, mass_eps=mass_eps, max_batches=max_batches)
    rec = Recording(5)
    plain = _batched(ev.run_event_loop_batched_plain, tables[name], rec, **kw)
    gen = ev.GeneratorDraws.seeded(5, "cpu")
    dev = _batched(ev.run_event_loop_batched, tables[name], gen, k=k, **kw)
    assert plain.n_events >= 1 and plain.done == (max_batches == 1 << 14)
    assert plain.n_batches >= 2 and (plain.done or plain.n_batches == max_batches)
    _same(dev, plain, BATCHED_FIELDS)
    assert torch.equal(gen.uniform((5,), torch.float64, "cpu"),
                       rec.uniform((5,), torch.float64, "cpu"))
    replay = ev.ReplayDraws(rec.vectors[:-1])
    _same(_batched(ev.run_event_loop_batched, tables[name], replay, k=k, **kw), plain,
          BATCHED_FIELDS)
    assert replay.handed_out == len(rec.vectors) - 1 == 2 * plain.n_batches
    with pytest.raises(RuntimeError, match="exhausted"):
        _batched(ev.run_event_loop_batched, tables[name], ev.ReplayDraws(rec.vectors[:-2]),
                 k=k, **kw)


@pytest.mark.parametrize("k", KS)
def test_batched_loop_on_an_empty_table_and_no_batch(tables, k):
    p, model, state, fr = tables["shifted"]
    t = model.tables
    common = dict(batch=8, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S, k=k)
    gen = ev.GeneratorDraws.seeded(6, "cpu")
    empty = ev.run_event_loop_batched(state.element, fr.charge, fr.P * 0.0, fr.etype,
                                      t.act_neigh, gen, p.freq, **common)
    assert (empty.done, empty.n_events, empty.n_batches, empty.event_time_h) == (
        True, 0, 1, np.inf)
    none = ev.run_event_loop_batched(state.element, fr.charge, fr.P.clone(), fr.etype,
                                     t.act_neigh, gen, p.freq, max_batches=0, **common)
    assert (none.done, none.n_events, none.n_batches, none.event_time_h) == (False, 0, 0, 0.0)
    # one batch was drawn, by the empty table's loop; the loop that ran none drew nothing
    ref = ev.GeneratorDraws.seeded(6, "cpu")
    ref.uniform((fr.P.shape[0],), torch.float64, "cpu")
    ref.uniform((8,), torch.float64, "cpu")
    assert torch.equal(gen.uniform((4,), torch.float64, "cpu"),
                       ref.uniform((4,), torch.float64, "cpu"))


def test_single_candidate_loops_on_a_ring():
    """One nonzero rate: every loop fires that event and ends, on its gap or
    on the emptied table."""
    n, nn = 32, 4
    neigh = torch.full((n, nn), -1, dtype=torch.int64)
    for i in range(n):
        neigh[i, 0], neigh[i, 1] = (i + 1) % n, (i - 1) % n
    element = torch.full((n,), int(ELEM.O), dtype=torch.int32)
    element[5] = int(ELEM.VACANCY)
    charge = torch.zeros(n, dtype=torch.int32)
    charge[5] = 2
    P = torch.zeros((n, nn), dtype=torch.float64)
    etype = torch.full((n, nn), int(EVENT.NULL_EVENT), dtype=torch.int32)
    P[5, 0] = 3e13
    etype[5, 0] = int(EVENT.VACANCY_DIFFUSION)
    for k in KS:
        for loop in (ev.run_event_loop_batched, ev.run_event_loop_batched_plain):
            res = loop(element, charge, P.clone(), etype, neigh,
                       ev.GeneratorDraws.seeded(7, "cpu"), 1e14, batch=8,
                       **({"k": k} if loop is ev.run_event_loop_batched else {}))
            assert res.n_events == 1 and res.element[6] == int(ELEM.VACANCY)
            assert float(res.P.sum()) == 0.0


def _plain_to_the_end(model, element, charge, P, etype, ln_S, stream, rand_chunk):
    """``VCMModel._events_to_the_end`` with the plain serial loop."""
    t = model.tables
    res, n = None, 0
    while res is None or not res.done:
        rand = torch.as_tensor(stream.peek(rand_chunk), dtype=torch.float64)
        res = ev.run_event_loop_plain(
            element if res is None else res.element, charge if res is None else res.charge,
            P if res is None else res.P, etype, t.act_neigh, rand, model.params.freq,
            t.act_idx, t.abs2act, t.act_zero_rows,
            event_time_in=None if res is None else res.event_time, ln_S=ln_S,
            incremental_select=model.event_select_incremental)
        stream.advance(res.draws_used)
        n += res.n_events
    return res._replace(n_events=n)


@pytest.mark.parametrize("incremental", [False, True], ids=["fresh", "incremental"])
def test_supersteps_through_the_device_loop_equal_plain(tables, incremental):
    """Two serial supersteps whose rand chunks run out mid-superstep (the
    chunk resume), then two batched ones, through the model's own loops and
    its ``LoopGraphs`` (one program per loop, reused; results never alias
    it), against the plain loops on the same fields."""
    p, model, state, _ = tables["shifted"]
    model.event_select_incremental = incremental
    model.loop_graphs = LoopGraphs()
    stream, ref_stream = (BufferedStream(ReferenceRNG(p.rnd_seed_kmc)) for _ in range(2))
    s = state
    try:
        for _ in range(2):
            fr = model.fields(s, 15.0)
            ref = _plain_to_the_end(model, s.element, fr.charge, fr.P.clone(), fr.etype,
                                    fr.ln_S, ref_stream, 6)
            s_new, stats = model.superstep(s, 15.0, stream, rand_chunk=6)
            assert stats["n_events"] == ref.n_events > 3    # more than one chunk
            assert torch.equal(s_new.element, ref.element)
            assert torch.equal(s_new.charge, ref.charge)
            assert stats["event_time"] == ref.event_time_h
            assert np.array_equal(stream.peek(4), ref_stream.peek(4))
            s = s_new
        first = s.element.clone()
        gen, ref_gen = ev.GeneratorDraws.seeded(9, "cpu"), ev.GeneratorDraws.seeded(9, "cpu")
        for _ in range(2):
            fr = model.fields(s, 15.0)
            t = model.tables
            ref = ev.run_event_loop_batched_plain(
                s.element, fr.charge, fr.P.clone(), fr.etype, t.act_neigh, ref_gen, p.freq,
                batch=8, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S)
            s, stats = model.superstep_native_batched(s, 15.0, gen, batch=8)
            assert torch.equal(s.element, ref.element)
            assert (stats["n_events"], stats["n_batches"], stats["event_time"]) == (
                ref.n_events, ref.n_batches, ref.event_time_h)
        assert len(model.loop_graphs.programs) == 2
        assert not torch.equal(first, s.element)
    finally:
        model.event_select_incremental = False


def test_warmup_builds_the_loop_the_run_takes(tables):
    """``warmup`` builds the batched program that the supersteps then reuse,
    and gives back every draw of its throwaway generator."""
    p, model, state, _ = tables["shifted"]
    model.loop_graphs = LoopGraphs()
    items = model.warmup(state, 15.0, batched=8)
    assert set(items) == {"batched_B8"}
    assert len(model.loop_graphs.programs) == 1
    model.superstep_native_batched(state, 15.0, ev.GeneratorDraws.seeded(2, "cpu"), batch=8)
    assert len(model.loop_graphs.programs) == 1
    assert set(model.warmup(state, 15.0)) == {"serial_loop"}
    assert len(model.loop_graphs.programs) == 2
