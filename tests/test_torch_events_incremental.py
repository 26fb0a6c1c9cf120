"""Incremental event selection (``incremental_select`` of the serial loop,
``VCMModel(event_select_incremental=True)``) in akmc_tpu_torch.

The carried block sums are a variant of the same selection, so in the port
the incremental loop must reproduce the fresh one to the bit: events,
elements, charges, the rate table, ``draws_used`` and every waiting time.
Against akmc_tpu's incremental loop from the same numpy inputs, integer
results are exact and waiting times are held at rtol 1e-15, the bound that
akmc_tpu's own fresh-against-incremental test
(``tests/test_events_loop.py::test_incremental_select_is_bit_identical``)
puts on its two variants: XLA compiles their block sums to different
reduction trees, a few ulps apart."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops import events as jev
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG
from akmc_tpu.state import make_device_state, make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops import events as tev
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from tests.util_toy import toy_device

# the JAX-comparing files run PyTorch on the calling thread (test_torch_ops.py)
torch.set_num_threads(1)

TIME_RTOL = 1e-15
SUPERSTEP_RTOL = 1e-5


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def toy():
    p, lat = toy_device()
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, ReferenceRNG(7))
    return p, lat


@pytest.fixture(scope="module")
def grid():
    p, lat = build_grid_crossbar(
        n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
        defect_fraction=0.3, vacancy_concentration=0.1, seed=3,
    )
    m = JModel(p, lat)
    return p, lat, m, convert.tables(m.tables), make_device_state(lat, p.background_temp)


def _port_supersteps(p, lat, Vds, **kw):
    model = TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)
    state = convert.state(make_device_state(lat, p.background_temp))
    stream = TStream(TRNG(1))
    stats = []
    for Vd in Vds:
        state, st = model.superstep(state, Vd, stream)
        stats.append(st)
    return state, stats, stream


@pytest.mark.parametrize("rate_normalize", [False, True], ids=["absolute", "shifted"])
def test_toy_supersteps_incremental_equal_fresh_and_akmc_tpu(toy, rate_normalize):
    p, lat = toy
    Vds = (2.0, 2.0, 6.0, 6.0)
    s_f, st_f, str_f = _port_supersteps(p, lat, Vds, rate_normalize=rate_normalize)
    s_i, st_i, str_i = _port_supersteps(p, lat, Vds, rate_normalize=rate_normalize,
                                        event_select_incremental=True)
    assert sum(s["n_events"] for s in st_i) >= 4
    # the port's two selections: equal to the bit
    assert st_i == st_f
    for f in dataclasses.fields(s_i):
        assert torch.equal(getattr(s_i, f.name), getattr(s_f, f.name)), f.name
    assert str_i.peek(1)[0] == str_f.peek(1)[0]

    # akmc_tpu's supersteps solve their own fields: the waiting times then
    # differ by where each K-CG stopped (1.3e-6 here), not by the selection
    jm = JModel(p, lat, rate_normalize=rate_normalize, event_select_incremental=True)
    js = make_device_state(lat, p.background_temp)
    jstream = JStream(ReferenceRNG(1))
    for Vd, st in zip(Vds, st_i):
        js, jst = jm.superstep(js, Vd, jstream)
        assert st["n_events"] == jst["n_events"]
        assert st["event_time"] == pytest.approx(jst["event_time"], rel=SUPERSTEP_RTOL)
    assert jstream.peek(1)[0] == str_i.peek(1)[0]           # the same draws used
    np.testing.assert_array_equal(s_i.element.numpy(), np.asarray(js.element))
    np.testing.assert_array_equal(s_i.charge.numpy(), np.asarray(js.charge))


def _rates(p, t, s, fr, normalize):
    out = jev.build_event_table(
        s.element, fr.charge, fr.potential_sum, s.T_bg, t.act_neigh, t.act_self2, t.act_layer,
        t.E_gen, t.E_rec, t.E_Vdiff, t.E_Odiff, p.freq, p.sigma, p.k, rows=t.act_idx,
        normalize=normalize,
    )
    return out if normalize else (*out, None)


def _port_loop(tt, elem, charge, P, etype, rand, p, ln_S, inc, event_time_in=None):
    return tev.run_event_loop(
        elem, charge, P.clone(), etype, tt.act_neigh, torch.from_numpy(rand), p.freq,
        tt.act_idx, tt.abs2act, tt.act_zero_rows, event_time_in=event_time_in,
        ln_S=None if ln_S is None else float(ln_S), incremental_select=inc,
    )


def _assert_same(a, b):
    assert (a.n_events, a.draws_used, a.done) == (b.n_events, b.draws_used, b.done)
    for x, y in ((a.element, b.element), (a.charge, b.charge), (a.P, b.P),
                 (a.event_time, b.event_time)):
        assert torch.equal(x, y)
    assert a.event_time_h == b.event_time_h


@pytest.fixture(scope="module")
def wide():
    """A crossbar whose rate table has 18 blocks of 256 rows: enough for the
    refresh to sum the touched blocks alone (the two above have one)."""
    p, lat = build_grid_crossbar(
        n_yz=16, contact_slices=2, oxide_slices=22, ti_slices=2,
        defect_fraction=0.3, vacancy_concentration=0.1, seed=3,
    )
    m = JModel(p, lat)
    return p, lat, m, convert.tables(m.tables), make_device_state(lat, p.background_temp)


@pytest.fixture(scope="module")
def toy_tables(toy):
    p, lat = toy
    m = JModel(p, lat)
    return p, lat, m, convert.tables(m.tables), make_device_state(lat, p.background_temp)


@pytest.mark.parametrize("structure", ["grid", "toy", "wide"])
@pytest.mark.parametrize("normalize", [False, True], ids=["absolute", "shifted"])
@pytest.mark.parametrize("buf_len", [8192, 7], ids=["whole", "resumed"])
def test_loop_incremental_equal_fresh_and_akmc_tpu(request, structure, normalize, buf_len,
                                                   monkeypatch):
    """On one rate table from akmc_tpu's fields: the n_yz = 6 and 16
    crossbars' at 8 V, the toy device's at 6 V (many events). With a buffer
    of 7 draws the loop runs out after three events and resumes from a second
    buffer, with the mutated table and the carried waiting time: the resumed
    loop sums its blocks anew from R."""
    p, lat, m, tt, s = request.getfixturevalue(
        "toy_tables" if structure == "toy" else structure)
    fr = m._run_fields(s, 6.0 if structure == "toy" else 8.0)
    t = m.tables
    P, etype, ln_S = _rates(p, t, s, fr, normalize)
    elem, charge, Pt, et = T(s.element), T(fr.charge), T(P), T(etype)
    assert Pt.shape[0] % 256 == 0
    assert (Pt.shape[0] // 256 >= tev._MIN_BLOCK_ROWS) == (structure == "wide")
    # the device loop calls the refresh in every step it runs; a dead step's
    # (its ``live`` argument false) writes nothing: count the live ones
    refreshed = []
    real = tev._refresh_block_sums
    monkeypatch.setattr(tev, "_refresh_block_sums",
                        lambda *a: (refreshed.append(len(a) < 4 or bool(a[3])), real(*a)))
    rand = ReferenceRNG(7).uniform(buf_len)
    rf = _port_loop(tt, elem, charge, Pt, et, rand, p, ln_S, False)
    assert not refreshed
    ri = _port_loop(tt, elem, charge, Pt, et, rand, p, ln_S, True)
    assert sum(refreshed) == ri.n_events >= 3
    _assert_same(ri, rf)
    rj = jev.run_event_loop(
        s.element, fr.charge, P, etype, t.act_neigh, jnp.asarray(rand), p.freq,
        act_idx=t.act_idx, abs2act=t.abs2act, ln_S=ln_S, zero_rows=t.act_zero_rows,
        incremental_select=True,
    )
    assert (ri.n_events, ri.draws_used, ri.done) == (
        int(rj.n_events), int(rj.draws_used), bool(rj.done))
    np.testing.assert_array_equal(ri.element.numpy(), np.asarray(rj.element))
    np.testing.assert_array_equal(ri.charge.numpy(), np.asarray(rj.charge))
    np.testing.assert_array_equal(ri.P.numpy(), np.asarray(rj.P))
    assert float(ri.event_time) == pytest.approx(float(rj.event_time), rel=TIME_RTOL, abs=0.0)
    assert ri.done == (buf_len == 8192)
    if not ri.done:
        rand2 = ReferenceRNG(8).uniform(8192)
        rf2, ri2 = (_port_loop(tt, r.element, r.charge, r.P, et, rand2, p, ln_S, inc,
                               event_time_in=r.event_time)
                    for r, inc in ((rf, False), (ri, True)))
        _assert_same(ri2, rf2)
        rj2 = jev.run_event_loop(
            rj.element, rj.charge, rj.P, etype, t.act_neigh, jnp.asarray(rand2), p.freq,
            event_time_in=rj.event_time, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=ln_S,
            zero_rows=t.act_zero_rows, incremental_select=True,
        )
        assert (ri2.n_events, ri2.draws_used, ri2.done) == (
            int(rj2.n_events), int(rj2.draws_used), bool(rj2.done))
        np.testing.assert_array_equal(ri2.element.numpy(), np.asarray(rj2.element))
        assert float(ri2.event_time) == pytest.approx(float(rj2.event_time), rel=TIME_RTOL,
                                                      abs=0.0)


def test_uncompacted_table_off_a_multiple_of_256_turns_the_flag_off(toy, monkeypatch):
    """The toy device's whole-structure table (one row per site, no row
    compaction) has a row count that is not a multiple of 256: the flag then
    selects nothing, as in akmc_tpu, and the loop is the fresh one."""
    p, lat = toy
    jm = JModel(p, lat)
    s = make_device_state(lat, p.background_temp)
    fr = jm._run_fields(s, 6.0)
    t = jm.tables
    n = lat.N
    assert n % 256
    out = jev.build_event_table(
        s.element, fr.charge, fr.potential_sum, s.T_bg, t.neigh_idx,
        _self2_full(p, lat), jnp.asarray(lat.site_layer[np.clip(lat.neigh_idx, 0, None)]),
        t.E_gen, t.E_rec, t.E_Vdiff, t.E_Odiff, p.freq, p.sigma, p.k,
        rows=jnp.arange(n),
    )
    P, etype = out[0], out[1]
    monkeypatch.setattr(tev, "_refresh_block_sums",
                        lambda *a: pytest.fail("blocks refreshed on a table of %d rows" % n))
    rand = ReferenceRNG(3).uniform(8192)
    res = {}
    for inc in (False, True):
        res[inc] = tev.run_event_loop(
            T(s.element), T(fr.charge), T(P).clone(), T(etype), T(t.neigh_idx).long(),
            torch.from_numpy(rand), p.freq, None, None, None, incremental_select=inc,
        )
    _assert_same(res[True], res[False])
    rj = jev.run_event_loop(s.element, fr.charge, P, etype, t.neigh_idx, jnp.asarray(rand),
                            p.freq, incremental_select=True)
    assert res[True].n_events == int(rj.n_events) >= 2
    assert res[True].draws_used == int(rj.draws_used)
    np.testing.assert_array_equal(res[True].element.numpy(), np.asarray(rj.element))
    assert float(res[True].event_time) == pytest.approx(float(rj.event_time), rel=TIME_RTOL,
                                                        abs=0.0)


def _self2_full(p, lat):
    """v_solve(d, 2) for every (site, neighbor) pair of the whole structure,
    as akmc_tpu's model forms it for its active rows."""
    from scipy.special import erfc

    pos = np.stack([lat.x, lat.y, lat.z], axis=1)
    nb = np.asarray(lat.neigh_idx)
    d = np.sqrt(((pos[:, None, :] - pos[np.clip(nb, 0, None)]) ** 2).sum(-1)) * 1e-10
    d[nb < 0] = 1.0
    return jnp.asarray(2.0 * erfc(d / (p.sigma * np.sqrt(2.0))) * p.k * 1.60217663e-19 / d)


@pytest.mark.parametrize("n_blocks", [1, 9, 16, 40])
@pytest.mark.parametrize("n_rows", [1, 5, 18])
def test_refreshed_block_sums_are_the_fresh_sums(n_blocks, n_rows):
    """A block summed again through ``_refresh_block_sums`` has the bits of
    the same block in a fresh ``_block_sums``, whatever the block count and
    the number of touched rows, on rates spread over many orders."""
    rng = np.random.default_rng(n_blocks * 100 + n_rows)
    n = 256 * n_blocks
    R = torch.from_numpy(np.exp(rng.uniform(-40.0, 5.0, n)) * (rng.random(n) < 0.7))
    bs = tev._block_sums(R)
    R2 = R.clone()
    rows = torch.from_numpy(rng.integers(0, n, n_rows))
    R2[rows] = torch.from_numpy(rng.random(n_rows))
    tev._refresh_block_sums(bs, R2, rows)
    assert torch.equal(bs, tev._block_sums(R2))
