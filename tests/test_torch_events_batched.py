"""The production event path of akmc_tpu_torch against akmc_tpu on the CPU:
``_topk_smallest``, ``run_event_loop_batched``, ``run_event_loop_native``,
``superstep_native``/``superstep_native_batched`` and ``--module-timing``.

akmc_tpu draws from threefry inside its loops; the port takes its uniforms
from a draws source. The replay tests walk akmc_tpu's key schedule themselves
(``key, k_clk, k_slot = split(key, 3)`` per batch, ``key, k_sel, k_time =
split(key, 3)`` per serial event, ``key, sub = split(key)`` per superstep),
hand those uniforms to the port's ``ReplayDraws`` and compare with akmc_tpu's
loop run from the same key. Everything after the draws is deterministic:
elements, charges, event and batch counts and both cut counters must be
equal, the zero pattern of the rate table too; ``event_time`` to rtol 1e-12
(the two packages' log and sums may differ in the last place), with f32
clocks to rtol 1e-6.

The other tests are the port's counterparts of tests/test_events_batched.py,
run with the port's own generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops import events as jev
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM, EVENT
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops import events as tev
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from akmc_tpu_torch.runtime import driver as tdriver
from tests.test_events_loop import crafted  # noqa: F401  (fixture)
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

FREQ = 1e14


def T(a, dtype=None):
    """A CPU tensor copy of a numpy or JAX array; index tables as int64."""
    t = torch.tensor(np.asarray(a))
    return t.to(dtype) if dtype is not None else t


def _counts(el):
    el = np.asarray(el)
    return {
        "V-Od": int((el == int(ELEM.VACANCY)).sum() - (el == int(ELEM.OXYGEN_DEFECT)).sum()),
        "O+V": int((el == int(ELEM.O)).sum() + (el == int(ELEM.VACANCY)).sum()),
        "d+Od": int((el == int(ELEM.DEFECT)).sum() + (el == int(ELEM.OXYGEN_DEFECT)).sum()),
    }


# ------------------------------------------------------------------ (a) top-k
@pytest.mark.parametrize("n,B", [(1000, 4), (1000, 16), (1000, 64), (2048, 4), (2048, 8),
                                 (16384, 16), (16384, 64)])
@pytest.mark.parametrize("finite", [0.4, 0.0], ids=["many-finite", "ties-at-inf"])
def test_topk_smallest_matches(n, B, finite):
    """Both branches (plain for n = 1,000; two-stage for the multiples of 256
    above 1,024), with most clocks at inf as zero-rate rows have them, equal
    finite values planted across blocks, and fewer finite values than B."""
    rng = np.random.default_rng(n + B)
    tau = rng.exponential(size=n)
    tau[rng.random(n) >= finite] = np.inf
    # ties among finite clocks; in the other case three finite clocks in all
    tau[rng.integers(0, n, 12 if finite else 3)] = 0.25
    jv, ji = jev._topk_smallest(jnp.asarray(tau), B)
    tv, ti = tev._topk_smallest(torch.from_numpy(tau), B)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if not finite:
        assert np.isinf(tv.numpy()).any()       # the tie order at inf was compared
    tau32 = tau.astype(np.float32)
    jv, ji = jev._topk_smallest(jnp.asarray(tau32), B)
    tv, ti = tev._topk_smallest(torch.from_numpy(tau32), B)
    assert tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------------------- (b) replay
def batched_schedule(key, n, B, clock_f32):
    """The uniforms akmc_tpu's batched loop draws from ``key``, batch by
    batch: u_clk (n,) in the clock's type, then u_slot (B,) f64."""
    clock = jnp.float32 if clock_f32 else jnp.float64
    while True:
        key, k_clk, k_slot = jax.random.split(key, 3)
        yield np.asarray(jax.random.uniform(k_clk, (n,), dtype=clock))
        yield np.asarray(jax.random.uniform(k_slot, (B,), dtype=jnp.float64))


def native_schedule(key):
    """The uniforms akmc_tpu's native loop draws from ``key``, event by
    event: (selection draw, waiting-time draw)."""
    while True:
        key, k_sel, k_time = jax.random.split(key, 3)
        yield np.array([float(jax.random.uniform(k_sel, dtype=jnp.float64)),
                        float(jax.random.uniform(k_time, dtype=jnp.float64))])


def _toy_frozen(rate_normalize):
    """One fields pass of akmc_tpu on the toy device: the frozen tables of
    tests/test_batched_distribution.py, in both packages' types."""
    p, lat = toy_device()
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(7))
    jm = JModel(p, lat, rate_normalize=rate_normalize)
    js = j_state(lat, p.background_temp)
    fr = jax.jit(jm._fields)(jm.tables, jm.kop, js.element, js.charge,
                             js.potential_boundary, js.T_bg, 2.0)
    return p, lat, jm, js, fr


@pytest.fixture(scope="module")
def tables(crafted):  # noqa: F811
    """name -> (akmc_tpu loop arguments, the port's, freq). The crafted table
    has one row per site (64 rows, no compaction); the toy tables are
    compacted (``act_idx``/``abs2act``), without and with the log rate
    scale."""
    element, charge, P, etype, neigh = crafted
    out = {"crafted": (
        dict(element=jnp.asarray(element), charge=jnp.asarray(charge), P=jnp.asarray(P),
             etype=jnp.asarray(etype), neigh_idx=jnp.asarray(neigh), kw={}),
        dict(element=T(element), charge=T(charge), P=T(P), etype=T(etype),
             neigh_idx=T(neigh, torch.int64), kw={}),
        FREQ,
    )}
    for name, normalize in (("toy", False), ("toy-shifted", True)):
        p, lat, jm, js, fr = _toy_frozen(normalize)
        t, tt, tf = jm.tables, convert.tables(jm.tables), convert.fields(fr)
        assert (fr.ln_S is not None) == normalize and (tf.ln_S is not None) == normalize
        out[name] = (
            dict(element=js.element, charge=fr.charge, P=fr.P, etype=fr.etype,
                 neigh_idx=t.act_neigh,
                 kw=dict(act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S)),
            dict(element=T(js.element), charge=tf.charge, P=tf.P, etype=tf.etype,
                 neigh_idx=tt.act_neigh,
                 kw=dict(act_idx=tt.act_idx, abs2act=tt.abs2act, ln_S=tf.ln_S)),
            p.freq,
        )
    return out


def test_compacted_index_ranges(tables):
    """PyTorch raises where JAX clamps an index that is out of range, and
    wraps a negative one: the tables the loops index with stay inside their
    ranges, pads are -1 only where the loops clamp them, and an inactive site
    maps to the last, all-zero pad row, never to -1."""
    _, t, _ = tables["toy"]
    kw = t["kw"]
    n_sites, (n_rows, _) = t["element"].shape[0], t["P"].shape
    act_idx, abs2act, neigh = kw["act_idx"], kw["abs2act"], t["neigh_idx"]
    assert act_idx.min() >= -1 and act_idx.max() < n_sites
    assert neigh.min() >= -1 and neigh.max() < n_sites
    assert abs2act.min() >= 0 and abs2act.max() == n_rows - 1
    active = torch.zeros(n_sites, dtype=torch.bool)
    active[act_idx[act_idx >= 0]] = True
    assert (~active).any() and (abs2act[~active] == n_rows - 1).all()
    assert act_idx[n_rows - 1] == -1 and float(t["P"][n_rows - 1].abs().sum()) == 0.0
    assert torch.equal(abs2act[act_idx[act_idx >= 0]], torch.arange(int((act_idx >= 0).sum())))


def _same_trajectory(rt, rj, time_rtol):
    np.testing.assert_array_equal(rt.element.numpy(), np.asarray(rj.element))
    np.testing.assert_array_equal(rt.charge.numpy(), np.asarray(rj.charge))
    np.testing.assert_array_equal(rt.P.numpy() == 0.0, np.asarray(rj.P) == 0.0)
    np.testing.assert_allclose(rt.P.numpy(), np.asarray(rj.P), rtol=1e-12, atol=0)
    assert rt.n_events == int(rj.n_events) and rt.done == bool(rj.done)
    assert float(rt.event_time) == pytest.approx(float(rj.event_time), rel=time_rtol)
    assert rt.event_time_h == float(rt.event_time)


@pytest.mark.parametrize("clock_f32", [False, True], ids=["f64-clocks", "f32-clocks"])
@pytest.mark.parametrize("mass_eps", [1e-3, 0.1])
@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("name", ["crafted", "toy", "toy-shifted"])
def test_batched_loop_replays_akmc_tpu(tables, name, B, mass_eps, clock_f32):
    j, t, freq = tables[name]
    key = jax.random.PRNGKey(100 * B + int(clock_f32))
    rj = jev.run_event_loop_batched(
        j["element"], j["charge"], j["P"], j["etype"], j["neigh_idx"], key, freq,
        batch=B, mass_eps=mass_eps, clock_f32=clock_f32, **j["kw"])
    draws = tev.ReplayDraws(batched_schedule(key, j["P"].shape[0], B, clock_f32))
    rt = tev.run_event_loop_batched(
        t["element"], t["charge"], t["P"].clone(), t["etype"], t["neigh_idx"], draws, freq,
        batch=B, mass_eps=mass_eps, clock_f32=clock_f32, **t["kw"])
    _same_trajectory(rt, rj, 1e-6 if clock_f32 else 1e-12)
    assert (rt.n_batches, rt.n_cut_conflict, rt.n_cut_mass) == (
        int(rj.n_batches), int(rj.n_cut_conflict), int(rj.n_cut_mass))
    assert rt.n_events >= 1 and rt.done
    assert draws.handed_out == 2 * rt.n_batches       # nothing drawn past the last batch
    assert _counts(rt.element) == _counts(t["element"])


def test_f32_clocks_spin_on_underflowed_rates_as_akmc_tpu_does():
    """With shifted-exponent rates and f32 clocks, once every row that still
    has a rate holds less than f32 can represent (here <= 1e-63 of the
    largest rate at the table's build), all clocks are inf and no candidate
    is valid: the loop makes empty batches until ``max_batches``, in both
    packages, with the same state."""
    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    jm = JModel(p, lat, rate_normalize=True)
    js = j_state(lat, p.background_temp)
    fr = jax.jit(jm._fields)(jm.tables, jm.kop, js.element, js.charge,
                             js.potential_boundary, js.T_bg, 15.0)
    t, tt, tf = jm.tables, convert.tables(jm.tables), convert.fields(fr)
    key = jax.random.PRNGKey(1)
    kw = dict(batch=4, max_batches=48, clock_f32=True)
    rj = jev.run_event_loop_batched(js.element, fr.charge, fr.P, fr.etype, t.act_neigh, key,
                                    p.freq, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fr.ln_S,
                                    **kw)
    rt = tev.run_event_loop_batched(
        T(js.element), tf.charge, tf.P.clone(), tf.etype, tt.act_neigh,
        tev.ReplayDraws(batched_schedule(key, fr.P.shape[0], 4, True)), p.freq,
        act_idx=tt.act_idx, abs2act=tt.abs2act, ln_S=tf.ln_S, **kw)
    _same_trajectory(rt, rj, 1e-6)
    assert (rt.n_batches, rt.done, float(rt.event_time)) == (48, False, 0.0)
    assert rt.n_batches == int(rj.n_batches) and 1 <= rt.n_events < 48
    left = rt.P.sum(dim=1)
    assert (left > 0).any() and not (left.to(torch.float32) > 0).any()


@pytest.mark.parametrize("name", ["crafted", "toy", "toy-shifted"])
def test_native_loop_replays_akmc_tpu(tables, name):
    j, t, freq = tables[name]
    key = jax.random.PRNGKey(5)
    rj = jev.run_event_loop_native(j["element"], j["charge"], j["P"], j["etype"],
                                   j["neigh_idx"], key, freq, **j["kw"])
    draws = tev.ReplayDraws(native_schedule(key))
    rt = tev.run_event_loop_native(t["element"], t["charge"], t["P"].clone(), t["etype"],
                                   t["neigh_idx"], draws, freq, **t["kw"])
    _same_trajectory(rt, rj, 1e-12)
    assert rt.draws_used == int(rj.draws_used) == 2 * rt.n_events
    assert draws.handed_out == rt.n_events >= 2

    # cut off by max_events: not done, and the same state as akmc_tpu's
    rj = jev.run_event_loop_native(j["element"], j["charge"], j["P"], j["etype"],
                                   j["neigh_idx"], key, freq, max_events=1, **j["kw"])
    rt = tev.run_event_loop_native(t["element"], t["charge"], t["P"].clone(), t["etype"],
                                   t["neigh_idx"], tev.ReplayDraws(native_schedule(key)), freq,
                                   max_events=1, **t["kw"])
    _same_trajectory(rt, rj, 1e-12)
    assert rt.n_events == 1


def test_native_loop_shares_the_serial_loop(tables):
    """The mt19937 loop and the native loop are one event step: fed the same
    selection draws they fire the same events (the waiting-time forms differ:
    -log(r) against -log1p(-r))."""
    _, t, freq = tables["toy"]
    kw = t["kw"]
    rand = TRNG(3).uniform(64)
    zero_rows = torch.cat([torch.arange(t["P"].shape[0])[:, None],
                           kw["abs2act"][t["neigh_idx"].clamp(min=0)]], dim=1)
    rs = tev.run_event_loop(t["element"], t["charge"], t["P"].clone(), t["etype"],
                            t["neigh_idx"], torch.from_numpy(rand), freq, kw["act_idx"],
                            kw["abs2act"], zero_rows)
    assert rs.done and rs.n_events >= 2
    pairs = [np.array([rand[2 * i], 1.0 - rand[2 * i + 1]]) for i in range(rs.n_events)]
    rn = tev.run_event_loop_native(t["element"], t["charge"], t["P"].clone(), t["etype"],
                                   t["neigh_idx"], tev.ReplayDraws(pairs), freq, **kw)
    assert torch.equal(rn.element, rs.element) and torch.equal(rn.charge, rs.charge)
    assert torch.equal(rn.P, rs.P) and rn.n_events == rs.n_events
    assert float(rn.event_time) == pytest.approx(float(rs.event_time), rel=1e-9)


def test_replay_source_refuses_a_wrong_vector():
    draws = tev.ReplayDraws([np.zeros(4), np.zeros(3, np.float32)])
    assert draws.uniform((4,), torch.float64, "cpu").shape == (4,)
    with pytest.raises(ValueError, match="asked for"):
        draws.uniform((3,), torch.float64, "cpu")
    with pytest.raises(RuntimeError, match="exhausted"):
        draws.uniform((3,), torch.float64, "cpu")


def test_generator_draws_are_the_callers_generator():
    a = tev.GeneratorDraws.seeded(11, "cpu")
    b = tev.GeneratorDraws.seeded(11, "cpu")
    torch.manual_seed(0)
    u = a.uniform((5,), torch.float64, "cpu")
    torch.manual_seed(1)                                   # the global generator is not used
    assert torch.equal(b.uniform((5,), torch.float64, "cpu"), u)
    assert a.uniform((3,), torch.float32, "cpu").dtype == torch.float32
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


# ------------------- (c) the counterparts of tests/test_events_batched.py
def _run_batched(t, seed, batch, **kw):
    return tev.run_event_loop_batched(
        t["element"], t["charge"], t["P"].clone(), t["etype"], t["neigh_idx"],
        tev.GeneratorDraws.seeded(seed, "cpu"), FREQ, batch=batch, **t["kw"], **kw)


def test_batched_loop_invariants(tables):
    """Termination semantics, conservation invariants, determinism."""
    _, t, _ = tables["crafted"]
    res = _run_batched(t, 0, 8)
    assert res.done and res.n_events >= 1 and res.n_batches >= 1
    assert float(res.event_time) >= 1.0 / FREQ
    assert _counts(res.element) == _counts(t["element"])     # every event class keeps these
    assert res.element.shape == t["element"].shape and res.element.dtype == torch.int32

    res2 = _run_batched(t, 0, 8)                             # determinism under a fixed seed
    assert torch.equal(res2.element, res.element) and res2.n_events == res.n_events
    assert float(res2.event_time) == float(res.event_time)

    res3 = _run_batched(t, 0, 4)     # another batch size: another, valid trajectory
    assert res3.done and _counts(res3.element) == _counts(t["element"])

    res4 = _run_batched(t, 0, 8, max_batches=1)              # stopped by the batch limit
    assert res4.n_batches == 1 and (res4.done or float(res4.event_time) == 0.0)


def test_batched_single_candidate_matches_serial():
    """With exactly one nonzero rate both loops must execute that event and
    then end: on its gap, or on the emptied table with an inf time."""
    n, nn = 32, 4
    neigh = np.full((n, nn), -1, np.int64)
    for i in range(n):
        neigh[i, 0], neigh[i, 1] = (i + 1) % n, (i - 1) % n
    element = np.full(n, int(ELEM.O), np.int32)
    element[5] = int(ELEM.VACANCY)
    charge = np.zeros(n, np.int32)
    charge[5] = 2
    P = np.zeros((n, nn))
    etype = np.full((n, nn), int(EVENT.NULL_EVENT), np.int32)
    P[5, 0] = 3e13                      # V at 5 diffuses to O at 6: the only event
    etype[5, 0] = int(EVENT.VACANCY_DIFFUSION)
    args = lambda: (T(element), T(charge), T(P), T(etype), T(neigh))  # noqa: E731

    res_b = tev.run_event_loop_batched(*args(), tev.GeneratorDraws.seeded(7, "cpu"), FREQ, batch=8)
    res_s = tev.run_event_loop_native(*args(), tev.GeneratorDraws.seeded(1, "cpu"), FREQ)
    assert torch.equal(res_b.element, res_s.element) and torch.equal(res_b.charge, res_s.charge)
    assert res_b.element[5] == int(ELEM.O) and res_b.element[6] == int(ELEM.VACANCY)
    assert res_b.n_events == res_s.n_events == 1
    assert float(res_b.P.sum()) == 0.0                   # the executed pair is zeroed
    for t_end in (float(res_b.event_time), float(res_s.event_time)):
        assert (not np.isfinite(t_end)) or t_end >= 1.0 / FREQ

    # an empty table: event_time = inf, done, no event, one batch
    empty = tev.run_event_loop_batched(T(element), T(charge), T(P * 0.0), T(etype), T(neigh),
                                       tev.GeneratorDraws.seeded(7, "cpu"), FREQ, batch=8)
    assert empty.done and empty.n_events == 0 and empty.n_batches == 1
    assert float(empty.event_time) == np.inf and torch.equal(empty.element, T(element))


def _toy_models(**kw):
    p, lat = toy_device()
    return p, lat, TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)


def test_batched_superstep_statistics_toy():
    """superstep_native_batched on the toy device runs end to end, and over
    several supersteps executes an event total comparable to the serial
    native path from the same initial state (both exact samplers of one law;
    only the draws differ)."""
    p, lat, model = _toy_models()

    def run(step, seed):
        state = convert.state(j_state(lat, p.background_temp))
        draws = tev.GeneratorDraws.seeded(seed, "cpu")
        tot = 0
        for _ in range(6):
            state, stats = step(state, 2.0, draws)
            tot += stats["n_events"]
        return tot, state

    tb, sb = run(lambda s, v, d: model.superstep_native_batched(s, v, d, batch=8), 42)
    ts, ss = run(model.superstep_native, 41)
    assert tb >= 1 and ts >= 1
    assert 0.3 <= (tb + 1) / (ts + 1) <= 3.0
    assert np.isfinite(float(sb.kmc_time)) and float(sb.kmc_time) > 0
    assert _counts(sb.element) == _counts(ss.element)


def test_batched_superstep_raises_when_f32_clocks_cannot_fire(monkeypatch):
    """Rates below f32's range under ``clock_f32``: every clock is infinite,
    the loop (as akmc_tpu's) uses up its batches with no event, ``done`` False
    and a waiting time of 0. The superstep raises instead of handing that to
    a driver whose clock would then never advance; f64 clocks fire."""
    from akmc_tpu_torch.models import vcm

    p, lat, model = _toy_models()
    state = convert.state(j_state(lat, p.background_temp))
    seen = []

    def tiny_rates(element, charge, P, *args, **kw):
        seen.append(tev.run_event_loop_batched(element, charge, P * 1e-60, *args,
                                               max_batches=3, **kw))
        return seen[-1]

    monkeypatch.setattr(vcm, "run_event_loop_batched", tiny_rates)
    draws = tev.GeneratorDraws.seeded(5, "cpu")
    with pytest.raises(RuntimeError, match="without an event"):
        model.superstep_native_batched(state, 2.0, draws, batch=8, clock_f32=True)
    res = seen[0]
    assert (res.done, res.n_events, res.n_batches, res.event_time_h) == (False, 0, 3, 0.0)
    assert torch.equal(res.element, state.element)
    _, stats = model.superstep_native_batched(state, 2.0, draws, batch=8)
    assert stats["done"] and stats["n_events"] >= 1 and stats["event_time"] > 0.0


def test_batched_superstep_returns_undone_when_its_batches_run_out_after_events(monkeypatch):
    """A loop that fires events and then uses up its batches without a
    terminating gap returns, as akmc_tpu's does, ``done`` False and a waiting
    time of 0: the superstep keeps the events and leaves the clock where it
    was (only a loop with no event raises)."""
    from akmc_tpu_torch.models import vcm

    p, lat = build_grid_crossbar(n_yz=8, contact_slices=3, oxide_slices=8, ti_slices=3,
                                 defect_fraction=0.2, vacancy_concentration=0.1, seed=11)
    model = TModel(convert.params(p), convert.lattice(lat), device="cpu", rate_normalize=True)
    state = convert.state(j_state(lat, p.background_temp))
    seen = []

    def few_batches(*args, **kw):
        seen.append(tev.run_event_loop_batched(*args, **{**kw, "max_batches": 3}))
        return seen[-1]

    monkeypatch.setattr(vcm, "run_event_loop_batched", few_batches)
    draws = tev.GeneratorDraws.seeded(5, "cpu")
    new, stats = model.superstep_native_batched(state, 8.0, draws, batch=1)
    res = seen[0]
    assert (res.done, res.n_events, res.n_batches, res.event_time_h) == (False, 3, 3, 0.0)
    assert (stats["done"], stats["n_events"], stats["n_batches"], stats["event_time"]) == (
        False, 3, 3, 0.0)
    assert float(new.kmc_time) == float(state.kmc_time)
    assert torch.equal(new.element, res.element) and not torch.equal(new.element, state.element)


@pytest.fixture(scope="module")
def grid8():
    return build_grid_crossbar(n_yz=8, contact_slices=3, oxide_slices=8, ti_slices=3,
                               defect_fraction=0.2, vacancy_concentration=0.1, seed=11)


PRODUCTION = dict(rate_normalize=True, pair_table_budget=0, pair_tiling_min_n=1)


def test_batched_crossbar_production_regression(grid8):
    """The crossbar production configuration under the batched loop (DIA
    operator, tiled pairwise, shifted rates, 15 V), superstep by superstep
    from akmc_tpu's key: the pinned trajectory of
    tests/test_events_batched.py, reproduced by the port from the replayed
    uniforms."""
    p, lat = grid8
    jm = JModel(p, lat, **PRODUCTION)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu", **PRODUCTION)
    assert tm.dia is not None and tm.tables.pair_tiling is not None
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    key = jax.random.PRNGKey(3)
    n_rows = tm.tables.act_idx.shape[0]
    events = []
    for _ in range(3):
        _, sub = jax.random.split(key)
        js, jst, key = jm.superstep_native_batched(js, 15.0, key, batch=16)
        ts, tst = tm.superstep_native_batched(
            ts, 15.0, tev.ReplayDraws(batched_schedule(sub, n_rows, 16, False)), batch=16)
        for k in ("n_events", "n_batches", "n_cut_conflict", "n_cut_mass"):
            assert tst[k] == jst[k], k
        assert tst["done"] and abs(tst["cg_iterations"] - jst["cg_iterations"]) <= 3
        assert tst["event_time"] == pytest.approx(jst["event_time"], rel=1e-6)
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
        np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))
        events.append(tst["n_events"])
    assert events == [13, 13, 14]
    assert float(ts.kmc_time) == pytest.approx(float(js.kmc_time), rel=1e-6)


def test_native_superstep_replays_akmc_tpu():
    """superstep_native on the toy device from akmc_tpu's key schedule."""
    p, lat = toy_device()
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(7))
    jm = JModel(p, lat)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    key = jax.random.PRNGKey(8)
    for _ in range(3):
        _, sub = jax.random.split(key)
        js, jst, key = jm.superstep_native(js, 2.0, key)
        ts, tst = tm.superstep_native(ts, 2.0, tev.ReplayDraws(native_schedule(sub)))
        assert (tst["n_events"], tst["cg_iterations"]) == (jst["n_events"], jst["cg_iterations"])
        assert tst["event_time"] == pytest.approx(jst["event_time"], rel=1e-7)
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
        np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))


def _run_grid(grid, seed, steps, pass_pb2=True, **kw):
    p, lat = grid
    model = TModel(convert.params(p), convert.lattice(lat), device="cpu", **PRODUCTION)
    state = convert.state(j_state(lat, p.background_temp))
    draws = tev.GeneratorDraws.seeded(seed, "cpu")
    pb2 = None
    out = dict(events=0, batches=0, cg=0)
    for _ in range(steps):
        pb_before = state.potential_boundary
        state, stats = model.superstep_native_batched(
            state, 15.0, draws, batch=16, pb_prev2=pb2 if pass_pb2 else None, **kw)
        pb2 = pb_before
        out["events"] += stats["n_events"]
        out["batches"] += stats["n_batches"]
        out["cg"] += stats["cg_iterations"]
    return out, state


def test_batched_mass_eps_statistics_stable(grid8):
    """A looser mass_eps must never increase the batch count, keeps the event
    totals within a loose statistical factor, and kmc_time finite and
    positive."""
    tight, s_tight = _run_grid(grid8, 3, 3, mass_eps=1e-3)
    loose, s_loose = _run_grid(grid8, 3, 3, mass_eps=0.3)
    assert loose["batches"] <= tight["batches"]
    assert 0.3 <= (loose["events"] + 1) / (tight["events"] + 1) <= 3.0
    for s in (s_tight, s_loose):
        assert np.isfinite(float(s.kmc_time)) and float(s.kmc_time) > 0.0


def test_batched_k_extrap_zero_is_identity_and_nonzero_runs():
    """(d) k_extrap = 0.0 with any pb_prev2 reproduces the plain warm start
    bit for bit; a nonzero coefficient converges to the same tolerance, so
    the event totals stay in the same statistical class."""
    grid = build_grid_crossbar(n_yz=8, contact_slices=3, oxide_slices=8, ti_slices=3,
                               defect_fraction=0.2, vacancy_concentration=0.1, seed=5)
    a, s_a = _run_grid(grid, 9, 4, pass_pb2=False, k_extrap=0.0)     # the default path
    b, s_b = _run_grid(grid, 9, 4, pass_pb2=True, k_extrap=0.0)      # pb2 given, coefficient 0
    assert a == b
    for name in ("element", "charge", "potential_boundary", "potential_charge", "kmc_time"):
        assert torch.equal(getattr(s_a, name), getattr(s_b, name)), name

    c, s_c = _run_grid(grid, 9, 4, k_extrap=1.0)
    assert 0.3 <= (c["events"] + 1) / (a["events"] + 1) <= 3.0
    assert np.isfinite(float(s_c.kmc_time)) and float(s_c.kmc_time) > 0.0


# ------------------------------------------------------- (d) --module-timing
@pytest.mark.parametrize("flags", [{}, dict(use_dia_k=False, pair_table_budget=0,
                                            pair_tiling_min_n=1, qmax=8, vmax=8,
                                            pair_cand_cap=2)],
                         ids=["table", "tiled-caps-grow"])
def test_module_timing_equals_plain_run(flags):
    """``--module-timing`` (the model's spans on, the driver's module times
    taken from the last dispatch's spans): the same state, stats and stream
    position as the plain run, with the five module times beside them,
    finite and nonnegative; a cap overflow redoes the dispatch."""
    p, lat = toy_device()
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(7))
    tp_, tl = convert.params(p), convert.lattice(lat)

    def run(timed):
        model = TModel(tp_, tl, device="cpu", **flags)
        model.spans = timed
        state = convert.state(j_state(lat, p.background_temp))
        stream = TStream(TRNG(1))
        all_stats = []
        for _ in range(3):
            state, stats = model.superstep(state, 2.0, stream)
            if timed:
                tdriver._add_module_times([stats], model.last_spans)
            all_stats.append(stats)
        return model, state, stream, all_stats

    m_a, s_a, st_a, stats_a = run(False)
    m_b, s_b, st_b, stats_b = run(True)
    for name in ("element", "charge", "potential_boundary", "potential_charge", "kmc_time"):
        assert torch.equal(getattr(s_a, name), getattr(s_b, name)), name
    assert st_a.peek(1)[0] == st_b.peek(1)[0]
    assert (m_a.qmax, m_a.vmax, m_a.pair_cand_cap) == (m_b.qmax, m_b.vmax, m_b.pair_cand_cap)
    if flags:
        assert m_b.qmax > 8 and m_b.vmax > 8 and m_b.pair_cand_cap > 2
        assert m_b.step_counts["redos"] > 0
    times = tuple(tdriver.MODULE_SPANS)
    assert times == ("t_charge", "t_boundary", "t_pairwise", "t_rates", "t_events")
    for a, b in zip(stats_a, stats_b):
        assert {k: v for k, v in b.items() if k not in times + ("spans",)} == a
        assert all(0.0 <= b[k] < float("inf") for k in times)
        assert b["spans"]["superstep"]["n"] == 1
    assert sum(s["n_events"] for s in stats_a) >= 3
