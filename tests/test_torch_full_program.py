"""The full-physics superstep as one program (``models/step_program.py::FullProgram``),
on the CPU.

``VCMModel.superstep_full`` and ``superstep_full_multi`` run the fields, the
power (the W-block build and the power CG), the serial event loop and the heat
model as one program with one read of ``akmc_tpu``'s 12 diagnostics a
superstep, every loop a while loop (on a card one CUDA graph with conditional
while nodes; here the same body, eagerly). Held here:

* the pieces that left the host for it against ``akmc_tpu``'s: the energy
  integral to a device bound (f64 and f32, k steps a pass, the bound below,
  at and past a pass boundary; passes that run past the bound add nothing),
  ``_ct_loop_bound``, ``solve_power`` with a tensor ``Vd`` (both signs
  of zero), the local heat dispatch on a tensor step time (steady and
  transient, at the edges of both);
* the program against the per-loop path (``step_program=False``) bit for
  bit: state, stats, ``m``, the stream; heat off, global and local (steady
  and transient), band and gather, ``wkb_f32``, a cap redone, a window
  continued, a ``superstep_full_multi`` batch kept and one discarded;
* windows that run out against ``akmc_tpu``, which replays such a step on a
  window four times larger where the port continues it: the same events,
  draws and elements, with global heat and both local branches;
* the body reads nothing back and makes no tensor from host data.
"""

import os
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax.config.update("jax_enable_x64", True)
# one PyTorch thread in a process that runs JAX (ROADMAP §3, "CPU test flake")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from akmc_tpu.config import EV_TO_J  # noqa: E402
from akmc_tpu.models.vcm import VCMModel as JModel  # noqa: E402
from akmc_tpu.rng import BufferedStream as JStream  # noqa: E402
from akmc_tpu.rng import ReferenceRNG as JRNG  # noqa: E402
from akmc_tpu.solvers import current as jcur  # noqa: E402
from akmc_tpu.solvers import heat as jheat  # noqa: E402
from akmc_tpu.state import make_device_state as j_state  # noqa: E402
from akmc_tpu_torch import convert  # noqa: E402
from akmc_tpu_torch.lattice import ELEM  # noqa: E402
from akmc_tpu_torch.models.vcm import VCMModel as TModel  # noqa: E402
from akmc_tpu_torch.ops import device_loop  # noqa: E402
from akmc_tpu_torch.rng import BufferedStream as TStream  # noqa: E402
from akmc_tpu_torch.rng import ReferenceRNG as TRNG  # noqa: E402
from akmc_tpu_torch.solvers import current as tcur  # noqa: E402
from akmc_tpu_torch.solvers import heat as theat  # noqa: E402
from tests.test_torch_current import _consts, setup  # noqa: E402,F401
from tests.test_torch_fields import _toy  # noqa: E402

STATE = ("element", "charge", "potential_boundary", "potential_charge", "kmc_time",
         "power", "temperature", "T_bg", "cb_edge")
VD = 5.0
# the energy loop's cap in the supersteps: at 5 V the toy's windows run to
# ~500 steps, so the bound is the cap there (the loop's cost, not its form)
NE_MAX = 64
M_E, V0 = 9.10938356e-31, 3.0   # any effective mass and barrier: the integral's inputs


# ---------------------------------------------------------------------------
# the energy integral to a device bound
# ---------------------------------------------------------------------------
def _pairs(seed=0, shape=(24, 40), max_steps=20):
    """Distances [m] and |dE| [J] whose windows take 1..max_steps steps."""
    rng = np.random.default_rng(seed)
    dist = (3.0 + 10.0 * rng.random(shape)) * 1e-10
    dE = EV_TO_J * 0.01 * (0.3 + (max_steps - 1.3) * rng.random(shape))
    return dist, dE


def _port_integral(dist, dE, n, f32, per=4, in_program=False):
    """The port's integral to the bound ``n``, ``per`` steps a pass, run as
    outside a program (the bound read) or inside one (a device bound)."""
    args = (torch.tensor(dist), torch.tensor(dE), M_E, V0)
    kept, tcur.WKB_PASS_STEPS = tcur.WKB_PASS_STEPS, per
    try:
        if not in_program:
            return tcur._wkb_contact_trap(*args, n, f32=f32)
        with device_loop.recording(device_loop.Recording()):
            return tcur._wkb_contact_trap(*args, torch.tensor(n, dtype=torch.int64), f32=f32)
    finally:
        tcur.WKB_PASS_STEPS = kept


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("per", [1, 3, 16])
def test_energy_integral_device_bound(f32, per):
    """The integral as a while loop of ``per`` steps a pass to a device bound
    (inside a program) equals the host-bounded loop bit for bit, with the
    bound below, at and past a pass boundary, and akmc_tpu's ``fori_loop``
    to a traced bound: f64 to rtol 1e-12 (pow and exp of another library),
    f32 to 2e-6 with a floor of 1e-7 of the largest entry."""
    dist, dE = _pairs()
    j_int = jax.jit(lambda d, e, n: jcur._wkb_contact_trap(d, e, M_E, V0, n, f32=f32))
    bounds = sorted({max(1, per - 1), per, per + 1, 2 * per + 1, 21})
    for n in bounds:
        host = _port_integral(dist, dE, n, f32, per=per)
        dev = _port_integral(dist, dE, n, f32, per=per, in_program=True)
        assert torch.equal(dev, host), n
        want = np.asarray(j_int(jnp.asarray(dist), jnp.asarray(dE), jnp.asarray(n, jnp.int32)))
        assert host.numpy().dtype == want.dtype
        if f32:
            np.testing.assert_allclose(host.numpy(), want, rtol=2e-6,
                                       atol=1e-7 * np.abs(want).max(), err_msg=str(n))
        else:
            np.testing.assert_allclose(host.numpy(), want, rtol=1e-12, atol=0, err_msg=str(n))


def test_passes_past_the_bound_add_nothing():
    """The program's passes of 16 steps run past the bound; the steps there
    are skipped (f32) or add exact zeros (f64), so the sum is the bound's,
    bit for bit, on windows that end exactly at the bound (no step within it
    adds a zero) and on windows that end well inside it."""
    dist, dE_mixed = _pairs()
    # every window ten steps long: no step within the bound adds a zero
    dE_full = EV_TO_J * 0.01 * np.random.default_rng(2).uniform(9.05, 9.95, dist.shape)
    for dE, n in ((dE_full, 10), (dE_mixed, 21)):
        for f32 in (False, True):
            at = _port_integral(dist, dE, n, f32)
            rounded = _port_integral(dist, dE, n, f32, per=16, in_program=True)
            assert torch.equal(rounded, at), (n, f32)


def test_ct_loop_bound_matches_akmc_tpu():
    """The bound as a 0-d device tensor: akmc_tpu's min(ceil(max |dE| *
    (1/dE_step)) + 1, ne_max) over the eligible pairs, below and at the cap,
    on exact multiples of the step and with no pair eligible."""
    rng = np.random.default_rng(1)
    step = EV_TO_J * 0.01
    dE = step * rng.random((16, 30)) * 40.0
    dE[3, 4] = 17.0 * step
    for ok, ne_max in ((rng.random((16, 30)) < 0.5, 2048), (dE <= 17.0 * step, 2048),
                       (np.ones((16, 30), bool), 12), (np.zeros((16, 30), bool), 2048)):
        got = tcur._ct_loop_bound(torch.tensor(dE), torch.tensor(ok), ne_max)
        want = int(jcur._ct_loop_bound(jnp.asarray(dE), jnp.asarray(ok), ne_max))
        assert got.dim() == 0 and got.dtype == torch.int64
        assert int(got) == want


# ---------------------------------------------------------------------------
# solve_power with a tensor bias
# ---------------------------------------------------------------------------
_SYSTEMS = {}


def _system(setup, band):
    """(the port's solve of (Vd, tensor?), akmc_tpu's solve of Vd) on the
    toy's power system built once (energy loop capped at NE_MAX), band or
    gather; akmc_tpu's is one jit with a traced bias."""
    if band in _SYSTEMS:
        return _SYSTEMS[band]
    p, lat, ct, atom_elem, atom_charge, cb = setup
    c = _consts(p)
    args = (False, p.nn_dist, c["high_G"], c["low_G"], c["loop_G"], c["tol"], p.m_e, p.V0)
    n_atom = len(atom_elem)
    G0 = 2 * 3.8612e-5 * 1e-5
    cvac = (atom_elem == int(ELEM.VACANCY)) & (atom_charge == 0)
    lattice = np.asarray(p.lattice, np.float64)
    jps = jcur.build_power_system(
        ct, jnp.asarray(atom_elem), jnp.asarray(atom_charge), jnp.asarray(cb),
        jnp.asarray(lattice), *args, vmax=64, ne_max=NE_MAX)
    tct = convert.current_tables(ct)
    tps, _ = tcur.build_power_system(
        tct, torch.tensor(atom_elem), torch.tensor(atom_charge), torch.tensor(cb),
        torch.tensor(lattice), *args, vmax=64, ne_max=NE_MAX)
    jkw, tkw = {}, {}
    if band:
        bk, meta = jcur.build_power_band(ct, atom_elem, c["high_G"], c["low_G"])
        jkw = dict(band=bk, band_meta=meta, cvac=jnp.asarray(cvac), nn_dist=p.nn_dist,
                   lattice=jnp.asarray(lattice), pbc=False)
        tbk, tmeta = tcur.build_power_band(tct, atom_elem, c["high_G"], c["low_G"])
        tkw = dict(band=tbk, band_meta=tmeta, cvac=torch.tensor(cvac), nn_dist=p.nn_dist,
                   lattice=torch.tensor(lattice), pbc=False)
        grounded = int(tbk.inv_perm[n_atom - 1])

    def port(Vd, tensor):
        kw = dict(tkw, grounded=grounded if band and tensor else None)
        v = torch.tensor(Vd, dtype=torch.float64) if tensor else Vd
        scale = torch.tensor(1.0, dtype=torch.float64) if tensor else 1.0
        I, pw, m, it = tcur.solve_power(tct, tps, v, c["high_G"], c["loop_G"], G0, 1.0,
                                        torch.zeros(n_atom + 2, dtype=torch.float64),
                                        torch.tensor(atom_elem), rtol_scale=scale, **kw)
        return float(I), pw.numpy(), m.numpy(), int(it)

    j_solve = jax.jit(lambda vd: jcur.solve_power(
        ct, jps, vd, c["high_G"], c["loop_G"], G0, 1.0, jnp.zeros(n_atom + 2),
        jnp.asarray(atom_elem), **jkw))

    def ref(Vd):
        I, pw, m, it = j_solve(jnp.asarray(Vd, jnp.float64))
        return float(I), np.asarray(pw), np.asarray(m), int(it)
    _SYSTEMS[band] = port, ref
    return port, ref


@pytest.mark.parametrize("band", [True, False], ids=["band", "gather"])
@pytest.mark.parametrize("Vd", [2.0, -2.0, 0.0, -0.0], ids=["2", "-2", "0", "-0"])
def test_solve_power_tensor_bias(setup, band, Vd):
    """``solve_power`` on a 0-d tensor ``Vd`` and ``rtol_scale`` (the
    grounded slot given, the forward current a device select on Vd >= 0)
    equals the float form bit for bit, at both signs and both zeros, and
    akmc_tpu's ``solve_power``: the same iterations, I_macro to rtol 1e-6 and
    the atom power to 1e-6 (CG sums in another order)."""
    port, ref = _system(setup, band)
    I_f, pw_f, m_f, it_f = port(Vd, tensor=False)
    I_t, pw_t, m_t, it_t = port(Vd, tensor=True)
    assert (I_t, it_t) == (I_f, it_f)
    np.testing.assert_array_equal(pw_t, pw_f)
    np.testing.assert_array_equal(m_t, m_f)
    I_j, pw_j, _, it_j = ref(Vd)
    assert it_t == it_j
    np.testing.assert_allclose(I_t, I_j, rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(pw_t, pw_j, rtol=1e-6, atol=1e-6 * np.abs(pw_j).max() + 1e-300)


# ---------------------------------------------------------------------------
# the local heat dispatch on a device step time
# ---------------------------------------------------------------------------
HEAT = dict(delta_t=1e-12, tau=1e11, background_temp=300.0, nn_dist_m=3.5e-10,
            k_th_interface=0.725, k_th_vacancies=5.0)


@pytest.fixture(scope="module")
def heat_case():
    from akmc_tpu_torch.solvers.heat import build_local_heat

    p, lat = _toy()
    rng = np.random.default_rng(4)
    power = 1e-7 * rng.random(lat.N)
    temp = 300.0 + 10.0 * rng.random(lat.N)
    lh = build_local_heat(lat.neigh_idx, lat.N, p.num_atoms_first_layer * 2)
    jlh = jheat.build_local_heat(np.asarray(lat.neigh_idx), lat.N, p.num_atoms_first_layer * 2)
    return lat, lh, jlh, power, temp


@pytest.mark.parametrize("steps", [0.0, 1.0, 7.0, 1000.0 - 1e-9, 1000.0, 1000.0 + 1e-9, 3e3],
                         ids=["0", "1", "7", "under", "at", "over", "steady"])
def test_local_heat_dispatch_on_device(heat_case, steps):
    """``update_temperature_local_ref`` on a 0-d tensor step time inside a
    program (transient steps a while loop, the steady solve under a cond,
    the branch a device select) equals the host dispatch bit for bit at step
    times of 0, exact multiples of delta_t, and just under, at and over
    1e3 * delta_t, and akmc_tpu's ``lax.cond`` dispatch: the temperature rise
    to rtol 1e-10 (the steady CG's sums in another order)."""
    lat, lh, jlh, power, temp = heat_case
    step_time = steps * HEAT["delta_t"]
    el = torch.tensor(lat.element0, dtype=torch.int32)
    args = (lh, torch.tensor(temp), torch.tensor(power), el)
    kw = dict(HEAT)
    delta_t = kw.pop("delta_t")
    tau = kw.pop("tau")
    host = theat.update_temperature_local_ref(*args, step_time, delta_t, tau, **kw)
    with device_loop.recording(device_loop.Recording()):
        dev = theat.update_temperature_local_ref(
            *args, torch.tensor(step_time, dtype=torch.float64), delta_t, tau, **kw)
    assert torch.equal(dev, host)
    want = np.asarray(jax.jit(lambda t: jheat.update_temperature_local_ref(
        jlh, jnp.asarray(temp), jnp.asarray(power), jnp.asarray(lat.element0), t, delta_t, tau,
        **kw))(jnp.asarray(step_time)))
    rise = want - temp
    assert np.abs(rise).max() > 0
    np.testing.assert_allclose(dev.numpy() - temp, rise, rtol=1e-10,
                               atol=1e-10 * np.abs(rise).max())


# ---------------------------------------------------------------------------
# the full-physics superstep through the program
# ---------------------------------------------------------------------------
def _full(heating="none", delta_t=1e-13, **model_kw):
    """The fields toy at full physics: (params, lattice, model kw)."""
    p, lat = _toy()
    p = p.replace(
        solve_current=True, solve_heating_global=heating == "global",
        solve_heating_local=heating.startswith("local"), dissipation_constant=1e-13,
        t_ox=5e-9, A=(12 * 2.0e-10) ** 2, c_p=1.92, delta_t=delta_t, L_char=3.5e-10,
        k_th_non_vacancy=0.5, k_th_vacancies=5.0,
        num_atoms_contact=p.num_atoms_first_layer * p.num_layers_contact)
    return p, lat, dict(ne_max=NE_MAX, **model_kw)


def _run(p, lat, kw, program, steps=2, multi=0, chunk=None, gather=False, k=2):
    """``steps`` superstep_full calls, then ``multi`` superstep_full_multi
    calls of k, warm starts threaded: (state, stats, m, the stream's next
    draw, the model)."""
    model = TModel(convert.params(p), convert.lattice(lat), device="cpu",
                   step_program=program, **kw)
    if gather:
        model._power_band_built = True
    state = model.update_cb_edge(convert.state(j_state(lat, p.background_temp)), VD)
    stream = TStream(TRNG(1))
    stats, m = [], None
    ck = {} if chunk is None else {"rand_chunk": chunk}
    for i in range(steps):
        state, st, m = model.superstep_full(state, VD, stream, m_prev=m,
                                            rtol_scale=1e-2 if i % 2 else 1.0, **ck)
        stats.append(st)
    for _ in range(multi):
        state, more, m = model.superstep_full_multi(state, VD, stream, k, m_prev=m, **ck)
        stats += more
    return state, stats, m, stream.peek(1)[0], model


def _same(a, b):
    (sa, ta, ma, na, _), (sb, tb, mb, nb, _) = a, b
    assert ta == tb
    assert na == nb
    assert torch.equal(ma, mb)
    for name in STATE:
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name


CASES = {
    "heat-off": ("none", 1e-13, {}, {}),
    "global": ("global", 1e-13, {}, {}),
    "local-steady": ("local", 1e-13, {}, {}),
    "local-transient": ("local", 1e-3, {}, {}),
    "gather": ("global", 1e-13, {}, dict(gather=True)),
    "wkb-f32": ("global", 1e-13, dict(wkb_f32=True), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_full_program_equals_per_loop(case):
    """Two superstep_full calls (the power tolerance switched between them,
    as the driver's "auto" policy switches it) and one superstep_full_multi
    of 2 through the program against the per-loop path: state, stats, m and
    the stream to the bit; every dispatch one program run (one read)."""
    heating, delta_t, model_kw, run_kw = CASES[case]
    p, lat, kw = _full(heating, delta_t, **model_kw)
    prog = _run(p, lat, kw, True, multi=1, **run_kw)
    loops = _run(p, lat, kw, False, multi=1, **run_kw)
    _same(prog, loops)
    counts = prog[-1].step_counts
    assert counts == {"runs": 3, "redos": 0, "continues": 0, "discards": 0, "per_loop": 0}
    assert loops[-1].step_counts["per_loop"] == 3
    assert sum(s["n_events"] for s in prog[1]) > 4
    if case == "local-transient":
        assert prog[0].T_bg == 300.0 and (prog[0].temperature != 300.0).any()
    if case == "global":
        assert float(prog[0].T_bg) > 300.0


def test_full_program_redo_and_continuation():
    """A vmax below the vacancies redoes the step from the same inputs at the
    doubled cap (the outgrown program dropped), and a window of 4 draws runs
    out mid-superstep and goes on in events-only chunks with the heat model
    over the whole event time: the per-loop path's bits."""
    p, lat, kw = _full("local", 1e-3, vmax=8)
    prog = _run(p, lat, kw, True, chunk=4)
    loops = _run(p, lat, kw, False, chunk=4)
    _same(prog, loops)
    counts, model = prog[-1].step_counts, prog[-1]
    assert counts["redos"] >= 1 and counts["continues"] >= 1 and counts["per_loop"] == 0
    assert model.vmax > 8
    assert all(key[3:6] == (model.qmax, model.vmax, model.pair_cand_cap)
               for key in model.step_graphs.programs)


def test_full_multi_discard_equals_per_loop():
    """A superstep_full_multi batch of 3 whose windows run out is discarded
    and replayed step by step (as akmc_tpu replays it), and equals the
    per-loop path's three steps to the bit."""
    p, lat, kw = _full("global")
    prog = _run(p, lat, kw, True, steps=0, multi=1, chunk=4, k=3)
    loops = _run(p, lat, kw, False, steps=0, multi=1, chunk=4, k=3)
    _same(prog, loops)
    counts = prog[-1].step_counts
    assert counts["discards"] >= 1 and counts["continues"] >= 1
    runs = {key[:3]: pr.runs for key, pr in prog[-1].step_graphs.programs.items()}
    assert runs[("full", 3, 4)] == 1 and runs[("full", 1, 4)] == 3 * counts["discards"]


def test_full_program_matches_akmc_tpu():
    """Three superstep_full calls through the program (the power tolerance
    switched in the second) against akmc_tpu's: events, draws and elements
    equal, the power CG's counts equal, I_macro and P_tot to rtol 1e-6 (the
    CGs sum in another order)."""
    p, lat, kw = _full("global")
    jm = JModel(p, lat, ne_max=NE_MAX)
    js = jm.update_cb_edge(j_state(lat, p.background_temp), VD)
    jstream = JStream(JRNG(1))
    ts, tst, _, nt, _ = _run(p, lat, kw, True, steps=3)
    jst, mj = [], None
    for i in range(3):
        js, s, mj = jm.superstep_full(js, VD, jstream, m_prev=mj,
                                      rtol_scale=1e-2 if i % 2 else 1.0)
        jst.append(s)
    assert nt == jstream.peek(1)[0]
    for a, b in zip(tst, jst):
        assert (a["n_events"], a["power_cg_iterations"]) == (b["n_events"],
                                                             b["power_cg_iterations"])
        np.testing.assert_allclose(a["I_macro"], b["I_macro"], rtol=1e-6)
        np.testing.assert_allclose(a["P_tot"], b["P_tot"], rtol=1e-6)
    np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))


def _akmc_tpu_full(p, lat, steps, multi, k, chunk, multi_chunk):
    """akmc_tpu's ``superstep_full`` ``steps`` times on windows of ``chunk``,
    then ``superstep_full_multi`` of k ``multi`` times on ``multi_chunk``
    draws a step: (state, stats, the stream's next draw)."""
    jm = JModel(p, lat, ne_max=NE_MAX)
    js = jm.update_cb_edge(j_state(lat, p.background_temp), VD)
    jstream = JStream(JRNG(1))
    stats, m = [], None
    for i in range(steps):
        js, s, m = jm.superstep_full(js, VD, jstream, m_prev=m, rand_chunk=chunk,
                                     rtol_scale=1e-2 if i % 2 else 1.0)
        stats.append(s)
    for _ in range(multi):
        js, more, m = jm.superstep_full_multi(js, VD, jstream, k, m_prev=m,
                                              rand_chunk=multi_chunk)
        stats += more
    return js, stats, jstream.peek(1)[0]


@pytest.mark.parametrize("heating, delta_t", [("global", 1e-13), ("local", 1e-13),
                                              ("local", 1e-3)],
                         ids=["global", "local-steady", "local-transient"])
def test_window_runs_out_as_akmc_tpu(heating, delta_t):
    """Windows that run out: three superstep_full calls on 4 draws and a
    superstep_full_multi batch of 2 on 3 draws a step, every window too
    short. akmc_tpu throws such a step away and runs it again on a window
    four times larger (a batch: step by step through that path); the port
    goes on in events-only chunks and applies the heat model again over the
    whole event time. Events, draws and elements equal; the power CG's
    counts equal; I_macro, P_tot, T_bg and each site's temperature to the
    rtol 1e-6 of test_full_program_matches_akmc_tpu. At delta_t 1e-13 the
    local model takes its steady branch in three of the five supersteps and
    its transient one (one and two steps) in the other two.

    One batch, not more: the next batch's last superstep (5.1e-13 s) takes
    six transient steps at dt_eff 0.2, which diverge on the toy's lattice in
    both packages (sites near 1e63 K); its rise above 300 K then carries
    f64's ulp(300 K) / rise, about 1e-6, of rounding, amplified, and the two
    packages read 2.8e-6 apart there."""
    p, lat, kw = _full(heating, delta_t)
    model = TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)
    ts = model.update_cb_edge(convert.state(j_state(lat, p.background_temp)), VD)
    stream = TStream(TRNG(1))
    tst, m = [], None
    for i in range(3):
        ts, s, m = model.superstep_full(ts, VD, stream, m_prev=m, rand_chunk=4,
                                        rtol_scale=1e-2 if i % 2 else 1.0)
        tst.append(s)
    ts, more, m = model.superstep_full_multi(ts, VD, stream, 2, m_prev=m, rand_chunk=3)
    tst += more
    counts = model.step_counts
    assert counts["discards"] == 1 and counts["continues"] >= len(tst)
    js, jst, nj = _akmc_tpu_full(p, lat, 3, 1, 2, 4, 3)
    assert stream.peek(1)[0] == nj
    assert len(tst) == len(jst) == 5
    for a, b in zip(tst, jst):
        assert (a["n_events"], a["power_cg_iterations"]) == (b["n_events"],
                                                             b["power_cg_iterations"])
        for key in ("I_macro", "P_tot", "T_bg"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, err_msg=key)
    np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
    np.testing.assert_allclose(float(ts.T_bg), float(js.T_bg), rtol=1e-6)
    np.testing.assert_allclose(ts.temperature.numpy(), np.asarray(js.temperature), rtol=1e-6)
    if heating == "global":
        assert float(ts.T_bg) > 300.0
    else:
        assert (ts.temperature.numpy() != 300.0).any()


class _NoReads(TorchDispatchMode):
    """Refuses every operation that reads a value back to the host (but an
    eager while loop's read of its own flag), and every tensor made from
    host data (``torch.tensor``), which a capture on a card cannot copy; the
    DIA kernels' plain twins, which stand in for the kernels on the CPU, may
    make theirs."""

    READS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.is_nonzero.default,
             torch.ops.aten.item.default, torch.ops.aten.nonzero.default)
    TWINS = (os.path.join("ops", "dia_matvec.py"), os.path.join("solvers", "dia_cg.py"))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS and not device_loop.condition_read():
            raise AssertionError(f"a host read in the program's body: {func}")
        if func is torch.ops.aten.lift_fresh.default and not any(
                f.filename.endswith(self.TWINS) for f in traceback.extract_stack()):
            raise AssertionError("a tensor made from host data in the program's body")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("heating, delta_t, k", [("local", 1e-13, 1), ("local", 1e-3, 2)],
                         ids=["steady", "transient-k2"])
def test_full_body_reads_nothing(heating, delta_t, k, monkeypatch):
    """The program's body under ``_NoReads`` with ``Tensor.item`` and
    ``tolist`` refused gives the diagnostics a dispatch reads: every loop of
    it (energy integral, power CG, K-CG, events, heat) reads only its flag."""
    p, lat, kw = _full(heating, delta_t)
    model = TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)
    state = model.update_cb_edge(convert.state(j_state(lat, p.background_temp)), VD)
    prog = model._full_program(state, k, 8192)
    window = TStream(TRNG(1)).peek(k * 8192)
    m0 = torch.zeros(model.n_atom + 2, dtype=torch.float64)
    prog.load(state, VD, window, m0, 1.0)
    _, want = prog.run()

    def refuse(*args, **kwargs):
        raise AssertionError("a host read in the program's body")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    with _NoReads(), device_loop.recording(device_loop.Recording()):
        _, stats = prog.body()
    monkeypatch.undo()
    got = stats.tolist()[: prog.n_diag]
    assert got == [v for d in want for v in d]
