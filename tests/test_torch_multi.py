"""k supersteps per call in akmc_tpu_torch, on the CPU.

* ``superstep_multi`` against k sequential ``superstep`` calls of the port
  (bit-equal), and against akmc_tpu's ``superstep_multi`` (integer state
  and CG counts): tests/test_superstep_toy.py::test_superstep_multi_matches_sequential.
* The carried-residual warm K solve (``k_carry_residual``) against the fresh
  one, in the port and against akmc_tpu with the flag on:
  tests/test_superstep_toy.py::test_carried_residual_multi_matches_fresh.
* A batch whose rand windows run out, and caps that grow inside a batch,
  give the sequential run (akmc_tpu replays such a batch step by step:
  tests/test_cap_growth.py:33-80).
* ``superstep_full_multi`` against sequential ``superstep_full`` with the
  power solve's warm start threaded: tests/test_full_physics.py::test_full_multi_matches_sequential.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from tests.test_full_physics import _full_setup
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

STATE_FIELDS = ("element", "charge", "potential_boundary", "potential_charge", "power",
                "temperature", "cb_edge", "T_bg", "kmc_time")


@pytest.fixture(scope="module")
def toy():
    p, lat = toy_device()
    lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(7))
    return p, lat


def _port(p, lat, **kw):
    return TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)


def _sequential(model, state, stream, k, chunk):
    stats = []
    for _ in range(k):
        state, st = model.superstep(state, 2.0, stream, rand_chunk=chunk)
        stats.append(st)
    return state, stats


def _assert_same_state(a, b):
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("chunk", [512, 4], ids=["chunk-512", "windows-run-out"])
def test_superstep_multi_matches_sequential(toy, chunk):
    """k = 3 on one cursor equals three ``superstep`` calls bit for bit. With
    4 draws per window every superstep's loop runs out of its window and
    goes on in the next: still the sequential run of the default chunk."""
    p, lat = toy
    model = _port(p, lat)
    s0 = convert.state(j_state(lat, p.background_temp))
    sa, stats_a = _sequential(model, s0, stream_a := TStream(TRNG(1)), 3, 8192)
    sb, stats_b = model.superstep_multi(s0, 2.0, stream_b := TStream(TRNG(1)), k=3,
                                        rand_chunk=chunk)
    assert stats_b == stats_a
    assert sum(s["n_events"] for s in stats_a) > 3       # more draws than one window of 4
    _assert_same_state(sb, sa)
    assert stream_a.peek(1)[0] == stream_b.peek(1)[0]


def test_superstep_multi_matches_akmc_tpu(toy):
    p, lat = toy
    jm, tm = JModel(p, lat), _port(p, lat)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    jstream, tstream = JStream(JRNG(1)), TStream(TRNG(1))
    for _ in range(2):
        js, jst = jm.superstep_multi(js, 2.0, jstream, k=3, rand_chunk=512)
        ts, tst = tm.superstep_multi(ts, 2.0, tstream, k=3, rand_chunk=512)
        assert [(s["n_events"], s["cg_iterations"]) for s in tst] == [
            (s["n_events"], s["cg_iterations"]) for s in jst]
    np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
    np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))
    assert tstream.peek(1)[0] == jstream.peek(1)[0]


def _carry_run(model, lat, p, batches=3, k=6):
    state = convert.state(j_state(lat, p.background_temp))
    stream = TStream(TRNG(1))
    evs, cgs = [], []
    for _ in range(batches):
        state, sl = model.superstep_multi(state, 2.0, stream, k=k)
        evs += [s["n_events"] for s in sl]
        cgs += [s["cg_iterations"] for s in sl]
    return state, evs, cgs


def test_carried_residual_multi_matches_fresh():
    """On the banded operator the rebased residual reproduces the fresh
    entry matvec's trajectory: events, CG counts, elements and kmc_time equal
    and the boundary potential bit-equal (on converged warm starts both
    return x0), as akmc_tpu's flag does on the same device."""
    p, lat = toy_device()
    fresh = _port(p, lat, use_dia_k=False)
    carry = _port(p, lat, use_dia_k=False, k_carry_residual=True)
    assert carry.banded is not None
    s0, e0, cg0 = _carry_run(fresh, lat, p)
    s1, e1, cg1 = _carry_run(carry, lat, p)
    assert e0 == e1 and cg0 == cg1
    assert torch.equal(s0.element, s1.element)
    assert float(s0.kmc_time) == float(s1.kmc_time)
    assert torch.equal(s0.potential_boundary, s1.potential_boundary)
    assert carry.k_solves == fresh.k_solves == 18

    jm = JModel(p, lat, k_carry_residual=True, use_dia_k=False)
    js = j_state(lat, p.background_temp)
    jstream = JStream(JRNG(1))
    je, jcg = [], []
    for _ in range(3):
        js, sl = jm.superstep_multi(js, 2.0, jstream, k=6)
        je += [s["n_events"] for s in sl]
        jcg += [s["cg_iterations"] for s in sl]
    assert (e1, cg1) == (je, jcg)
    np.testing.assert_array_equal(s1.element.numpy(), np.asarray(js.element))


def test_carry_solve_takes_the_carry():
    """The first step of a batch runs the fresh entry matvec and later steps
    the rebased residual: each ``_fields`` call of a carried batch after the
    first is handed the previous step's carry."""
    p, lat = toy_device()
    model = _port(p, lat, use_dia_k=False, k_carry_residual=True)
    seen = []
    solve = model._solve_boundary_carry

    def spy(element, charge, pb_prev, Vd, carry):
        seen.append(carry)
        return solve(element, charge, pb_prev, Vd, carry)

    model._solve_boundary_carry = spy
    state = convert.state(j_state(lat, p.background_temp))
    model.superstep_multi(state, 2.0, TStream(TRNG(1)), k=3)
    model.superstep_multi(state, 2.0, TStream(TRNG(1)), k=2)
    assert [c is None for c in seen] == [True, False, False, True, False]


@pytest.mark.parametrize("caps", [dict(vmax=8), dict(qmax=8)], ids=["vmax", "qmax"])
def test_caps_grow_inside_a_batch(toy, caps):
    """A cap below the initial population grows inside the first batch and
    the trajectory is the roomy model's, bit for bit (the counterpart of
    tests/test_cap_growth.py's superstep_multi tests)."""
    p, lat = toy
    roomy, small = _port(p, lat), _port(p, lat, **caps)
    s0 = convert.state(j_state(lat, p.background_temp))
    out = []
    for model in (roomy, small):
        state, stream, stats = s0, TStream(TRNG(1)), []
        for _ in range(2):
            state, sl = model.superstep_multi(state, 2.0, stream, k=3, rand_chunk=512)
            stats += sl
        out.append((state, stats))
    name, cap = next(iter(caps.items()))
    assert getattr(small, name) >= 2 * cap
    assert out[1][1] == out[0][1]
    _assert_same_state(out[1][0], out[0][0])


def test_full_multi_matches_sequential():
    """k full-physics supersteps with ``m`` threaded equal k sequential
    ``superstep_full`` calls: stats, every state field, m and the stream."""
    p, lat = _full_setup()
    model = _port(p, lat, vmax=64, ne_max=512)
    s0 = model.update_cb_edge(convert.state(j_state(lat, p.background_temp)), 2.0)
    sa, stream_a, m, stats_a = s0, TStream(TRNG(1)), None, []
    for _ in range(3):
        sa, st, m = model.superstep_full(sa, 2.0, stream_a, m_prev=m, rand_chunk=2048,
                                         rtol_scale=1e-2)
        stats_a.append(st)
    sb, stats_b, mb = model.superstep_full_multi(s0, 2.0, stream_b := TStream(TRNG(1)), k=3,
                                                 rtol_scale=1e-2)
    assert stats_b == stats_a
    assert list(stats_b[0]) == ["n_events", "event_time", "cg_iterations", "I_macro", "T_bg",
                                "power_cg_iterations", "P_tot"]
    _assert_same_state(sb, sa)
    assert torch.equal(mb, m)
    assert stream_a.peek(1)[0] == stream_b.peek(1)[0]


def test_carry_from_akmc_tpu():
    """akmc_tpu's carry (``FieldsResult.k_carry`` through ``convert.fields``)
    rebases the port's next banded solve as it rebases akmc_tpu's: equal CG
    counts, potentials and carried residuals within the superstep tests'
    bounds."""
    p, lat = toy_device()
    jm = JModel(p, lat, use_dia_k=False, k_carry_residual=True)
    tm = _port(p, lat, use_dia_k=False, k_carry_residual=True)
    js = j_state(lat, p.background_temp)
    jf1 = jm._fields(jm.tables, jm.kop, js.element, js.charge, js.potential_boundary,
                     js.T_bg, 2.0, k_carry="init")
    tf1 = convert.fields(jf1)
    assert tf1.k_carry is not None and tm.banded is not None
    # vacancies where there were O atoms: the conductive-vacancy set, and so
    # the matrix, changes
    e2 = np.asarray(lat.element0).copy()
    e2[np.nonzero(e2 == int(ELEM.O))[0][::3]] = int(ELEM.VACANCY)
    js2 = js._replace(element=jnp.asarray(e2))
    ts2 = convert.state(js2)
    jf2 = jm._fields(jm.tables, jm.kop, js2.element, js2.charge, jf1.potential_boundary,
                     js2.T_bg, 2.0, k_carry=jf1.k_carry)
    tf2 = tm._fields(ts2.element, ts2.charge, tf1.potential_boundary, ts2.T_bg, 2.0,
                     k_carry=tf1.k_carry)
    assert tf2.cg_iterations == int(jf2.cg_iterations)
    np.testing.assert_allclose(tf2.potential_boundary.numpy(), np.asarray(jf2.potential_boundary),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(tf2.k_carry.r.numpy(), np.asarray(jf2.k_carry.r),
                               atol=1e-8 * np.abs(np.asarray(jf1.k_carry.r)).max())
