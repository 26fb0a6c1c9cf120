"""Three open faults of the port, each run through both packages on the CPU.

* ``k_extrap`` (fault 3.3): from one state, with ``pb_prev2`` and ``pb`` the
  boundary potentials of two serial supersteps, one K solve from the warm
  start pb + c (pb - pb_prev2), c in {0, 1}, in each package
  (akmc_tpu/models/vcm.py:1171; the port's ``superstep_native_batched``).
  With c = 0 both packages take the same CG count, and c = 1 saves akmc_tpu
  no iteration either: the port has no fault there.
* The power CG (fault 3.1) and the banded K-CG of the disordered stand-in
  (fault 3.2), run side by side with every dot product recorded. They start
  from the same right-hand side and preconditioned residual to the bit, stay
  within a few hundred ulps (the sums' orders) for their first iterations,
  and part by more than 1e3 ulps only as rounding grows on their
  ill-conditioned systems. Where each then stops is decided by the rounding
  of the iterations before: the stop rule is the same.

akmc_tpu's CG is a ``lax.while_loop``: its dot products are recorded by a
``jax.debug.callback`` around the dot it is given, which leaves its
arithmetic as it is; the port's by a wrapper around its dot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akmc_tpu.solvers.banded as jbanded
import akmc_tpu.solvers.current as jcurrent
import akmc_tpu_torch.solvers.banded as tbanded
import akmc_tpu_torch.solvers.current as tcurrent
from akmc_tpu.config import KMCParameters as JParams
from akmc_tpu.lattice import build_lattice as j_build_lattice
from akmc_tpu.models.crossbar import build_grid_crossbar, mask_null_slots
from akmc_tpu.models.crossbar import synthesize_deck_structure
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops.charge import update_charge_compact as j_charge
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.runtime.driver import load_structure
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops.charge import update_charge_compact as t_charge
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from akmc_tpu_torch.runtime.synth_deck import write_synth_deck
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

DECK = "decks/iv_sweep_5nm.txt"


def _structure(name):
    if name == "toy":
        p, lat = toy_device()
        lat.element0[:] = make_substoichiometric(lat.element0, 0.2, JRNG(7))
        return p, lat
    return build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                               defect_fraction=0.3, vacancy_concentration=0.1, seed=3)


@pytest.mark.parametrize("name", ["toy", "grid_n6"])
def test_k_extrap_saves_no_iteration_in_akmc_tpu(name):
    """Both packages solve the same K system from the same two warm starts:
    with the plain one (c = 0) their CG counts are equal; the extrapolated one
    (c = 1) saves no iteration in akmc_tpu (measured on the CPU: toy 71 ->
    73, grid_n6 41 -> 41) nor in the port (the same counts), whose counts
    may part from akmc_tpu's by the few iterations by which the rounding of
    two summation orders moves a stop."""
    p, lat = _structure(name)
    Vd = 6.0
    jm = JModel(p, lat)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu")
    ts, stream = convert.state(j_state(lat, p.background_temp)), TStream(TRNG(1))
    ts, _ = tm.superstep(ts, Vd, stream)
    pb_prev2 = ts.potential_boundary
    ts, _ = tm.superstep(ts, Vd, stream)
    pb = ts.potential_boundary
    tq = t_charge(ts.element, ts.charge, tm.tables.neigh_idx, tm.tables.any_metal_nbr, tm.vmax)
    je, jq = jnp.asarray(ts.element.numpy()), jnp.asarray(tq.numpy())
    counts = {}
    for c in (0.0, 1.0):
        start = pb + c * (pb - pb_prev2)
        _, res_j = jm._solve_boundary(jm.kop, jm.tables, je, jq, jnp.asarray(start.numpy()), Vd)
        _, res_t = tm._solve_boundary(ts.element, tq, start, Vd)
        counts[c] = (int(res_j.iterations), res_t.iterations)
    (j0, t0), (j1, t1) = counts[0.0], counts[1.0]
    assert j0 == t0, counts
    assert j1 >= j0 and t1 >= t0, counts
    assert abs(t1 - j1) <= 3, counts


def _recorders(jmodule, tmodule, log):
    """``jacobi_cg`` of each module with every dot product of its solves
    appended to ``log["j"]`` and ``log["t"]``, the arithmetic unchanged (the
    port's other arguments, its programs' cache, passed on)."""
    j_cg, t_cg = jmodule.jacobi_cg, tmodule.jacobi_cg

    def j_recording(A, b, x0, inv_diag, rtol, max_it, r0=None, dot_fn=jnp.dot):
        def dot(u, v):
            out = dot_fn(u, v)
            jax.debug.callback(lambda w: log["j"].append(float(w)), out, ordered=True)
            return out
        return j_cg(A, b, x0, inv_diag, rtol, max_it, r0=r0, dot_fn=dot)

    def t_recording(A, b, x0, inv_diag, rtol, max_it, r0=None, dot_fn=torch.dot, **kw):
        def dot(u, v):
            out = dot_fn(u, v)
            log["t"].append(float(out))
            return out
        return t_cg(A, b, x0, inv_diag, rtol, max_it, r0=r0, dot_fn=dot, **kw)

    return j_recording, t_recording


def _side_by_side(log):
    """(b.b of each, r.z per iteration of each, ulps between them per
    iteration, first iteration at which they part by more than 1e3 ulps).
    The dots of a solve come as b.b, r0.z0, then p.Ap and r.z per iteration."""
    (bj, *dj), (bt, *dt) = log["j"], log["t"]
    rj, rt = dj[0::2], dt[0::2]
    ulps = [abs(a - b) / np.spacing(abs(a)) for a, b in zip(rj, rt)]
    first = next((k for k, u in enumerate(ulps) if u > 1e3), None)
    return (bj, bt), (rj, rt), ulps, first


def test_power_cg_parts_only_as_rounding_grows(monkeypatch):
    """Fault 3.1 on the smallest crossbar that shows it (n_yz = 4, 8 V,
    rtol_scale 1e-4): akmc_tpu stops at 153 iterations and the port at 166.
    Up to iteration 16 the two r.z agree within 64 ulps; they part by more
    than 1e3 ulps at iteration 19 (on the CPU), and from there the gap grows
    about tenfold per iteration: rounding amplified by a system of
    condition number near 3e16, not a different operator."""
    p0 = JParams.from_file(DECK)
    p, e, x, y, z = synthesize_deck_structure(p0, 4)
    e = make_substoichiometric(e, p.initial_vacancy_concentration, JRNG(p.rnd_seed))
    lat = j_build_lattice(e, x, y, z, p)
    mask_null_slots(lat)
    jm = JModel(p, lat, rate_normalize=True, dia_pallas=True, pair_table_budget=0)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu", rate_normalize=True,
                pair_table_budget=0)
    js = jm.update_cb_edge(j_state(lat, p.background_temp), 8.0)
    ts = tm.update_cb_edge(convert.state(j_state(lat, p.background_temp)), 8.0)
    np.testing.assert_array_equal(ts.cb_edge.numpy(), np.asarray(js.cb_edge))
    log = {"j": [], "t": []}
    j_cg, t_cg = _recorders(jcurrent, tcurrent, log)
    monkeypatch.setattr(jcurrent, "jacobi_cg", j_cg)
    monkeypatch.setattr(tcurrent, "jacobi_cg", t_cg)
    _, _, _, it_j = jm.update_power(js, 8.0, rtol_scale=1e-4)
    _, _, _, it_t = tm.update_power(ts, 8.0, rtol_scale=1e-4)
    (bj, bt), (rj, rt), ulps, first = _side_by_side(log)
    assert len(rj) == it_j and len(rt) == it_t
    assert bj == bt and rj[0] == rt[0]          # the same b and the same r0.z0
    assert max(ulps[:17]) <= 64, ulps[:17]
    assert 15 <= first <= 25, (first, ulps[:30])
    assert ulps[first + 5] > 1e5 * ulps[first]   # and then it grows fast
    assert it_j != it_t                          # where they stop: the fault itself


def test_banded_k_cg_parts_only_as_rounding_grows(tmp_path, monkeypatch):
    """Fault 3.2 on the smallest stand-in that shows it
    (``synthetic_stack(n_yz=12)``, N = 7,772, cold K solve at 2 V): akmc_tpu
    stops at 198 iterations, the port at 241. Their first r.z agree to the
    bit and then differ by the dots' summation orders (a few hundred ulps
    over 7,772 terms) until they part by more than 1e3 ulps at iteration 48
    (on the CPU). The stop rule r.z / b.b <= (1e-14 n_int)^2 is then met on a
    plateau: in the last five iterations of each solve r.z / b.b stays
    within a factor of 10 of the threshold, so the rounding of the
    iterations before decides where it is crossed."""
    deck = write_synth_deck(DECK, str(tmp_path), 12)
    p = JParams.from_file(deck)
    e, x, y, z = load_structure(p, str(tmp_path))
    e = make_substoichiometric(e, p.initial_vacancy_concentration, JRNG(p.rnd_seed))
    lat = j_build_lattice(e, x, y, z, p)
    jm = JModel(p, lat, pair_table_budget=0)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu", pair_table_budget=0)
    assert isinstance(jm.kop, jbanded.BandedK) and isinstance(tm.kop, tbanded.BandedK)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    jq = j_charge(js.element, js.charge, jm.tables.neigh_idx, jm.tables.any_metal_nbr, jm.vmax)
    tq = t_charge(ts.element, ts.charge, tm.tables.neigh_idx, tm.tables.any_metal_nbr, tm.vmax)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    log = {"j": [], "t": []}
    j_cg, t_cg = _recorders(jbanded, tbanded, log)
    monkeypatch.setattr(jbanded, "jacobi_cg", j_cg)
    monkeypatch.setattr(tbanded, "jacobi_cg", t_cg)
    _, res_j = jm._solve_boundary(jm.kop, jm.tables, js.element, jq, js.potential_boundary, 2.0)
    _, res_t = tm._solve_boundary(ts.element, tq, ts.potential_boundary, 2.0)
    it_j, it_t = int(res_j.iterations), res_t.iterations
    (bj, bt), (rj, rt), ulps, first = _side_by_side(log)
    assert len(rj) == it_j and len(rt) == it_t
    assert bj == bt
    assert max(ulps[:20]) <= 512, ulps[:20]
    assert 30 <= first <= 60, (first, ulps[:70])
    n_int = lat.N - 2 * p.num_atoms_first_layer
    tol2 = (1e-14 * n_int) ** 2
    for rz, bb in ((rj, bj), (rt, bt)):
        assert all(0.1 < v / bb / tol2 < 10.0 for v in rz[-6:-1]), [v / bb / tol2 for v in rz[-6:]]
    assert it_j != it_t                          # where they stop: the fault itself
