"""The CG device loops of ``akmc_tpu_torch/solvers/cg.py`` (k guarded
iterations per CUDA-graph replay on a card; on the CPU the same step runs
eagerly) against the host loops ``jacobi_cg_plain`` / ``symscaled_cg_plain``,
for every single-device caller: the banded K solve and its carry form, the ELL
K solve, the CB-edge solve, the power CG in band and gather form, the steady
local heat solve and the CG harness. At k = 1, 3 and 32 every CG result (x,
r, residual, iteration count) and every output of the caller must equal the
host loop's to the bit; each caller is also held to ``akmc_tpu`` at the bound
its own test file uses. Small toy devices, inputs from numpy seeds, JAX with
x64, PyTorch on one thread."""

import contextlib

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
# one PyTorch thread in a process that runs JAX (ROADMAP §3, "CPU test flake")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from akmc_tpu.config import EV_TO_J  # noqa: E402
from akmc_tpu.lattice import ELEM  # noqa: E402
from akmc_tpu.rng import ReferenceRNG  # noqa: E402
from akmc_tpu.solvers import current as jcur  # noqa: E402
from akmc_tpu.solvers import heat as jheat  # noqa: E402
from akmc_tpu.state import make_substoichiometric  # noqa: E402
from akmc_tpu_torch import convert  # noqa: E402
from akmc_tpu_torch.ops.device_loop import LoopGraphs  # noqa: E402
from akmc_tpu_torch.solvers import banded as tb  # noqa: E402
from akmc_tpu_torch.solvers import cg as tcg  # noqa: E402
from akmc_tpu_torch.solvers import cg_harness as th  # noqa: E402
from akmc_tpu_torch.solvers import current as tcur  # noqa: E402
from akmc_tpu_torch.solvers import heat as theat  # noqa: E402
from akmc_tpu_torch.solvers import poisson as tp  # noqa: E402
from tests.test_torch_banded import STABLE, system  # noqa: E402
from tests.util_toy import toy_device  # noqa: E402

KS = (1, 3, 32)
CALLERS = (tb, tp, tcur, theat, th)


@contextlib.contextmanager
def cg_as(mode):
    """Every caller's ``jacobi_cg`` and ``symscaled_cg`` as the host loop
    (``mode`` "plain") or as the device loop at k = ``mode``, each result
    appended to the yielded list."""
    log, saved = [], []

    def wrap(name):
        device, plain = getattr(tcg, name), getattr(tcg, name + "_plain")

        def run(*args, graphs=None, **kw):
            res = (plain(*args, **kw) if mode == "plain"
                   else device(*args, graphs=graphs, k=mode, **kw))
            log.append(res)
            return res
        return run

    for mod in CALLERS:
        for name in ("jacobi_cg", "symscaled_cg"):
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, wrap(name))
    try:
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def assert_device_equals_plain(fn, ks=KS):
    """``fn()`` under the host loop and under the device loop at each k: the
    same CG results and outputs to the bit. Returns the host loop's (outputs,
    CG results)."""
    with cg_as("plain") as ref_log:
        ref = fn()
    assert ref_log, "no CG ran"
    for k in ks:
        with cg_as(k) as log:
            out = fn()
        assert [r.iterations for r in log] == [r.iterations for r in ref_log], k
        for a, b in zip(log, ref_log):
            for f in ("x", "r", "residual_sq"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (k, f)
        for a, b in zip(_flat(out), _flat(ref)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), k
    return ref, ref_log


# ---------------------------------------------------------------- K solves
@pytest.mark.parametrize("pbc", [False, True], ids=["open", "pbc"])
def test_banded_and_ell_k_solves(pbc):
    """Cold banded and ELL K solves through one cache of programs, then a
    solve at 0 V from zero (b = 0: r.z / b.b is NaN, one iteration) and one
    cut at ``max_iterations = 0`` (one iteration, as the host loop counts
    it). Against akmc_tpu: equal counts, potentials to 1e-8
    (tests/test_torch_banded.py::test_three_solves_equal_iteration_counts)."""
    s = system(STABLE[0], pbc)
    lat = s.lat
    graphs = LoopGraphs()

    def solves():
        out = []
        for Vd, kw in ((2.0, {}), (0.0, {}), (2.0, {"max_iterations": 0})):
            out.append(tb.solve_potential_boundary_banded(
                s.tbk, s.tmeta, *s.t_args(), Vd, *s.geom, *s.t_band_tail(), graphs=graphs,
                **kw))
            out.append(tp.solve_potential_boundary(
                *s.t_args(), convert.tensor(lat.k_neigh_idx), torch.tensor(s.metal_edge), Vd,
                *s.geom, graphs=graphs, **kw))
        return out

    _, log = assert_device_equals_plain(solves)
    assert [r.iterations for r in log[2:]] == [1, 1, 1, 1]
    assert log[0].iterations > 10 and log[1].iterations > 10
    (bj, bjk), (bt, btk) = s.banded(2.0)
    (ej, ejk), (et, etk) = s.ell(2.0)
    assert (btk, etk) == (bjk, ejk) == (log[0].iterations, log[1].iterations)
    np.testing.assert_allclose(bt, bj, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(et, ej, rtol=1e-8, atol=1e-9)


def test_banded_carry_over_three_warm_solves():
    """The carry form: a fresh solve, then two warm solves each rebased on
    the carry of the one before (r0 given: no entry matvec) after the
    charges changed; the carry's residual is a copy out of the program, so
    the next solve leaves it alone. A warm start from a nonzero potential at
    0 V (b = 0, r.z / b.b infinite) runs to ``max_iterations``."""
    s = system(STABLE[0], False)
    cv = np.nonzero((s.lat.element0 == 2) & (s.charge == 0))[0]
    charges = [s.charge.copy() for _ in range(3)]
    charges[1][cv[::2]] = 2
    charges[2][cv[::3]] = 2
    graphs = LoopGraphs()

    def solves():
        carry, prev, out, kept = None, None, [], []
        for charge in charges:
            args = s.t_args(charge=charge, prev=prev)
            pot, res, carry = tb.solve_potential_boundary_banded_carry(
                s.tbk, s.tmeta, *args, 2.0, *s.geom, *s.t_band_tail(), carry=carry,
                graphs=graphs)
            kept.append((carry.r, carry.r.clone(), res.x, res.x.clone()))
            out += [pot, carry.r, carry.diag]
            prev = pot.numpy()
        assert all(torch.equal(a, b) for r, r0, x, x0 in kept for a, b in ((r, r0), (x, x0)))
        out.append(tb.solve_potential_boundary_banded(
            s.tbk, s.tmeta, *s.t_args(prev=prev), 0.0, *s.geom, *s.t_band_tail(),
            max_iterations=7, graphs=graphs)[0])
        return out

    _, log = assert_device_equals_plain(solves)
    assert 1 < log[1].iterations < log[0].iterations and log[3].iterations == 8
    assert len(graphs.programs) == 3          # one per k: fresh and carried solves share it


# ---------------------------------------------------------------- full physics
def _toy_full():
    p, lat = toy_device(nx=10, ny=3, nz=3, contact_layers=3)
    lat.element0[:] = make_substoichiometric(lat.element0, 0.3, ReferenceRNG(9))
    return p, lat


@pytest.fixture(scope="module")
def power():
    """The power system of tests/test_torch_current.py's toy in both packages."""
    p, lat = _toy_full()
    pos = np.stack([lat.x, lat.y, lat.z], 1)
    n_src = p.num_atoms_first_layer
    ct = jcur.build_current_tables(
        lat.element0, pos, np.asarray(p.lattice), False, p.nn_dist, p.metals, n_src, n_src,
        p.num_layers_contact, max_num_neighbors=p.max_num_neighbors)
    n_atom = int(ct.atom_ind.shape[0])
    rng = np.random.RandomState(2)
    atom_elem = lat.element0[np.asarray(ct.atom_ind)]
    atom_charge = np.where((atom_elem == int(ELEM.VACANCY)) & (rng.rand(n_atom) < 0.5),
                           2, 0).astype(np.int32)
    cb = (np.linspace(1.0, -1.0, n_atom) + 0.05 * rng.randn(n_atom)) * EV_TO_J
    c = dict(high_G=p.high_G * 100000, low_G=p.low_G, loop_G=p.high_G * 10000000,
             tol=p.q * 0.01)
    args = (False, p.nn_dist, c["high_G"], c["low_G"], c["loop_G"], c["tol"], p.m_e, p.V0)
    lattice = np.asarray(p.lattice, np.float64)
    jps = jcur.build_power_system(
        ct, jnp.asarray(atom_elem), jnp.asarray(atom_charge), jnp.asarray(cb),
        jnp.asarray(lattice), *args, vmax=64, ne_max=512)
    tct = convert.current_tables(ct)
    tps, _ = tcur.build_power_system(
        tct, torch.tensor(atom_elem), torch.tensor(atom_charge), torch.tensor(cb),
        torch.tensor(lattice), *args, vmax=64, ne_max=512)
    cvac = (atom_elem == int(ELEM.VACANCY)) & (atom_charge == 0)
    return dict(p=p, c=c, ct=ct, tct=tct, jps=jps, tps=tps, atom_elem=atom_elem, cvac=cvac,
                lattice=lattice, n_atom=n_atom)


G0 = 2 * 3.8612e-5 * 1e-5


def _t_power(w, band, Vd=2.0, rtol_scale=1.0, graphs=None, ps=None, m_prev=None):
    c, tct = w["c"], w["tct"]
    kw = {}
    if band:
        bk, meta = w.setdefault("tband", tcur.build_power_band(tct, w["atom_elem"], c["high_G"],
                                                               c["low_G"]))
        kw = dict(band=bk, band_meta=meta, cvac=torch.tensor(w["cvac"]), nn_dist=w["p"].nn_dist,
                  lattice=torch.tensor(w["lattice"]), pbc=False)
    if m_prev is None:
        m_prev = torch.zeros(w["n_atom"] + 2, dtype=torch.float64)
    return tcur.solve_power(tct, w["tps"] if ps is None else ps, Vd, c["high_G"], c["loop_G"],
                            G0, 1.0, m_prev, torch.tensor(w["atom_elem"]),
                            rtol_scale=rtol_scale, graphs=graphs, **kw)


@pytest.mark.parametrize("band", [True, False], ids=["band", "gather"])
def test_power_cg(power, band):
    """solve_power's CG (multiply + sum dot) in both forms, warm-started from
    its own last solution as a sweep does; then against akmc_tpu: the same
    iteration count, I_macro and the atom power to 1e-6
    (tests/test_torch_current.py::test_solve_power_matches_akmc_tpu)."""
    graphs = LoopGraphs()

    def solves():
        first = _t_power(power, band, graphs=graphs)
        return first, _t_power(power, band, Vd=3.0, rtol_scale=1e-2, graphs=graphs,
                               m_prev=first[2])

    (first, _), log = assert_device_equals_plain(solves)
    assert log[1].iterations > 1
    c, ct = power["c"], power["ct"]
    kw = {}
    if band:
        bk, meta = jcur.build_power_band(ct, power["atom_elem"], c["high_G"], c["low_G"])
        kw = dict(band=bk, band_meta=meta, cvac=jnp.asarray(power["cvac"]),
                  nn_dist=power["p"].nn_dist, lattice=jnp.asarray(power["lattice"]), pbc=False)
    I_j, pw_j, _, it_j = jcur.solve_power(
        ct, power["jps"], 2.0, c["high_G"], c["loop_G"], G0, 1.0,
        jnp.zeros(power["n_atom"] + 2), jnp.asarray(power["atom_elem"]), **kw)
    I_t, pw_t, _, it_t = first
    pw_j = np.asarray(pw_j)
    assert it_t == int(it_j)
    np.testing.assert_allclose(float(I_t), float(I_j), rtol=1e-6)
    np.testing.assert_allclose(pw_t.numpy(), pw_j, rtol=1e-6, atol=1e-6 * np.abs(pw_j).max())


def test_power_programs_are_captured_once_per_key(power):
    """A sweep's bias points reuse one program: another Vd and another
    ``rtol_scale`` (0-d operands of the program, never constants of its
    graph) change the result as they change the host loop's, and add no
    program; a grown vacancy cap (another shape of W_tt) keys a new one."""
    graphs = LoopGraphs()
    runs = [(2.0, 1.0), (5.0, 1.0), (5.0, 1e-3)]
    got = [_t_power(power, True, Vd=Vd, rtol_scale=s, graphs=graphs) for Vd, s in runs]
    assert len(graphs.programs) == 1
    with cg_as("plain"):
        want = [_t_power(power, True, Vd=Vd, rtol_scale=s) for Vd, s in runs]
    for g, w in zip(got, want):
        assert torch.equal(g[2], w[2]) and g[3] == w[3]
    assert got[2][3] > got[1][3] and not torch.equal(got[0][2], got[1][2])
    p, c = power["p"], power["c"]
    ps128, _ = tcur.build_power_system(
        power["tct"], torch.tensor(power["atom_elem"]),
        torch.zeros(power["n_atom"], dtype=torch.int32),
        torch.tensor(np.linspace(1.0, -1.0, power["n_atom"]) * EV_TO_J),
        torch.tensor(power["lattice"]), False, p.nn_dist, c["high_G"], c["low_G"], c["loop_G"],
        c["tol"], p.m_e, p.V0, vmax=128, ne_max=512)
    _t_power(power, True, graphs=graphs, ps=ps128)
    assert len(graphs.programs) == 2


def test_power_scatters_add_one_value_per_index(power):
    """``_scatter_add``'s non-pad indices never repeat (the compacted vacancy
    and contact lists, in both frames), so the card's atomics add one value
    and exact zeros per index: any order gives the same sum."""
    tps, tct = power["tps"], power["tct"]
    bk, _ = tcur.build_power_band(tct, power["atom_elem"], power["c"]["high_G"],
                                  power["c"]["low_G"])
    for idx in (tps.vac_idx, tct.contact_idx, bk.inv_perm[tps.vac_idx.clamp(min=0)][
            tps.vac_idx >= 0], bk.inv_perm[tct.contact_idx.clamp(min=0)][tct.contact_idx >= 0]):
        real = idx[idx >= 0]
        assert real.numel() > 0 and torch.unique(real).numel() == real.numel()


@pytest.mark.parametrize("pbc", [False, True], ids=["open", "pbc"])
def test_cb_edge(pbc):
    """solve_cb_edge's symmetrically scaled CG at two biases, the second
    warm-started from the first's J-scaled profile; against akmc_tpu: the
    same count, the profile within 1e-12 of its largest entry
    (tests/test_torch_current.py::test_cb_edge_matches_akmc_tpu)."""
    from akmc_tpu.lattice import build_lattice, metal_mask
    from akmc_tpu.solvers import poisson as jpoisson

    p, lat = _toy_full()
    if pbc:
        p = p.replace(pbc=True)
        lat = build_lattice(lat.element0, lat.x, lat.y, lat.z, p)
    is_metal = metal_mask(lat.element0, p.metals)
    kj = np.clip(lat.k_neigh_idx, 0, None)
    moe = (is_metal[:, None] | is_metal[kj]) & (lat.k_neigh_idx >= 0)
    graphs = LoopGraphs()

    def solves():
        prev, out = torch.zeros(lat.N, dtype=torch.float64), []
        for Vd in (2.0, 3.0):
            cb, _ = tp.solve_cb_edge(
                torch.tensor(lat.element0), torch.zeros(lat.N, dtype=torch.int32), prev,
                convert.tensor(lat.k_neigh_idx), torch.tensor(moe), Vd,
                p.high_G * 100000, p.low_G, p.num_atoms_first_layer, graphs=graphs)
            out.append(cb)
            prev = cb
        return out

    (_, cb3), log = assert_device_equals_plain(solves)
    elem = jnp.asarray(lat.element0)
    cj2, _ = jpoisson.solve_cb_edge(elem, jnp.zeros_like(elem), jnp.zeros(lat.N),
                                    jnp.asarray(lat.k_neigh_idx), jnp.asarray(moe), 2.0,
                                    p.high_G * 100000, p.low_G, p.num_atoms_first_layer)
    cj, rj = jpoisson.solve_cb_edge(elem, jnp.zeros_like(elem), cj2,
                                    jnp.asarray(lat.k_neigh_idx), jnp.asarray(moe), 3.0,
                                    p.high_G * 100000, p.low_G, p.num_atoms_first_layer)
    cj = np.asarray(cj)
    assert log[1].iterations == int(rj.iterations) > 5
    np.testing.assert_allclose(cb3.numpy(), cj, rtol=0, atol=1e-12 * np.abs(cj).max())


def test_steady_heat():
    """The steady local heat solve, and one with no power (b = 0: one
    iteration); against akmc_tpu: rtol 1e-12 on the rise
    (tests/test_torch_heat.py::test_local_transient_and_steady_match_akmc_tpu)."""
    p, lat = toy_device(nx=10, ny=3, nz=3, contact_layers=3)
    rng = np.random.default_rng(11)
    elem = lat.element0.copy()
    elem[rng.random(lat.N) < 0.2] = int(ELEM.VACANCY)
    power = rng.random(lat.N) * 1e-9
    n_contact = p.num_atoms_first_layer * 3
    local = (300.0, 3.5e-10, 0.725, 5.0)
    temp = 300.0 + np.random.default_rng(5).random(lat.N)
    lt = theat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    graphs = LoopGraphs()

    def solves():
        return [theat.update_temperature_local_steady(
            lt, torch.tensor(temp), torch.tensor(w), torch.tensor(elem), *local, graphs=graphs)
            for w in (power, 0.0 * power)]

    (st, _), log = assert_device_equals_plain(solves)
    assert log[0].iterations > 5 and log[1].iterations == 1
    lj = jheat.build_local_heat(lat.neigh_idx, lat.N, n_contact)
    sj = np.asarray(jheat.update_temperature_local_steady(
        lj, jnp.asarray(temp), jnp.asarray(power), jnp.asarray(elem), *local))
    rise = sj - 300.0
    np.testing.assert_allclose(st.numpy() - 300.0, rise, rtol=1e-12,
                               atol=1e-12 * np.abs(rise).max())


def test_harness_single_device():
    """The CG harness on one device (K- and T-class systems, the transposed
    scatter of repeating indices made in their order by ``index_put_``):
    iterations and relative error equal to the host loop's, and within the
    bounds of tests/test_torch_cg_harness.py."""
    def runs():
        return [th.run(n=1024, devices=1, contrast=1e8, device="cpu"),
                th.run_split(n=1024, n_sub=148, devices=1, device="cpu")]

    for k in ("plain",) + KS:
        with cg_as(k) as log:
            out = runs()
        if k == "plain":
            ref, ref_log = out, log
            continue
        for a, b in zip(out, ref):
            assert (a["iterations"], a["rel_l2_error"]) == (b["iterations"], b["rel_l2_error"])
        for a, b in zip(log, ref_log):
            assert torch.equal(a.x, b.x) and torch.equal(a.r, b.r)
    assert all(r["rel_l2_error"] < 1e-8 and 0 < r["iterations"] < 20000 for r in ref)


# ---------------------------------------------------------------- cg.py itself
def _spd(n=60, seed=4):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    return torch.tensor(M @ M.T + n * np.eye(n)), torch.tensor(rng.randn(n)), \
        torch.tensor(rng.randn(n))


@pytest.mark.parametrize("dot", [torch.dot, tcg.f64_vdot], ids=["torch.dot", "sum"])
def test_operator_programs_both_dots_r0_and_the_cut(dot):
    """``jacobi_cg`` over an ``Operator`` whose matrix is an operand: one
    program for two matrices of one shape, each solve equal to the host
    loop's at k = 1, 3, 32 with both dots, with ``r0`` given, and cut at
    ``max_iterations`` 0 and 5; ``symscaled_cg`` the same."""
    A1, b, x0 = _spd()
    A2 = A1 + torch.diag(torch.linspace(1.0, 9.0, 60, dtype=torch.float64))
    for k in KS:
        graphs = LoopGraphs()
        for M in (A1, A2):
            op = tcg.Operator("dense", lambda v, M_: torch.mv(M_, v), (M,))
            inv_diag = 1.0 / torch.diagonal(M)
            for kw in ({}, {"r0": b - torch.mv(M, x0)}, {"max_iterations": 0},
                       {"max_iterations": 5}):
                kw = {"max_iterations": 500, **kw}
                max_it = kw.pop("max_iterations")
                got = tcg.jacobi_cg(op, b, x0, inv_diag, 1e-12, max_it, dot_fn=dot,
                                    graphs=graphs, k=k, **kw)
                want = tcg.jacobi_cg_plain(op, b, x0, inv_diag, 1e-12, max_it, dot_fn=dot, **kw)
                assert got.iterations == want.iterations == (
                    1 if max_it == 0 else 6 if max_it == 5 else got.iterations)
                for f in ("x", "r", "residual_sq"):
                    assert torch.equal(getattr(got, f), getattr(want, f)), (k, f, kw)
            for max_it in (100000, 3):
                got = tcg.symscaled_cg(op, torch.diagonal(M), b, x0, tol=1e-10,
                                       max_iterations=max_it, dot_fn=dot, graphs=graphs, k=k)
                want = tcg.symscaled_cg_plain(op, torch.diagonal(M), b, x0, tol=1e-10,
                                              max_iterations=max_it, dot_fn=dot)
                assert got.iterations == want.iterations and torch.equal(got.x, want.x)
                assert torch.equal(got.r, want.r)
        assert len(graphs.programs) == 2           # one jacobi and one symscaled program
    with pytest.raises(TypeError):
        tcg.jacobi_cg(lambda v: torch.mv(A1, v), b, x0, inv_diag, 1e-12, 5, graphs=LoopGraphs())


def test_model_owns_its_cg_programs():
    """``VCMModel`` keeps the CG programs in ``cg_graphs``: two supersteps of
    the banded toy model at two biases build one K program, and
    ``cg_step_counts`` says what the device loop did in each (one solve; on
    the CPU one step per replay, no dead step)."""
    from akmc_tpu.state import make_device_state
    from akmc_tpu_torch.models.vcm import VCMModel
    from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG as TRNG

    s = system(STABLE[0], False)
    model = VCMModel(convert.params(s.p), convert.lattice(s.lat), device="cpu", use_dia_k=False)
    assert model.describe()["k_operator"] == "banded"
    state = convert.state(make_device_state(s.lat, s.p.background_temp))
    stream = BufferedStream(TRNG(1))
    for Vd in (2.0, 3.0):
        state, stats = model.superstep(state, Vd, stream)
        counts = model.cg_step_counts
        assert counts["solves"] == 1 and counts["steps"] == counts["replays"]
        assert counts["live_steps"] == stats["cg_iterations"] - 1
    assert len(model.cg_graphs.programs) == 1
