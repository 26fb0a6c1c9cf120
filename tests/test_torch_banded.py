"""The port's host-side structure code and its banded and ELL K operators
against akmc_tpu on the CPU: the same numpy inputs through both packages.

Tables and integer data (PBC neighbor lists, generators, band codes,
compacted conductive-vacancy lists) must be equal entry for entry. f64 fields
agree to reassociation: band and ELL matvecs to rtol 1e-13; solved potentials
to 1e-8 where both packages stop at the same CG iteration.

The K system is ill-conditioned (kappa ~ 1e8) and the CG's r.z reaches its
stop threshold on a plateau, so on some systems a last-ulp difference of a
dot product moves the stop by a few iterations (akmc_tpu's own banded and ELL
operators are 107 and 110 iterations on ``SENSITIVE`` below). Equal counts are
asserted on the systems where akmc_tpu's two operators agree with each other;
on the sensitive one the port is held to the bound akmc_tpu's own test puts on
its two operators (tests/test_banded.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.lattice import build_lattice as j_build_lattice
from akmc_tpu.lattice import metal_mask
from akmc_tpu.models import crossbar as jxbar
from akmc_tpu.ops.charge import update_charge
from akmc_tpu.rng import ReferenceRNG
from akmc_tpu.solvers import banded as jb
from akmc_tpu.solvers import cg as jcg
from akmc_tpu.solvers import poisson as jp
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import build_k_adjacency, build_neighbor_list
from akmc_tpu_torch.lattice import build_lattice as t_build_lattice
from akmc_tpu_torch.models import crossbar as txbar
from akmc_tpu_torch.solvers import banded as tb
from akmc_tpu_torch.solvers import cg as tcg
from akmc_tpu_torch.solvers import poisson as tp
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

METALS = ["Ti", "N"]
# (nx, ny, nz, contact_layers, vacancy concentration, seed)
STABLE = [(8, 3, 3, 2, 0.25, 3), (10, 4, 4, 2, 0.1, 5)]
SENSITIVE = (10, 4, 4, 2, 0.25, 3)          # the device of tests/test_banded.py
VMAX = 64


def _device(cfg, pbc):
    nx, ny, nz, cl, conc, seed = cfg
    p, lat = toy_device(nx=nx, ny=ny, nz=nz, contact_layers=cl)
    p = p.replace(pbc=pbc)
    element = make_substoichiometric(lat.element0, conc, ReferenceRNG(seed))
    return p, j_build_lattice(element, lat.x, lat.y, lat.z, p)


class System:
    """One toy device with its banded operator and first-superstep charges,
    as akmc_tpu builds them and as convert.py carries them across."""

    def __init__(self, cfg, pbc):
        self.p, self.lat = p, lat = _device(cfg, pbc)
        self.pbc = pbc
        self.pos = np.stack([lat.x, lat.y, lat.z], 1)
        self.is_metal = metal_mask(lat.element0, METALS)
        self.bk, self.meta = jb.build_banded_k(
            self.pos, lat.k_neigh_idx, self.is_metal, lat.element0,
            p.num_atoms_first_layer, p.high_G, p.low_G, block_rows=64)
        jc = np.clip(lat.neigh_idx, 0, None)
        any_metal = (self.is_metal[jc] & (lat.neigh_idx >= 0)).any(axis=1)
        self.charge = np.asarray(update_charge(
            jnp.asarray(lat.element0), jnp.zeros(lat.N, jnp.int32),
            jnp.asarray(lat.neigh_idx), jnp.asarray(any_metal)))
        kj = np.clip(lat.k_neigh_idx, 0, None)
        self.metal_edge = self.is_metal[:, None] & self.is_metal[kj] & (lat.k_neigh_idx >= 0)
        self.tbk, self.tmeta = convert.banded(self.bk, self.meta)
        self.geom = (p.high_G, p.low_G, p.num_atoms_first_layer)

    # the three solves, in each package -------------------------------
    def j_args(self, element=None, charge=None, prev=None):
        lat = self.lat
        return (jnp.asarray(lat.element0 if element is None else element),
                jnp.asarray(self.charge if charge is None else charge),
                jnp.zeros(lat.N) if prev is None else jnp.asarray(prev))

    def t_args(self, element=None, charge=None, prev=None):
        lat = self.lat
        return (torch.tensor(lat.element0 if element is None else element),
                torch.tensor(self.charge if charge is None else charge),
                torch.zeros(lat.N, dtype=torch.float64) if prev is None else torch.tensor(prev))

    def j_band_tail(self):
        return (self.p.nn_dist, jnp.asarray(np.asarray(self.p.lattice)), self.pbc, VMAX)

    def t_band_tail(self):
        return (self.p.nn_dist, torch.tensor(np.asarray(self.p.lattice, np.float64)),
                self.pbc, VMAX)

    def ell(self, Vd, **kw):
        lat = self.lat
        fj, rj = jp.solve_potential_boundary(
            *self.j_args(**kw), jnp.asarray(lat.k_neigh_idx), jnp.asarray(self.metal_edge),
            Vd, *self.geom)
        ft, rt = tp.solve_potential_boundary(
            *self.t_args(**kw), convert.tensor(lat.k_neigh_idx), torch.tensor(self.metal_edge),
            Vd, *self.geom)
        return (np.asarray(fj), int(rj.iterations)), (ft.numpy(), rt.iterations)

    def banded(self, Vd, **kw):
        fj, rj = jb.solve_potential_boundary_banded(
            self.bk, self.meta, *self.j_args(**kw), Vd, *self.geom, *self.j_band_tail())
        ft, rt = tb.solve_potential_boundary_banded(
            self.tbk, self.tmeta, *self.t_args(**kw), Vd, *self.geom, *self.t_band_tail())
        return (np.asarray(fj), int(rj.iterations)), (ft.numpy(), rt.iterations)

    def carry(self, Vd, jcarry=None, tcarry=None, **kw):
        fj, rj, cj = jb.solve_potential_boundary_banded_carry(
            self.bk, self.meta, *self.j_args(**kw), Vd, *self.geom, *self.j_band_tail(),
            carry=jcarry)
        ft, rt, ct = tb.solve_potential_boundary_banded_carry(
            self.tbk, self.tmeta, *self.t_args(**kw), Vd, *self.geom, *self.t_band_tail(),
            carry=tcarry)
        return (np.asarray(fj), int(rj.iterations), cj), (ft.numpy(), rt.iterations, ct)


_systems = {}


def system(cfg, pbc) -> System:
    if (cfg, pbc) not in _systems:
        _systems[cfg, pbc] = System(cfg, pbc)
    return _systems[cfg, pbc]


PBC = pytest.mark.parametrize("pbc", [False, True], ids=["open", "pbc"])


# ---------------------------------------------------------------- host side
@pytest.mark.parametrize("shape", [(8, 3, 3), (10, 4, 4), (6, 2, 5)], ids=str)
def test_pbc_tables_equal_akmc_tpu(shape):
    """The k-d tree neighbor search against akmc_tpu's exhaustive scan: the event
    table never wraps, the K table wraps y/z, both entry for entry; also with
    every coordinate moved out of the periodic cell."""
    p, lat = toy_device(nx=shape[0], ny=shape[1], nz=shape[2])
    p = p.replace(pbc=True)
    jlat = j_build_lattice(lat.element0.copy(), lat.x, lat.y, lat.z, p)
    tlat = t_build_lattice(lat.element0.copy(), lat.x, lat.y, lat.z, convert.params(p))
    np.testing.assert_array_equal(tlat.neigh_idx, jlat.neigh_idx)
    np.testing.assert_array_equal(tlat.k_neigh_idx, jlat.k_neigh_idx)
    np.testing.assert_array_equal(tlat.neigh_idx, lat.neigh_idx)      # pbc leaves it alone
    assert (tlat.k_neigh_idx >= 0).sum() > (tlat.neigh_idx >= 0).sum()
    assert tlat.pbc and tlat.k_neigh_idx.dtype == jlat.k_neigh_idx.dtype

    from akmc_tpu.lattice import build_k_adjacency as j_build_k_adjacency

    pos = np.stack([lat.x, lat.y, lat.z], 1) + np.array([3.0, -7.3, 11.1])
    args = (pos, p.nn_dist, p.max_num_neighbors, np.asarray(p.lattice))
    np.testing.assert_array_equal(build_k_adjacency(*args, True),
                                  j_build_k_adjacency(*args, True))
    np.testing.assert_array_equal(build_k_adjacency(*args, False),
                                  build_neighbor_list(pos, p.nn_dist, p.max_num_neighbors))


@pytest.mark.parametrize("kw", [
    dict(n_yz=6),
    dict(n_yz=7, contact_slices=3, oxide_slices=6, ti_slices=2,
         vacancy_defect_fraction=0.3, seed=1),
    dict(n_yz=8, a=2.0, vacancy_defect_fraction=0.5, seed=9),
], ids=["n6", "n7", "n8"])
def test_synthetic_stack_equals_akmc_tpu(kw):
    want, got = jxbar.synthetic_stack(**kw), txbar.synthetic_stack(**kw)
    for w, g in zip(want[:5], got[:5]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[5] == want[5]


def test_tile_device_equals_akmc_tpu():
    e, x, y, z, lattice, _ = jxbar.synthetic_stack(n_yz=5, oxide_slices=4, contact_slices=2,
                                                   ti_slices=1)
    want = jxbar.tile_device(e, x, y, z, tuple(lattice), 2, 3)
    got = txbar.tile_device(e, x, y, z, tuple(lattice), 2, 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) == 6 * len(e)


@PBC
def test_build_banded_k_equals_akmc_tpu(pbc):
    s = system(SENSITIVE, pbc)
    p, lat = s.p, s.lat
    built = tb.build_banded_k(s.pos, lat.k_neigh_idx, s.is_metal, lat.element0,
                              p.num_atoms_first_layer, p.high_G, p.low_G, block_rows=64)
    assert built is not None
    bk, meta = built
    assert meta == tb.BandMeta(*s.meta)
    assert meta.val_both == p.low_G + (p.high_G - p.low_G)        # summed on the host
    for name in s.bk._fields:
        got, want = getattr(bk, name).numpy(), np.asarray(getattr(s.bk, name))
        np.testing.assert_array_equal(got, want, err_msg=name)    # the static sums too
    assert bk.blocks.dtype == torch.int8 and set(np.unique(bk.blocks.numpy())) == {0, 1, 2}
    assert bk.values(meta).dtype == torch.float64
    assert set(np.unique(bk.values(meta).numpy())) == {0.0, meta.val_low, meta.val_both}


def test_build_banded_k_fallbacks_and_duplicate_edges():
    s = system(SENSITIVE, False)
    p, lat = s.p, s.lat
    args = (s.pos, lat.k_neigh_idx, s.is_metal, lat.element0,
            p.num_atoms_first_layer, p.high_G, p.low_G)
    for kw in (dict(max_bandwidth=1), dict(max_band_bytes=1.0)):
        assert tb.build_banded_k(*args, **kw) is None
        assert jb.build_banded_k(*args, **kw) is None
    assert tb.build_banded_k(s.pos, np.full_like(lat.k_neigh_idx, -1), *args[2:]) is None
    dup = lat.k_neigh_idx.copy()
    row = int(np.nonzero((dup >= 0).sum(1) >= 2)[0][0])
    dup[row, 1] = dup[row, 0]
    with pytest.raises(ValueError, match="duplicate"):
        tb.build_banded_k(s.pos, dup, *args[2:])


# ---------------------------------------------------------------- operators
@PBC
def test_band_matvec_matches_akmc_tpu(pbc):
    s = system(SENSITIVE, pbc)
    x = np.random.RandomState(0).randn(s.lat.N)
    want = np.asarray(jb.band_matvec(s.bk, s.meta, jnp.asarray(x)))
    got = tb.band_matvec(s.tbk, s.tmeta, torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)   # readings: <= 5e-16


@PBC
def test_cvac_correction_equals_akmc_tpu(pbc):
    s = system(SENSITIVE, pbc)
    lat = s.lat
    cvac = (lat.element0 == 2) & (s.charge == 0)
    cvac_p = cvac[np.asarray(s.bk.perm)]
    want = jb.cvac_correction(s.bk, jnp.asarray(cvac_p), *s.j_band_tail())
    got = tb.cvac_correction(s.tbk, torch.tensor(cvac_p), *s.t_band_tail())
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))    # 0/1 planes: exact
    assert int(got[1].sum()) > 0, "toy must exercise the cvac correction"
    # a cap below the population truncates in compact_mask's order
    got8 = tb.cvac_correction(s.tbk, torch.tensor(cvac_p), *s.t_band_tail()[:3], 8)
    np.testing.assert_array_equal(got8[0].numpy(), np.asarray(want[0])[:8])


@PBC
def test_edge_conductance_and_operators_agree(pbc):
    """The ELL action of the whole off-diagonal operator equals akmc_tpu's,
    and the port's band + cvac correction equals its own ELL action (the case
    of tests/test_banded.py::test_band_operator_matches_ell)."""
    s = system(SENSITIVE, pbc)
    p, lat, n = s.p, s.lat, s.lat.N
    elem_t, q_t, _ = s.t_args()
    G = tp.edge_conductance(elem_t, q_t, convert.tensor(lat.k_neigh_idx),
                            torch.tensor(s.metal_edge), p.high_G, p.low_G)
    Gj = jp.edge_conductance(*s.j_args()[:2], jnp.asarray(lat.k_neigh_idx),
                             jnp.asarray(s.metal_edge), p.high_G, p.low_G)
    np.testing.assert_array_equal(G.numpy(), np.asarray(Gj))
    x = np.random.RandomState(0).randn(n)
    valid = lat.k_neigh_idx >= 0
    y_ell = (np.where(valid, G.numpy(), 0.0) * x[np.clip(lat.k_neigh_idx, 0, None)]).sum(1)

    xp = torch.tensor(x)[s.tbk.perm]
    cvac = (elem_t == 2) & (q_t == 0)
    vidx, vv, Wv, _ = tb.cvac_correction(s.tbk, cvac[s.tbk.perm], *s.t_band_tail())
    xv = torch.where(vv, xp[vidx.clamp(min=0)], 0.0)
    corr = (p.high_G - p.low_G) * tcg.f64_matvec(Wv, xv)
    y_p = tb.band_matvec(s.tbk, s.tmeta, xp) + torch.zeros(n, dtype=torch.float64).index_add_(
        0, vidx.clamp(min=0), torch.where(vv, corr, 0.0))
    np.testing.assert_allclose(y_p[s.tbk.inv_perm].numpy(), y_ell, rtol=1e-12, atol=1e-13)


# ---------------------------------------------------------------- solves
@PBC
@pytest.mark.parametrize("cfg", STABLE, ids=["8x3x3", "10x4x4"])
@pytest.mark.parametrize("Vd", [2.0, 5.0])
def test_three_solves_equal_iteration_counts(cfg, pbc, Vd):
    """ELL, banded and the carry solver from a cold start: the CG of each
    stops at akmc_tpu's iteration, potentials to 1e-8 (readings <= 1.7e-9)."""
    s = system(cfg, pbc)
    (ej, ejk), (et, etk) = s.ell(Vd)
    (bj, bjk), (bt, btk) = s.banded(Vd)
    (cj, cjk, _), (ct, ctk, _) = s.carry(Vd)
    assert (etk, btk, ctk) == (ejk, bjk, cjk)
    assert ejk > 10
    for got, want in ((et, ej), (bt, bj), (ct, cj)):
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)
    L = s.p.num_atoms_first_layer
    assert not bt[:L].any() and not bt[-L:].any() and not et[:L].any()   # contacts stay 0
    np.testing.assert_array_equal(ct, bt)          # carry=None is the plain banded solve


@PBC
def test_solves_on_the_sensitive_device(pbc):
    """Where akmc_tpu's own two operators stop 3 iterations apart, each of the
    port's solves is held to the bound tests/test_banded.py puts on those
    two: potentials rtol 1e-5 / atol 1e-7 (readings <= 4.0e-8), counts within
    max(3, a fifth)."""
    s = system(SENSITIVE, pbc)
    (ej, ejk), (et, etk) = s.ell(2.0)
    (bj, bjk), (bt, btk) = s.banded(2.0)
    for got, k, want, kj in ((et, etk, ej, ejk), (bt, btk, bj, bjk), (bt, btk, et, etk)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert abs(k - kj) <= max(3, kj // 5)


@PBC
def test_warm_start_and_carried_residual(pbc):
    """A second solve after the state changed, warm-started from the first:
    through the plain banded solver, through the carry solver with a fresh
    entry matvec, and with the first solve's carry (no entry matvec)."""
    s = system(STABLE[0], pbc)
    (f1j, _, cj), (f1t, _, ct) = s.carry(2.0)
    for name in ("diag", "Wv"):
        np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                   rtol=1e-14, atol=0, err_msg=name)
    # a converged residual is rounding noise: its size carries, not its digits
    np.testing.assert_allclose(ct.r.numpy(), np.asarray(cj.r), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ct.vidx.numpy(), np.asarray(cj.vidx))

    # every other conductive vacancy becomes charged: A changes through diag
    # and S_cvac, the band stays
    charge2 = s.charge.copy()
    cv = np.nonzero((s.lat.element0 == 2) & (s.charge == 0))[0]
    charge2[cv[::2]] = 2
    kw = dict(charge=charge2)
    (pj, pjk), _ = s.banded(2.0, prev=f1j, **kw)
    _, (pt, ptk) = s.banded(2.0, prev=f1t, **kw)
    (wj, wjk, _), _ = s.carry(2.0, jcarry=cj, tcarry=ct, prev=f1j, **kw)
    _, (wt, wtk, ct2) = s.carry(2.0, jcarry=cj, tcarry=ct, prev=f1t, **kw)
    assert 1 < pjk < 60 and (ptk, wtk) == (pjk, wjk)
    # each package warm-starts from its own first solve: readings <= 5.3e-9
    np.testing.assert_allclose(pt, pj, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(wt, wj, rtol=1e-8, atol=1e-8)
    # the rebased residual is the fresh one to rounding: same solution
    np.testing.assert_allclose(wt, pt, rtol=1e-6, atol=1e-8)
    assert ct2.r.shape == ct.r.shape and torch.isfinite(ct2.r).all()

    # unchanged state + carry: converged on entry, the operator is never applied
    calls = []
    real = tb.band_matvec
    tb.band_matvec = lambda *a: calls.append(1) or real(*a)
    try:
        _, (zt, ztk, _) = s.carry(2.0, jcarry=cj, tcarry=ct, prev=f1t)
    finally:
        tb.band_matvec = real
    assert ztk == 1 and not calls
    np.testing.assert_array_equal(zt, f1t)


def test_zero_degree_rows_are_guarded_in_the_ell_solve_only():
    """poisson.py guards rows without any edge (1/diag); banded.py does not
    (akmc_tpu's two files differ in this and the port keeps both)."""
    s = system(STABLE[0], False)
    lat, p = s.lat, s.p
    k = lat.k_neigh_idx.copy()
    lone = lat.N // 2
    k[lone] = -1
    k[k == lone] = -1                              # holes in a row are fine for ELL
    me = s.metal_edge & (k >= 0)
    fj, rj = jp.solve_potential_boundary(*s.j_args(), jnp.asarray(k), jnp.asarray(me),
                                         2.0, *s.geom)
    ft, rt = tp.solve_potential_boundary(*s.t_args(), convert.tensor(k), torch.tensor(me),
                                         2.0, *s.geom)
    assert rt.iterations == int(rj.iterations) and np.isfinite(ft.numpy()).all()
    assert ft[lone] == 0.0
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-8, atol=1e-9)


# ---------------------------------------------------------------- cg.py
def _spd(n=60, seed=4):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    A = M @ M.T + n * np.eye(n)
    return A, rng.randn(n), rng.randn(n)


def test_symscaled_cg_matches_akmc_tpu():
    A, b, x0 = _spd()
    diag = np.diag(A).copy()
    want = jcg.symscaled_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(diag), jnp.asarray(b),
                            jnp.asarray(x0), tol=1e-10)
    At = torch.tensor(A)
    got = tcg.symscaled_cg(lambda v: At @ v, torch.tensor(diag), torch.tensor(b),
                           torch.tensor(x0), tol=1e-10)
    assert got.iterations == int(want.iterations) and 5 < got.iterations < 60
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(A, b), rtol=1e-8, atol=1e-10)
    cut = tcg.symscaled_cg(lambda v: At @ v, torch.tensor(diag), torch.tensor(b),
                           torch.tensor(x0), tol=1e-10, max_iterations=3)
    assert cut.iterations == 3


@pytest.mark.parametrize("dot", [torch.dot, tcg.f64_vdot], ids=["torch.dot", "sum"])
def test_jacobi_cg_r0_and_dot(dot):
    A, b, x0 = _spd()
    At, bt, xt = torch.tensor(A), torch.tensor(b), torch.tensor(x0)
    inv_diag = 1.0 / torch.tensor(np.diag(A).copy())
    op = lambda v: At @ v                                          # noqa: E731
    plain = tcg.jacobi_cg(op, bt, xt, inv_diag, 1e-12, 500, dot_fn=dot)
    given = tcg.jacobi_cg(op, bt, xt, inv_diag, 1e-12, 500, r0=bt - At @ xt, dot_fn=dot)
    assert given.iterations == plain.iterations and torch.equal(given.x, plain.x)
    want = jcg.jacobi_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), jnp.asarray(x0),
                         jnp.asarray(inv_diag.numpy()), 1e-12, 500)
    assert plain.iterations == int(want.iterations)
    np.testing.assert_allclose(plain.x.numpy(), np.asarray(want.x), rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(plain.r.numpy(), np.asarray(want.r), rtol=1e-6, atol=1e-13)
    # a converged start with its residual given: k stays 1, A is never applied
    done = tcg.jacobi_cg(lambda v: 1 / 0, bt, plain.x, inv_diag, 1e-6, 500, r0=plain.r,
                         dot_fn=dot)
    assert done.iterations == 1 and torch.equal(done.x, plain.x)


def test_f64_matvec_both_axes():
    rng = np.random.RandomState(2)
    M, v, w = rng.randn(7, 5), rng.randn(5), rng.randn(7)
    for axis, vec in ((1, v), (0, w)):
        want = np.asarray(jcg.f64_matvec(jnp.asarray(M), jnp.asarray(vec), axis=axis))
        got = tcg.f64_matvec(torch.tensor(M), torch.tensor(vec), axis=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
