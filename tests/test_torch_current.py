"""The port's full-physics solvers against akmc_tpu's on the same numpy
inputs: the CB-edge Laplace solve, the current solver's atom tables, the WKB
tunnel blocks (f64, f32, chunked) and both operators of ``solve_power``, and
the dense transmission matrix against a scipy LU solve.

The toy device is that of ``tests/test_full_physics.py`` (10 x 3 x 3 slices,
three contact layers, 30% vacancies), with the synthetic CB-edge profile and
charges of ``tests/test_current_oracle.py``."""

import jax
import numpy as np
import pytest
import scipy.linalg
import torch

jax.config.update("jax_enable_x64", True)
# one PyTorch thread in a process that runs JAX (ROADMAP §3, "CPU test flake")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from akmc_tpu.config import EV_TO_J  # noqa: E402
from akmc_tpu.lattice import ELEM  # noqa: E402
from akmc_tpu.rng import ReferenceRNG  # noqa: E402
from akmc_tpu.solvers import current as jcur  # noqa: E402
from akmc_tpu.solvers import poisson as jpoisson  # noqa: E402
from akmc_tpu.state import make_substoichiometric  # noqa: E402
from akmc_tpu_torch import convert  # noqa: E402
from akmc_tpu_torch.solvers import current as tcur  # noqa: E402
from akmc_tpu_torch.solvers import poisson as tpoisson  # noqa: E402

VMAX, NE_MAX = 64, 512


def _toy():
    from tests.util_toy import toy_device

    p, lat = toy_device(nx=10, ny=3, nz=3, contact_layers=3)
    lat.element0[:] = make_substoichiometric(lat.element0, 0.3, ReferenceRNG(9))
    return p, lat


@pytest.fixture(scope="module")
def setup():
    p, lat = _toy()
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
    return p, lat, ct, atom_elem, atom_charge, cb


def _consts(p):
    return dict(high_G=p.high_G * 100000, low_G=p.low_G, loop_G=p.high_G * 10000000,
                tol=p.q * 0.01)


_BUILT = {}


def _build_both(setup, f32=False):
    """(akmc_tpu's PowerSystem, the port's, the port's WkbStats) on the toy,
    built once per (f32, chunk sizes) for the module."""
    key = (f32, tcur._WKB_ROW_BLOCK, jcur._WKB_ROW_BLOCK)
    if key not in _BUILT:
        _BUILT[key] = _build_uncached(setup, f32)
    return _BUILT[key]


def _build_uncached(setup, f32):
    p, lat, ct, atom_elem, atom_charge, cb = setup
    c = _consts(p)
    args = (False, p.nn_dist, c["high_G"], c["low_G"], c["loop_G"], c["tol"], p.m_e, p.V0)
    jps = jcur.build_power_system(
        ct, jnp.asarray(atom_elem), jnp.asarray(atom_charge), jnp.asarray(cb),
        jnp.asarray(np.asarray(p.lattice)), *args, vmax=VMAX, ne_max=NE_MAX, wkb_f32=f32)
    tps, stats = tcur.build_power_system(
        convert.current_tables(ct), torch.tensor(atom_elem), torch.tensor(atom_charge),
        torch.tensor(cb), torch.tensor(np.asarray(p.lattice, np.float64)), *args,
        vmax=VMAX, ne_max=NE_MAX, wkb_f32=f32)
    return jps, tps, stats


@pytest.mark.parametrize("pbc", [False, True])
def test_cb_edge_matches_akmc_tpu(pbc):
    """solve_cb_edge: the Laplace profile within 1e-12 of the largest entry,
    the same CG iteration count, contacts at exactly +-Vd/2 in J; the warm
    start from the previous J-scaled profile (the reference's quirk) too."""
    from akmc_tpu.lattice import build_lattice, metal_mask

    p, lat = _toy()
    if pbc:
        p = p.replace(pbc=True)
        lat = build_lattice(lat.element0, lat.x, lat.y, lat.z, p)
    is_metal = metal_mask(lat.element0, p.metals)
    kj = np.clip(lat.k_neigh_idx, 0, None)
    moe = (is_metal[:, None] | is_metal[kj]) & (lat.k_neigh_idx >= 0)
    elem = jnp.asarray(lat.element0)
    prev = np.zeros(lat.N)
    for Vd in (2.0, 3.0):
        common = (Vd, p.high_G * 100000, p.low_G, p.num_atoms_first_layer)
        cj, rj = jpoisson.solve_cb_edge(elem, jnp.zeros_like(elem), jnp.asarray(prev),
                                        jnp.asarray(lat.k_neigh_idx), jnp.asarray(moe), *common)
        ct_, rt = tpoisson.solve_cb_edge(
            torch.tensor(lat.element0), torch.zeros(lat.N, dtype=torch.int32),
            torch.tensor(prev), convert.tensor(lat.k_neigh_idx), torch.tensor(moe), *common)
        cj = np.asarray(cj)
        assert rt.iterations == int(rj.iterations)
        np.testing.assert_allclose(ct_.numpy(), cj, rtol=0, atol=1e-12 * np.abs(cj).max())
        L = p.num_atoms_first_layer
        assert (ct_[:L] == Vd / 2 * EV_TO_J).all() and (ct_[-L:] == -Vd / 2 * EV_TO_J).all()
        prev = cj


@pytest.mark.parametrize("pbc", [False, True])
def test_current_tables_equal_akmc_tpu(pbc):
    """The atom tables entry for entry: the atom adjacency of the port's k-d
    tree (kept by _block_dist2's squared rule) against akmc_tpu's
    build_neighbor_list_device, open and with pbc = 1, and every mask,
    index list and rail count."""
    p, lat = _toy()
    pos = np.stack([lat.x, lat.y, lat.z], 1)
    args = (lat.element0, pos, np.asarray(p.lattice), pbc, p.nn_dist, p.metals,
            p.num_atoms_first_layer, p.num_atoms_first_layer - 2, p.num_layers_contact,
            p.max_num_neighbors)
    j = jcur.build_current_tables(*args)
    t = tcur.build_current_tables(*args)
    for name in j._fields:
        a, b = getattr(j, name), getattr(t, name)
        if name in ("n_inj", "n_ext"):
            assert a == b, name
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    if pbc:   # the periodic table differs from the open one on this cell
        open_ = tcur.build_current_tables(*args[:3], False, *args[4:])
        assert not torch.equal(open_.atom_neigh_idx, t.atom_neigh_idx)


def test_squared_rule_parts_from_site_dist_at_the_cutoff():
    """Where |d| sits on the cutoff, d^2 < c^2 and sqrt(d^2) < c can part:
    the squared table follows _block_dist2 there."""
    from akmc_tpu.lattice_jax import build_neighbor_list_device

    from akmc_tpu_torch.lattice import build_neighbor_list

    rng = np.random.default_rng(3)
    pos = np.cumsum(rng.random((400, 3)) * 0.7, axis=0) % 6.0
    # pairs at the cutoff to the last bit, both sides
    c = 1.1
    pos[1] = pos[0] + np.array([np.nextafter(c, 0.0), 0.0, 0.0])
    pos[3] = pos[2] + np.array([0.6, np.sqrt(c * c - 0.36), 0.0])
    got = build_neighbor_list(pos, c, 64, squared=True)
    np.testing.assert_array_equal(got, build_neighbor_list_device(pos, c, 64))


@pytest.mark.parametrize("f32", [False, True])
def test_wkb_blocks_match_akmc_tpu(setup, f32):
    """W_tt, W_ct, W_cc, G_nbr, the diagonal and the vacancy list against
    akmc_tpu's build_power_system. f64: rtol 1e-12 (pow and exp of another
    library); f32 (wkb_f32): the blocks stay f32, rtol 2e-6 with a floor of
    1e-7 of the largest entry (an f32 exponent's rounding, amplified by exp),
    the Kahan-compensated integral included."""
    jps, tps, stats = _build_both(setup, f32)
    assert len(stats.ct_bounds) == 1 and 1 < stats.ct_bounds[0] <= NE_MAX
    np.testing.assert_array_equal(tps.vac_idx.numpy(), np.asarray(jps.vac_idx))
    np.testing.assert_array_equal(tps.G_nbr.numpy(), np.asarray(jps.G_nbr))
    for name in ("W_tt", "W_ct", "W_cc", "diag"):
        a, b = np.asarray(getattr(jps, name)), getattr(tps, name).numpy()
        assert b.dtype == a.dtype, name
        scale = np.abs(a).max()
        assert scale > 0, name
        if f32:
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-7 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0, err_msg=name)
    assert (tps.diag0, tps.diag1) == (float(jps.diag0), float(jps.diag1))


@pytest.mark.parametrize("f32", [False, True])
def test_wkb_chunked_build_matches_direct(setup, monkeypatch, f32):
    """With the chunk size shrunk to 16 (as akmc_tpu's test shrinks it) the
    column-chunked integral and the row-chunked blocks equal the direct build
    entry for entry; each integrated chunk runs to its own bound. The
    chunked f32 build equals akmc_tpu's chunked f32 build as the direct ones
    agree (the Kahan sum runs to the same per-chunk bounds)."""
    direct = _build_both(setup, f32)[1]
    monkeypatch.setattr(tcur, "_WKB_ROW_BLOCK", 16)
    monkeypatch.setattr(jcur, "_WKB_ROW_BLOCK", 16)
    jps, tps, stats = _build_both(setup, f32)
    assert len(stats.ct_bounds) >= 4
    for name in ("W_tt", "W_ct", "W_cc", "diag"):
        a, b = getattr(direct, name), getattr(tps, name)
        if f32 and name in ("W_ct", "diag"):
            # the compensated sum may end on other bounds per chunk
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-6,
                                       atol=1e-7 * float(a.abs().max()), err_msg=name)
            np.testing.assert_allclose(b.numpy(), np.asarray(getattr(jps, name)), rtol=2e-6,
                                       atol=1e-7 * float(a.abs().max()), err_msg=name)
        else:
            assert torch.equal(a, b), f"{name} differs under chunking"


def _solve(setup, band: bool, port: bool, f32=False, rtol_scale=1.0):
    """One solve_power at 2 V through akmc_tpu or the port, band or gather."""
    p, lat, ct, atom_elem, atom_charge, cb = setup
    c = _consts(p)
    jps, tps, _ = _build_both(setup, f32)
    n_atom = len(atom_elem)
    G0 = 2 * 3.8612e-5 * 1e-5
    cvac = (atom_elem == int(ELEM.VACANCY)) & (atom_charge == 0)
    if port:
        tct = convert.current_tables(ct)
        kw = {}
        if band:
            bk, meta = tcur.build_power_band(tct, atom_elem, c["high_G"], c["low_G"])
            kw = dict(band=bk, band_meta=meta, cvac=torch.tensor(cvac), nn_dist=p.nn_dist,
                      lattice=torch.tensor(np.asarray(p.lattice, np.float64)), pbc=False)
        I, pw, m, it = tcur.solve_power(tct, tps, 2.0, c["high_G"], c["loop_G"], G0, 1.0,
                                        torch.zeros(n_atom + 2, dtype=torch.float64),
                                        torch.tensor(atom_elem), rtol_scale=rtol_scale, **kw)
        return float(I), pw.numpy(), m.numpy(), it
    kw = {}
    if band:
        bk, meta = jcur.build_power_band(ct, atom_elem, c["high_G"], c["low_G"])
        kw = dict(band=bk, band_meta=meta, cvac=jnp.asarray(cvac), nn_dist=p.nn_dist,
                  lattice=jnp.asarray(np.asarray(p.lattice)), pbc=False)
    I, pw, m, it = jcur.solve_power(ct, jps, 2.0, c["high_G"], c["loop_G"], G0, 1.0,
                                    jnp.zeros(n_atom + 2), jnp.asarray(atom_elem),
                                    rtol_scale=rtol_scale, **kw)
    return float(I), np.asarray(pw), np.asarray(m), int(it)


@pytest.mark.parametrize("band", [True, False], ids=["band", "gather"])
def test_solve_power_matches_akmc_tpu(setup, band):
    """Each operator of solve_power against the same operator of akmc_tpu:
    the same CG iteration count, I_macro to rtol 1e-6 and the atom power to
    1e-6 (the two CGs differ in the order of their sums only), the grounded
    atom at exactly 0 on the band path."""
    I_j, pw_j, m_j, it_j = _solve(setup, band, port=False)
    I_t, pw_t, m_t, it_t = _solve(setup, band, port=True)
    assert it_t == it_j
    np.testing.assert_allclose(I_t, I_j, rtol=1e-6)
    np.testing.assert_allclose(pw_t, pw_j, rtol=1e-6, atol=1e-6 * np.abs(pw_j).max())
    if band:
        assert m_t[-1] == 0.0


def test_solve_power_band_matches_gather(setup):
    """The port's two operators solve the same system: I_macro to 1e-5 and
    the atom power to 1e-5, as akmc_tpu's own band and gather agree
    (tests/test_current_oracle.py)."""
    I_b, pw_b, _, _ = _solve(setup, True, port=True)
    I_g, pw_g, _, _ = _solve(setup, False, port=True)
    np.testing.assert_allclose(I_b, I_g, rtol=1e-5)
    np.testing.assert_allclose(pw_b, pw_g, rtol=1e-5, atol=1e-30)


def test_solve_power_f32_blocks_and_rtol_scale(setup):
    """Under wkb_f32 the port's solve lands within 1e-4 of akmc_tpu's f32
    solve (as akmc_tpu's f32 and f64 solves agree); a tighter ``rtol_scale``
    runs more iterations, as many as akmc_tpu's."""
    I_j, _, _, _ = _solve(setup, True, port=False, f32=True)
    I_t, _, _, _ = _solve(setup, True, port=True, f32=True)
    np.testing.assert_allclose(I_t, I_j, rtol=1e-4)
    _, _, _, it_loose = _solve(setup, True, port=True)
    I_tj, _, _, it_tj = _solve(setup, True, port=False, rtol_scale=1e-4)
    I_tt, _, _, it_tt = _solve(setup, True, port=True, rtol_scale=1e-4)
    assert it_tt > it_loose and it_tt == it_tj
    np.testing.assert_allclose(I_tt, I_tj, rtol=1e-8)


def test_dense_X_matches_akmc_tpu_and_scipy_lu(setup):
    """assemble_dense_X against akmc_tpu's (rtol 1e-12), and its leading
    principal block solved by scipy's LU against the port's gather-operator
    CG: the potentials on the strongly coupled rows to 1e-6 and I_macro to
    1e-4 (akmc_tpu's own CG-against-LU bounds)."""
    p, lat, ct, atom_elem, atom_charge, cb = setup
    c = _consts(p)
    args = (False, p.nn_dist, c["high_G"], c["low_G"], c["loop_G"], c["tol"], p.m_e, p.V0)
    Xj = np.asarray(jcur.assemble_dense_X(
        ct, jnp.asarray(atom_elem), jnp.asarray(atom_charge), jnp.asarray(cb),
        jnp.asarray(np.asarray(p.lattice)), *args, ne_max=NE_MAX))
    tct = convert.current_tables(ct)
    Xt = tcur.assemble_dense_X(tct, torch.tensor(atom_elem), torch.tensor(atom_charge),
                               torch.tensor(cb), torch.tensor(np.asarray(p.lattice, np.float64)),
                               *args, ne_max=NE_MAX).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-12, atol=1e-12 * np.abs(Xj).max())

    n_atom = len(atom_elem)
    Vd, G0 = 2.0, 2 * 3.8612e-5 * 1e-5
    b = np.zeros(n_atom + 1)
    b[0], b[1] = -c["loop_G"] * Vd, c["loop_G"] * Vd
    m_lu = np.zeros(n_atom + 2)
    m_lu[: n_atom + 1] = scipy.linalg.lu_solve(scipy.linalg.lu_factor(Xt[: n_atom + 1, : n_atom + 1]), b)
    ext = tct.ext_tie.numpy()
    I_ref = float(np.sum(np.where(ext, -c["high_G"] * (m_lu[0] - m_lu[2:]) * G0, 0.0)))
    I, _, m, _ = _solve(setup, False, port=True)
    _, tps, _ = _build_both(setup)
    d = np.concatenate([[tps.diag0, tps.diag1], tps.diag.numpy()[:-1]])
    strong = d > 1e-3 * c["high_G"]
    np.testing.assert_allclose(m[: n_atom + 1][strong], m_lu[: n_atom + 1][strong],
                               rtol=1e-6, atol=1e-7)
    assert I_ref != 0.0
    np.testing.assert_allclose(I, I_ref, rtol=1e-4)
