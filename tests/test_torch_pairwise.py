"""The port's on-the-fly and tiled pairwise paths against akmc_tpu on the CPU
(the tiled path here is the plain twin of csrc/pair_tiled.cu).

The same positions and charges go through both packages. The tilings and the
per-tile candidate lists are integer data and must be equal entry for entry
(the candidate order is the summation order of the tiled plane). Potentials
agree to reassociation and to the last ulps of erfc (torch.special.erfc and
jax.scipy.special.erfc differ there): rtol 1e-13 in f64, as for the static
table in tests/test_torch_ops.py; the f32 plane to f32 roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.models.vcm import _max_in_reach_count as j_max_in_reach_count
from akmc_tpu.ops import pairwise as jpw
from akmc_tpu.rng import ReferenceRNG
from akmc_tpu.state import make_substoichiometric
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.models.vcm import _max_in_reach_count
from akmc_tpu_torch.ops import pairwise as tpw
from tests.util_toy import toy_device

# see tests/test_torch_superstep.py: PyTorch on the calling thread only
torch.set_num_threads(1)

QMAX = 64


@pytest.fixture(scope="module")
def toy():
    """The device of tests/test_ops_oracle.py with its charges."""
    p, lat = toy_device(nx=8, ny=3, nz=3)
    lat.element0[:] = make_substoichiometric(lat.element0, 0.25, ReferenceRNG(3))
    charge = np.zeros(lat.N, np.int32)
    charge[lat.element0 == int(ELEM.VACANCY)] = 2
    charge[lat.element0 == int(ELEM.OXYGEN_DEFECT)] = -2
    return p, np.stack([lat.x, lat.y, lat.z], 1), charge


@pytest.fixture(scope="module")
def big():
    """A larger device with charges of mixed sign drawn from a seed."""
    p, lat = toy_device(nx=14, ny=6, nz=5)
    rng = np.random.RandomState(12)
    charge = np.zeros(lat.N, np.int32)
    oxide = np.nonzero(lat.element0 != int(ELEM.Ti))[0]
    picked = rng.choice(oxide, 50, replace=False)
    charge[picked] = rng.choice([2, -2, 1], 50)
    return p, np.stack([lat.x, lat.y, lat.z], 1), charge


def _phys(p):
    return p.cutoff_radius, p.sigma, p.k


@pytest.mark.parametrize("which", ["toy", "big"])
def test_pairwise_potential_matches_akmc_tpu(which, request):
    p, pos, charge = request.getfixturevalue(which)
    want, w_ovf = jpw.pairwise_potential(jnp.asarray(pos), jnp.asarray(charge), *_phys(p),
                                         qmax=QMAX)
    got, g_ovf = tpw.pairwise_potential(torch.tensor(pos), torch.tensor(charge), *_phys(p),
                                        qmax=QMAX)
    assert not bool(w_ovf) and not bool(g_ovf)
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-20)
    # rows are independent: any partition into row blocks gives the same values
    for kw in (dict(row_block=7), dict(plane_budget=1)):
        part, _ = tpw.pairwise_potential(torch.tensor(pos), torch.tensor(charge), *_phys(p),
                                         qmax=QMAX, **kw)
        assert torch.equal(part, got)


def test_pairwise_potential_overflow_flag(toy):
    p, pos, charge = toy
    n_charged = int((charge != 0).sum())
    for qmax in (n_charged, n_charged - 1):
        _, want = jpw.pairwise_potential(jnp.asarray(pos), jnp.asarray(charge), *_phys(p),
                                         qmax=qmax)
        _, got = tpw.pairwise_potential(torch.tensor(pos), torch.tensor(charge), *_phys(p),
                                        qmax=qmax)
        assert bool(got) == bool(want) == (qmax < n_charged)


def test_on_the_fly_equals_the_static_table(big):
    """Inside the port the table is the on-the-fly plane with the charge
    multiply deferred: one reassociation apart."""
    p, pos, charge = big
    pos_t = torch.tensor(pos)
    rows = torch.arange(pos.shape[0])
    table = tpw.build_pair_table(pos_t, rows, *_phys(p))
    from_table, _ = tpw.pairwise_potential_table(table, rows, torch.tensor(charge), QMAX)
    fly, _ = tpw.pairwise_potential(pos_t, torch.tensor(charge), *_phys(p), qmax=QMAX)
    np.testing.assert_allclose(from_table.numpy(), fly.numpy(), rtol=1e-13, atol=1e-20)


@pytest.mark.parametrize("which,edge", [("toy", 4.0), ("toy", None), ("big", 3.05)])
def test_build_pair_tiling_equals_akmc_tpu(which, edge, request):
    p, pos, _ = request.getfixturevalue(which)
    want, w_r = jpw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=edge)
    got, g_r = tpw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=edge)
    assert g_r == w_r
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    sites = got.tile_sites.numpy()
    assert sorted(sites[sites >= 0]) == list(range(pos.shape[0]))   # each site in one slot


def _akmc_tpu_candidates(tiling, r_tile, pos, charge, cutoff_radius, qmax, cand_cap):
    """The candidate selection of akmc_tpu's pairwise_potential_tiled
    (ops/pairwise.py: the f32 reach filter and lax.top_k on the 0/1 mask),
    which that function keeps to itself."""
    from akmc_tpu.ops.compact import compact_mask

    q_idx, qv = compact_mask(charge != 0, qmax)
    q_pos = pos[q_idx.clip(0)]
    cen32 = tiling.tile_center.astype(jnp.float32)
    qp32 = q_pos.astype(jnp.float32)
    pad = jnp.float32(1e-3) + 64.0 * jnp.float32(1.2e-7) * jnp.max(jnp.abs(cen32))
    reach = (jnp.float32(cutoff_radius + r_tile) + pad) ** 2
    d2c = jnp.sum((cen32[:, None, :] - qp32[None, :, :]) ** 2, axis=-1)
    mask = (d2c < reach) & qv[None, :]
    mv, ci = jax.lax.top_k(mask.astype(jnp.int32), min(cand_cap, qmax))
    return np.asarray(mv) > 0, np.asarray(ci), bool(jnp.max(jnp.sum(mask, axis=1)) > cand_cap)


@pytest.mark.parametrize("which,edge,cap", [("toy", 4.0, 64), ("toy", 4.0, 5), ("big", 3.05, 50),
                                            ("big", 3.05, 16)])
def test_candidate_lists_equal_akmc_tpu(which, edge, cap, request):
    """Selected and unselected slots alike: in-reach entries first, each
    group in ascending list position, as top_k on a 0/1 mask orders them."""
    p, pos, charge = request.getfixturevalue(which)
    jt, r_tile = jpw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=edge)
    w_sel, w_cand, w_ovf = _akmc_tpu_candidates(jt, r_tile, jnp.asarray(pos), jnp.asarray(charge),
                                                p.cutoff_radius, QMAX, cap)
    tt = convert.pair_tiling(jt)
    _, qv, q_pos, _, _ = tpw._charged_list(torch.tensor(pos), torch.tensor(charge), QMAX)
    sel, cand, ovf = tpw.tile_candidates(tt, r_tile, q_pos, qv, p.cutoff_radius, cap)
    np.testing.assert_array_equal(sel.numpy(), w_sel)
    np.testing.assert_array_equal(cand.numpy(), w_cand)
    assert bool(ovf) == w_ovf
    assert w_sel.any() and (w_ovf == (cap < 50))      # both cases: it fits, it overflows
    # blocked over tile chunks: the same lists
    sel_b, cand_b, _ = tpw.tile_candidates(tt, r_tile, q_pos, qv, p.cutoff_radius, cap,
                                           plane_budget=4 * QMAX * 3)
    assert torch.equal(sel_b, sel) and torch.equal(cand_b, cand)


@pytest.mark.parametrize("which,edge", [("toy", 4.0), ("big", 3.05)])
def test_pairwise_tiled_matches_akmc_tpu_and_on_the_fly(which, edge, request):
    p, pos, charge = request.getfixturevalue(which)
    jt, r_tile = jpw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=edge)
    assert jt.tile_sites.shape[0] > 1
    want, _, _ = jpw.pairwise_potential_tiled(jt, r_tile, jnp.asarray(pos), jnp.asarray(charge),
                                              *_phys(p), qmax=QMAX, cand_cap=QMAX)
    args = (convert.pair_tiling(jt), r_tile, torch.tensor(pos), torch.tensor(charge), *_phys(p))
    got, q_ovf, c_ovf = tpw.pairwise_potential_tiled(*args, qmax=QMAX, cand_cap=QMAX)
    assert not bool(q_ovf) and not bool(c_ovf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-20)
    # the case of tests/test_ops_oracle.py::test_pairwise_tiled_matches_on_the_fly
    fly, _ = tpw.pairwise_potential(torch.tensor(pos), torch.tensor(charge), *_phys(p), qmax=QMAX)
    np.testing.assert_allclose(got.numpy(), fly.numpy(), rtol=1e-12, atol=1e-18)
    assert got.abs().max() > 0
    # tiles are independent: blocks of tiles give the same values
    for kw in (dict(tile_block=2), dict(plane_budget=1)):
        part, _, _ = tpw.pairwise_potential_tiled_plain(*args, qmax=QMAX, cand_cap=QMAX, **kw)
        assert torch.equal(part, got)
    # a cap past qmax is clamped to it; a cap too small raises the flag
    assert torch.equal(tpw.pairwise_potential_tiled(*args, qmax=QMAX, cand_cap=10 * QMAX)[0], got)
    assert bool(tpw.pairwise_potential_tiled(*args, qmax=QMAX, cand_cap=2)[2])
    assert bool(tpw.pairwise_potential_tiled(*args, qmax=3, cand_cap=QMAX)[1])


@pytest.mark.parametrize("which,edge", [("toy", 4.0), ("big", 3.05)])
def test_pairwise_tiled_f32_plane(which, edge, request):
    """The f32 plane against akmc_tpu's (rtol 2e-5: two f32 erfc
    implementations) and against the f64 oracle off the cutoff shell, the
    case and tolerance of
    tests/test_ops_oracle.py::test_pairwise_tiled_f32_plane_close."""
    p, pos, charge = request.getfixturevalue(which)
    jt, r_tile = jpw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=edge)
    want32, _, _ = jpw.pairwise_potential_tiled(
        jt, r_tile, jnp.asarray(pos), jnp.asarray(charge), *_phys(p), qmax=QMAX, cand_cap=QMAX,
        plane_f32=True)
    got32, q_ovf, c_ovf = tpw.pairwise_potential_tiled(
        convert.pair_tiling(jt), r_tile, torch.tensor(pos), torch.tensor(charge), *_phys(p),
        qmax=QMAX, cand_cap=QMAX, plane_f32=True)
    assert not bool(q_ovf) and not bool(c_ovf)
    assert got32.dtype == torch.float64          # accumulated result is f64-typed
    got32 = got32.numpy()
    fly = tpw.pairwise_potential(torch.tensor(pos), torch.tensor(charge), *_phys(p),
                                 qmax=QMAX)[0].numpy()
    scale = np.abs(fly).max()

    qsel = np.nonzero(charge != 0)[0]
    d2 = ((pos[:, None, :] - pos[qsel][None, :, :]) ** 2).sum(-1)
    cut2 = p.cutoff_radius ** 2
    band = 64 * 1.2e-7 * max(cut2, np.abs(pos).max() ** 2)
    sel = ~(np.abs(d2 - cut2) < band).any(axis=1)
    assert sel.sum() > 0
    np.testing.assert_allclose(got32[sel], np.asarray(want32)[sel], rtol=2e-5, atol=2e-6 * scale)
    np.testing.assert_allclose(got32[sel], fly[sel], rtol=2e-5, atol=2e-6 * scale)
    assert np.abs(got32 - fly).max() > 0          # it is the f32 plane


@pytest.mark.parametrize("which,edge", [("toy", 4.0), ("big", 3.05)])
def test_pairwise_tiled_running_sum(which, edge, request):
    """Each site's terms are one running sum down the candidate axis, as
    csrc/pair_tiled.cu adds them: padded candidates past a tile's in-reach
    entries add exact zeros (a cap of 10 x qmax, clamped to qmax, gives the
    bits of the smallest cap that fits), and the f32 plane's sum lies within
    n·2^-23·sum|term| (recursive f32 summation, and an ulp a term) of an f64
    sum of the same f32 terms taken over every charged site in the cutoff."""
    p, pos, charge = request.getfixturevalue(which)
    jt, r_tile = jpw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=edge)
    tt = convert.pair_tiling(jt)
    pos_t, q_t = torch.tensor(pos), torch.tensor(charge)
    _, qv, q_pos, _, _ = tpw._charged_list(pos_t, q_t, QMAX)
    fit = next(c for c in range(1, QMAX + 1)
               if not bool(tpw.tile_candidates(tt, r_tile, q_pos, qv, p.cutoff_radius, c)[2]))
    assert fit < QMAX
    for f32 in (False, True):
        tight = tpw.pairwise_potential_tiled(tt, r_tile, pos_t, q_t, *_phys(p), qmax=QMAX,
                                             cand_cap=fit, plane_f32=f32)
        wide = tpw.pairwise_potential_tiled(tt, r_tile, pos_t, q_t, *_phys(p), qmax=QMAX,
                                            cand_cap=10 * QMAX, plane_f32=f32)
        assert not bool(tight[2]) and not bool(wide[2])
        assert torch.equal(tight[0], wide[0])
    got = wide[0]

    f32 = torch.float32
    qsel = torch.nonzero(q_t).flatten()
    p32 = pos_t.to(f32)
    d2 = tpw._d2(*(p32[:, None, a] - p32[qsel][None, :, a] for a in range(3)))
    cut2 = torch.tensor(p.cutoff_radius ** 2, dtype=torch.float64).to(f32)
    valid = (d2 < cut2) & (torch.arange(pos.shape[0])[:, None] != qsel[None, :])
    d = torch.tensor(1e-10, dtype=f32) * torch.sqrt(torch.where(valid, d2, 1.0))
    inv_sig = torch.tensor(1.0 / (p.sigma * np.sqrt(2.0)), dtype=f32)
    term = q_t[qsel].to(f32)[None, :] * torch.special.erfc(d * inv_sig) \
        * torch.tensor(p.k * tpw.Q_E, dtype=f32) / d
    term = torch.where(valid, term, 0.0).to(torch.float64)
    ref = term.sum(dim=1)
    bound = valid.sum(dim=1) * 2.0 ** -23 * term.abs().sum(dim=1)
    assert ref.abs().max() > 0
    assert bool(((got - ref).abs() <= bound).all())


@pytest.mark.parametrize("which,edge", [("toy", 4.0), ("big", 3.05)])
def test_bucket_walk_finds_the_candidate_lists(which, edge, request):
    """csrc/pair_tiled.cu's filter in plain Python: a tile tests the entries
    of the buckets of its row of ``_buckets``' cell table as
    ``tile_candidates`` does and ranks the hits by list position; that gives
    ``tile_candidates``' in-reach lists, entry for entry."""
    p, pos, charge = request.getfixturevalue(which)
    tt, r_tile = tpw.build_pair_tiling(pos, p.cutoff_radius, tile_edge=edge)
    _, qv, q_pos, _, _ = tpw._charged_list(torch.tensor(pos), torch.tensor(charge), QMAX)
    sel, cand, _ = tpw.tile_candidates(tt, r_tile, q_pos, qv, p.cutoff_radius, QMAX)
    reach = tpw._reach(tt, r_tile, p.cutoff_radius)
    order, start, H, cells = tpw._buckets(tt, reach, q_pos, qv)
    assert cells.shape == (tt.tile_center.shape[0], 27)
    assert bool(((cells >= -1) & (cells < H)).all())
    qp32 = q_pos.to(torch.float32)
    for t in range(tt.tile_center.shape[0]):
        hits = set()
        for b in cells[t][cells[t] >= 0].tolist():
            q = order[start[b] : start[b + 1]]
            d = [tt.tile_center[t].to(torch.float32)[a] - qp32[q, a] for a in range(3)]
            hits.update(q[tpw._d2(*d) < reach].tolist())
        assert sorted(hits) == cand[t][sel[t]].tolist()
    assert sel.any()


def test_max_in_reach_count():
    """The cases of tests/test_crossbar.py::test_max_in_reach_count, and equal
    to akmc_tpu's function on each."""
    rng = np.random.default_rng(0)
    for _ in range(6):
        Q = int(rng.integers(50, 3000))
        T = int(rng.integers(10, 3000))
        box = rng.uniform(20, 200)
        pos_q = rng.uniform(0, box, (Q, 3))
        cen = rng.uniform(-10, box + 10, (T, 3))
        reach = rng.uniform(3, 40)
        d2 = ((cen[:, None, :] - pos_q[None, :, :]) ** 2).sum(-1)
        exact = int((d2 < reach * reach).sum(axis=1).max())
        assert _max_in_reach_count(cen, pos_q, reach, budget=1 << 30) == exact
        gb = _max_in_reach_count(cen, pos_q, reach)
        assert 0.9 * exact <= gb <= exact
        assert gb == j_max_in_reach_count(cen, pos_q, reach)
    # clustered: the early stop proves exactness within the default budget
    pos_q = np.concatenate([rng.normal(50, 2, (3000, 3)), rng.uniform(0, 100, (1000, 3))])
    cen = rng.uniform(0, 100, (5000, 3))
    d2 = ((cen[:, None, :] - pos_q[None, :, :]) ** 2).sum(-1)
    exact = int((d2 < 64.0).sum(axis=1).max())
    assert _max_in_reach_count(cen, pos_q, 8.0) == exact == j_max_in_reach_count(cen, pos_q, 8.0)
