"""The superstep's ops in akmc_tpu_torch against akmc_tpu, fed the same
numpy inputs: compaction, the charge update, the static pair table and the
pairwise potential, the rate table in both rate modes, and the residence-time
event loop from the same rate table and rand buffer.

Integer results (charges, elements, event types, event and draw counts) must
be equal. f64 results carry their own bounds: the pair table's entries come
from the same per-pair operations, with PyTorch's and JAX's erfc a few ulps
apart (rtol 1e-13); the potential and the rates are reductions and
exponentials of them (rtol 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops import charge as jcharge
from akmc_tpu.ops import compact as jcompact
from akmc_tpu.ops import events as jev
from akmc_tpu.ops import pairwise as jpair
from akmc_tpu.rng import ReferenceRNG
from akmc_tpu.state import make_device_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.ops import charge as tcharge
from akmc_tpu_torch.ops import compact as tcompact
from akmc_tpu_torch.ops import events as tev
from akmc_tpu_torch.ops import pairwise as tpair


# PyTorch's CPU worker threads, when first started in a process where JAX is
# also computing, were seen to return one thread's whole chunk of an
# elementwise op up to 1e-9 off (about one process in 40; never the calling
# thread's chunk). The comparisons below run PyTorch on the calling thread.
torch.set_num_threads(1)


def T(a):
    """A CPU tensor copy of a numpy or JAX array."""
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def grid():
    p, lat = build_grid_crossbar(
        n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
        defect_fraction=0.3, vacancy_concentration=0.1, seed=3,
    )
    m = JModel(p, lat)
    tt = convert.tables(m.tables)
    state = make_device_state(lat, p.background_temp)
    return p, lat, m, tt, state


@pytest.mark.parametrize("size", [1, 40, 300])
def test_compact_mask_contract(size):
    mask = np.random.default_rng(size).random(257) < 0.4
    ji, jv = jcompact.compact_mask(jnp.asarray(mask), size)
    ti, tv = tcompact.compact_mask(torch.from_numpy(mask), size)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_charge_update_matches(grid):
    p, lat, m, tt, s = grid
    rng = np.random.default_rng(1)
    elem = np.asarray(s.element).copy()
    oxide = np.isin(elem, [int(ELEM.O), int(ELEM.VACANCY)])
    # a denser vacancy population, so the >= 2 vacancy-neighbor rule fires
    elem[oxide & (rng.random(lat.N) < 0.3)] = int(ELEM.VACANCY)
    elem[(elem == int(ELEM.DEFECT)) & (rng.random(lat.N) < 0.3)] = int(ELEM.OXYGEN_DEFECT)
    charge = rng.choice([-2, 0, 2], lat.N).astype(np.int32)
    vmax = int(((elem == int(ELEM.VACANCY)).sum() + 255) // 256 * 256)
    qj = jcharge.update_charge_compact(jnp.asarray(elem), jnp.asarray(charge),
                                       m.tables.neigh_idx, m.tables.any_metal_nbr, vmax)
    qt = tcharge.update_charge_compact(T(elem), T(charge), tt.neigh_idx, tt.any_metal_nbr, vmax)
    assert qt.dtype == torch.int32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    qv = np.asarray(qj)[elem == int(ELEM.VACANCY)]
    assert (qv == 0).any() and (qv == 2).any()


def test_pair_table_and_potential_match(grid):
    p, lat, m, tt, s = grid
    act = np.asarray(m.tables.act_idx)
    act = act[act >= 0]
    jt = jpair.build_pair_table(m.tables.pos, jnp.asarray(act), p.cutoff_radius, p.sigma, p.k)
    table = tpair.build_pair_table(tt.pos, torch.from_numpy(act.astype(np.int64)),
                                   p.cutoff_radius, p.sigma, p.k)
    assert table.shape == jt.full.shape
    np.testing.assert_allclose(table.numpy(), np.asarray(jt.full), rtol=1e-13, atol=0)

    rng = np.random.default_rng(2)
    site_act = np.zeros(lat.N, bool)
    site_act[act] = True
    charge = np.where(site_act & (rng.random(lat.N) < 0.2),
                      rng.choice([-2, 2], lat.N), 0).astype(np.int32)
    n_q = int((charge != 0).sum())
    for qmax in (n_q + 7, n_q - 1):
        pj, oj = jpair.pairwise_potential_table(jt, m.tables.abs2act, jnp.asarray(charge), qmax)
        pt, ot = tpair.pairwise_potential_table(table, tt.abs2act, T(charge), qmax)
        assert bool(ot) == bool(oj) == (qmax < n_q)
        if qmax >= n_q:
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12,
                                       atol=1e-12 * np.abs(np.asarray(pj)).max())


def _fields(m, s, Vd):
    """akmc_tpu's charge, summed potential and rate table at bias Vd."""
    return m._run_fields(s, Vd)


@pytest.mark.parametrize("normalize", [False, True], ids=["absolute", "shifted"])
def test_rate_table_matches(grid, normalize):
    p, lat, m, tt, s = grid
    fr = _fields(m, s, 2.0)
    t = m.tables
    jargs = (s.element, fr.charge, fr.potential_sum, s.T_bg, t.act_neigh, t.act_self2,
             t.act_layer, t.E_gen, t.E_rec, t.E_Vdiff, t.E_Odiff, p.freq, p.sigma, p.k)
    out_j = jev.build_event_table(*jargs, rows=t.act_idx, normalize=normalize)
    P_t, et_t, lnS_t = tev.build_event_table(
        T(s.element), T(fr.charge), T(fr.potential_sum), T(s.T_bg), tt.act_neigh,
        tt.act_self2, tt.act_layer, tt.E_gen, tt.E_rec, tt.E_Vdiff, tt.E_Odiff, p.freq,
        rows=tt.act_idx, normalize=normalize,
    )
    np.testing.assert_array_equal(et_t.numpy(), np.asarray(out_j[1]))
    assert (et_t.numpy() != 0).sum() > 10
    np.testing.assert_allclose(P_t.numpy(), np.asarray(out_j[0]), rtol=1e-12, atol=0)
    if normalize:
        assert float(lnS_t) == pytest.approx(float(out_j[2]), rel=1e-14)
    else:
        assert lnS_t is None


@pytest.mark.parametrize("normalize", [False, True], ids=["absolute", "shifted"])
@pytest.mark.parametrize("buf_len", [8192, 7], ids=["whole", "exhausted"])
def test_event_loop_matches(grid, normalize, buf_len):
    p, lat, m, tt, s = grid
    # a high bias gives a superstep of many events
    fr = _fields(m, s, 8.0)
    t = m.tables
    P, etype, ln_S = _rates(p, t, s, fr, normalize)
    rand = ReferenceRNG(7).uniform(buf_len)
    rj = jev.run_event_loop(
        s.element, fr.charge, P, etype, t.act_neigh, jnp.asarray(rand), p.freq,
        act_idx=t.act_idx, abs2act=t.abs2act, ln_S=ln_S, zero_rows=t.act_zero_rows,
    )
    rt = tev.run_event_loop(
        T(s.element), T(fr.charge), T(P), T(etype), tt.act_neigh, torch.from_numpy(rand),
        p.freq, tt.act_idx, tt.abs2act, tt.act_zero_rows,
        ln_S=None if ln_S is None else float(ln_S),
    )
    assert (rt.n_events, rt.draws_used, rt.done) == (
        int(rj.n_events), int(rj.draws_used), bool(rj.done))
    assert rt.n_events >= (3 if buf_len == 7 else 2)
    np.testing.assert_array_equal(rt.element.numpy(), np.asarray(rj.element))
    np.testing.assert_array_equal(rt.charge.numpy(), np.asarray(rj.charge))
    np.testing.assert_array_equal(rt.P.numpy(), np.asarray(rj.P))
    assert float(rt.event_time) == pytest.approx(float(rj.event_time), rel=1e-12)
    if not rt.done:
        # resume where the buffer ran out, as the superstep does
        rand2 = ReferenceRNG(8).uniform(8192)
        rj2 = jev.run_event_loop(
            rj.element, rj.charge, rj.P, etype, t.act_neigh, jnp.asarray(rand2), p.freq,
            event_time_in=rj.event_time, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=ln_S,
            zero_rows=t.act_zero_rows,
        )
        rt2 = tev.run_event_loop(
            rt.element, rt.charge, rt.P, T(etype), tt.act_neigh, torch.from_numpy(rand2),
            p.freq, tt.act_idx, tt.abs2act, tt.act_zero_rows, event_time_in=rt.event_time,
            ln_S=None if ln_S is None else float(ln_S),
        )
        assert (rt2.n_events, rt2.draws_used, rt2.done) == (
            int(rj2.n_events), int(rj2.draws_used), bool(rj2.done))
        np.testing.assert_array_equal(rt2.element.numpy(), np.asarray(rj2.element))


def _rates(p, t, s, fr, normalize):
    out = jev.build_event_table(
        s.element, fr.charge, fr.potential_sum, s.T_bg, t.act_neigh, t.act_self2, t.act_layer,
        t.E_gen, t.E_rec, t.E_Vdiff, t.E_Odiff, p.freq, p.sigma, p.k, rows=t.act_idx,
        normalize=normalize,
    )
    return out if normalize else (*out, None)
