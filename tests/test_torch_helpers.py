"""Six public helpers of akmc_tpu and their counterparts in the port, on the
same seeded numpy inputs: ``ops/charge.py::update_charge``,
``ops/compact.py::prefix_count``, ``ops/events.py::v_solve`` and
``solvers/dia.py``'s ``dia_matvec``, ``fold_cvac_codes`` and
``dia_adj_matvec``.

Tolerances: the charges, prefix counts and folded codes are integers (or
integer-valued f32) and must be equal; the two DIA products take the same
terms in the same order and must be equal to the bit; ``v_solve`` is held at
rtol 1e-14, since the two packages take erfc from different libraries (XLA's
polynomial, libm's) and their relative difference grows where erfc is small
(5.3e-15 at most on these distances, 1 to 12 Å).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.lattice import metal_mask as j_metal_mask
from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.ops.charge import update_charge as j_update_charge
from akmc_tpu.ops.compact import prefix_count as j_prefix_count
from akmc_tpu.ops.events import v_solve as j_v_solve
from akmc_tpu.solvers import dia as jdia
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM, metal_mask
from akmc_tpu_torch.ops.charge import update_charge, update_charge_compact
from akmc_tpu_torch.ops.compact import prefix_count
from akmc_tpu_torch.ops.dia_matvec import dia_combined_matvec_plain
from akmc_tpu_torch.ops.events import v_solve
from akmc_tpu_torch.solvers import dia as tdia

torch.set_num_threads(1)

V_SOLVE_RTOL = 1e-14


@pytest.fixture(scope="module")
def crossbar():
    p, lat = build_grid_crossbar(n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    jd, jm = jdia.build_dia_k(np.stack([lat.x, lat.y, lat.z], 1), lat.k_neigh_idx,
                              j_metal_mask(lat.element0, p.metals), p.num_atoms_first_layer,
                              p.high_G, p.low_G)
    return p, lat, (jd, jm), convert.dia(jd, jm)


@pytest.mark.parametrize("vacancies", [0.05, 0.3])
def test_update_charge_matches_akmc_tpu(crossbar, vacancies):
    p, lat, _, _ = crossbar
    rng = np.random.default_rng(int(vacancies * 100))
    el = lat.element0.copy()
    oxide = np.isin(el, [int(ELEM.O), int(ELEM.VACANCY)])
    el[oxide] = np.where(rng.random(oxide.sum()) < vacancies, int(ELEM.VACANCY), int(ELEM.O))
    el[rng.random(lat.N) < 0.02] = int(ELEM.OXYGEN_DEFECT)
    charge = rng.integers(-1, 2, lat.N).astype(np.int32) * 2
    nbr = lat.neigh_idx
    metal = metal_mask(el, p.metals)
    any_metal = (metal[np.clip(nbr, 0, None)] & (nbr >= 0)).any(axis=1)
    want = np.asarray(j_update_charge(jnp.asarray(el), jnp.asarray(charge), jnp.asarray(nbr),
                                      jnp.asarray(any_metal)))
    args = (torch.from_numpy(el), torch.from_numpy(charge), torch.from_numpy(nbr).long(),
            torch.from_numpy(any_metal))
    got = update_charge(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(update_charge_compact(*args, vmax=lat.N).numpy(), want)
    assert (want == 2).any() and (want == -2).any() and (want[el == int(ELEM.VACANCY)] == 0).any()


@pytest.mark.parametrize("n", [1, 511, 512, 513, 4097])
def test_prefix_count_matches_akmc_tpu(n):
    mask = np.random.default_rng(n).random(n) < 0.4
    got = prefix_count(torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_prefix_count(jnp.asarray(mask))))
    np.testing.assert_array_equal(got.numpy(), np.cumsum(mask).astype(np.float32))


def test_prefix_count_refuses_counts_beyond_f32():
    with pytest.raises(ValueError, match="2\\^24"):
        prefix_count(torch.zeros(1 << 24, dtype=torch.bool))


def test_v_solve_matches_akmc_tpu(crossbar):
    p = crossbar[0]
    rng = np.random.default_rng(2)
    d = rng.uniform(1.0, 12.0, 4000) * 1e-10
    for charge in (2, -2, 1.0):
        want = np.asarray(j_v_solve(jnp.asarray(d), charge, p.sigma, p.k))
        got = v_solve(torch.from_numpy(d), charge, p.sigma, p.k).numpy()
        np.testing.assert_allclose(got, want, rtol=V_SOLVE_RTOL, atol=0.0)


def test_dia_helpers_match_akmc_tpu(crossbar):
    _, lat, (jd, jm), (td, tm) = crossbar
    rng = np.random.default_rng(4)
    x = rng.standard_normal(lat.N) * np.exp(rng.standard_normal(lat.N))
    cvac = rng.random(lat.N) < 0.2
    np.testing.assert_array_equal(tdia.dia_matvec(td, tm, torch.from_numpy(x)).numpy(),
                                  np.asarray(jdia.dia_matvec(jd, jm, jnp.asarray(x))))
    folded = tdia.fold_cvac_codes(td, tm, torch.from_numpy(cvac))
    assert folded.dtype == torch.int8
    np.testing.assert_array_equal(folded.numpy(),
                                  np.asarray(jdia.fold_cvac_codes(jd, jm, jnp.asarray(cvac))))
    adj = tdia.dia_adj_matvec(td, tm, torch.from_numpy(x))
    np.testing.assert_array_equal(adj.numpy(),
                                  np.asarray(jdia.dia_adj_matvec(jd, jm, jnp.asarray(x))))
    # the product the K solve takes from the kernel's second output
    xv = torch.from_numpy(np.where(cvac, x, 0.0))
    _, yv = dia_combined_matvec_plain(td.diags, tm.offsets, tm.val_low, tm.val_high,
                                      torch.from_numpy(x), xv)
    assert torch.equal(tdia.dia_adj_matvec(td, tm, xv), yv)
