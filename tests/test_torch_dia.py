"""The DIA K operator of akmc_tpu_torch against akmc_tpu.

* the matvec's plain twin (``ops/dia_matvec.py``) against the f64 XLA loop
  ``solvers/dia.py::dia_combined_matvec`` and against the TPU kernel
  ``ops/pallas_dia.py::dia_combined_matvec_pallas`` in interpret mode, on the
  offset sets of ``tests/test_pallas_dia.py``; bound 1e-12 relative to the
  largest entry (the twin and the XLA loop sum in the same order and agree
  exactly; the Pallas kernel's two-f32 chain is good to ~2^-45);
* the boundary-potential K solve on the grid-native toy crossbar: same CG
  iteration count, potentials to rtol 1e-8 / atol 1e-9 (reassociated dots);
* the CUDA kernel against its twin is ``tests/test_torch_cuda.py`` (no JAX
  there, so it runs on the card's machine).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops.charge import update_charge_compact as j_charge
from akmc_tpu.ops.pallas_dia import dia_combined_matvec_pallas, plan_dia_pallas
from akmc_tpu.solvers.dia import DiaK as JDiaK
from akmc_tpu.solvers.dia import DiaMeta as JDiaMeta
from akmc_tpu.solvers.dia import dia_combined_matvec as j_matvec
from akmc_tpu.solvers.dia import solve_potential_boundary_dia as j_solve
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.ops import dia_matvec as tmv
from akmc_tpu_torch.solvers.dia import solve_potential_boundary_dia as t_solve


# PyTorch's CPU worker threads, when first started in a process where JAX is
# also computing, were seen to return one thread's whole chunk of an
# elementwise op up to 1e-9 off (about one process in 40; never the calling
# thread's chunk). The comparisons below run PyTorch on the calling thread.
torch.set_num_threads(1)

OFFSET_SETS = [
    [-136, -129, -128, -127, -64, -9, -1, 1, 9, 64, 127, 128, 129, 136],
    [-5000, -4999, -3, -1, 1, 3, 4999, 5000],   # far-apart groups
    [-2, -1, 1, 2],                              # single tight group
]
MATVEC_RTOL = 1e-12


def _rand_case(n, offsets, seed=0, density=0.6):
    """int8 codes {0,1,2} at the given density, x with a wide dynamic range,
    xv sparse as the conductive-vacancy mask makes it."""
    rng = np.random.RandomState(seed)
    D = len(offsets)
    diags = np.where(rng.rand(D, n) < density, rng.randint(1, 3, (D, n)), 0).astype(np.int8)
    x = rng.randn(n) * np.exp(rng.randn(n))
    xv = rng.randn(n) * (rng.rand(n) < 0.3)
    return diags, x, xv


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


@pytest.mark.parametrize("offsets", OFFSET_SETS, ids=["clustered", "far", "tight"])
def test_plain_twin_matches_jax_and_pallas(offsets):
    n = 4000
    diags, x, xv = _rand_case(n, offsets)
    dia = JDiaK(diags=jnp.asarray(diags), deg_static=jnp.zeros(n), lsum=jnp.zeros(n),
                rsum=jnp.zeros(n), pos=jnp.zeros((n, 3)), active_row=jnp.ones(n, bool))
    meta = JDiaMeta(offsets=tuple(offsets), val_low=1e-8, val_high=1.0)
    y0, v0 = j_matvec(dia, meta, jnp.asarray(x), jnp.asarray(xv))
    plan = plan_dia_pallas(offsets, n, block=512, interpret=True)
    y1, v1 = dia_combined_matvec_pallas(dia, meta, plan, jnp.asarray(x), jnp.asarray(xv))

    td, tm = convert.dia(dia, meta)
    assert td.offsets.tolist() == list(offsets)
    y, v = tmv.dia_combined_matvec(td.diags, td.offsets, tm.val_low, tm.val_high,
                                   torch.from_numpy(x), torch.from_numpy(xv))
    assert y.dtype == v.dtype == torch.float64
    # same per-diagonal order as the XLA loop: equal
    np.testing.assert_array_equal(y.numpy(), np.asarray(y0))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v0))
    assert _rel(y.numpy(), y1) < MATVEC_RTOL
    assert _rel(v.numpy(), v1) < MATVEC_RTOL


def test_cpu_dispatch_counts_no_launch():
    diags, x, xv = _rand_case(512, OFFSET_SETS[2])
    before = tmv.dia_combined_matvec.launches
    tmv.dia_combined_matvec(torch.from_numpy(diags), torch.tensor(OFFSET_SETS[2]), 1e-8, 1.0,
                            torch.from_numpy(x), torch.from_numpy(xv))
    assert tmv.dia_combined_matvec.launches == before


@pytest.fixture(scope="module")
def grid():
    p, lat = build_grid_crossbar(
        n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
        defect_fraction=0.3, vacancy_concentration=0.1, seed=3,
    )
    m = JModel(p, lat)
    assert m.dia is not None
    return p, lat, m


def test_dia_solve_matches_jax(grid):
    p, lat, m = grid
    s = j_state(lat, p.background_temp)
    charge = j_charge(s.element, s.charge, m.tables.neigh_idx, m.tables.any_metal_nbr, m.vmax)
    td, tm = convert.dia(m.dia, m.dia_meta)
    assert tm == m.dia_meta
    args = (p.high_G, p.low_G, p.num_atoms_first_layer)
    e_t, q_t = torch.tensor(np.asarray(s.element)), torch.tensor(np.asarray(charge))
    cvac = (np.asarray(s.element) == int(ELEM.VACANCY)) & (np.asarray(charge) == 0)
    assert cvac.sum() >= 2, "fixture has no conductive vacancies"

    pb_prev = s.potential_boundary
    for Vd in (2.0, 5.0):   # the second solve starts warm from the first
        pb_j, res_j = j_solve(m.dia, m.dia_meta, s.element, charge, pb_prev, Vd, *args)
        pb_t, res_t = t_solve(td, tm, e_t, q_t, torch.tensor(np.asarray(pb_prev)), Vd, *args)
        assert res_t.iterations == int(res_j.iterations) > 1
        np.testing.assert_allclose(pb_t.numpy(), np.asarray(pb_j), rtol=1e-8, atol=1e-9)
        pb_prev = pb_j
