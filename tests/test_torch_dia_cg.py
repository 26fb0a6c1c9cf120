"""The fused K-solve CG of akmc_tpu_torch (``solvers/dia_cg.py``) on the CPU.

* ``blocked_vdot``, the dot product in the fused kernel's reduction order,
  against an independent numpy loop of the order documented in
  ``csrc/dia_cg.cu`` (bit for bit: elementwise IEEE adds repeat exactly) and
  against ``math.fsum`` (bound 1e-15 * sum |a_i b_i|: a pairwise tree over
  n <= 70,000 terms is good to about log2(n) * 2^-53 of that sum);
* ``dia_cg_solve_plain``, the kernel's plain twin, against
  ``akmc_tpu.solvers.dia.solve_potential_boundary_dia`` on the grid-native toy
  crossbar of ``tests/test_torch_dia.py``: equal CG iteration count, potentials
  to rtol 1e-8 / atol 1e-9 (reassociated dots), from a cold start, a warm
  start, and with ``max_iterations`` reached;
* what the kernels' wrappers refuse, as far as a machine without a card can
  show it (the same checks on CUDA tensors are in ``tests/test_torch_cuda.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops.charge import update_charge_compact as j_charge
from akmc_tpu.solvers.dia import solve_potential_boundary_dia as j_solve
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.ops.dia_matvec import DiaOperator, require_tensor
from akmc_tpu_torch.solvers import dia_cg
from akmc_tpu_torch.solvers.cg import f64_vdot
from akmc_tpu_torch.solvers.dia import k_system
from akmc_tpu_torch.solvers.dia import solve_potential_boundary_dia as t_solve

# one thread, as in the other test_torch_* files that run beside JAX
torch.set_num_threads(1)


def _halve(v):
    v = list(v)
    while len(v) > 1:
        h = len(v) // 2
        v = [v[i] + v[i + h] for i in range(h)]
    return v[0]


def _tree256(v):
    """Halving tree inside each run of 32 values, then over the 8 run sums."""
    assert len(v) == 256
    return _halve([_halve(v[w * 32:(w + 1) * 32]) for w in range(8)])


def _documented_dot(a, b):
    """The order of ``csrc/dia_cg.cu``, value by value in Python floats."""
    prod = [float(x) * float(y) for x, y in zip(a, b)]
    chunks = -(-len(prod) // 256)
    prod += [0.0] * (chunks * 256 - len(prod))
    cs = [_tree256(prod[c * 256:(c + 1) * 256]) for c in range(chunks)]
    rows = -(-chunks // 256)
    cs += [0.0] * (rows * 256 - chunks)
    acc = cs[:256]
    for m in range(1, rows):
        acc = [acc[t] + cs[m * 256 + t] for t in range(256)]
    return _tree256(acc)


@pytest.mark.parametrize("n", [1, 31, 255, 256, 257, 1000, 4097, 66_000],
                         ids=lambda n: f"n{n}")
def test_blocked_vdot_is_the_documented_order(n):
    rng = np.random.RandomState(n)
    a = rng.randn(n) * np.exp(3 * rng.randn(n))
    b = rng.randn(n) * np.exp(3 * rng.randn(n))
    got = float(dia_cg.blocked_vdot(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == _documented_dot(a, b)
    exact = math.fsum(float(x) * float(y) for x, y in zip(a, b))
    assert abs(got - exact) <= 1e-15 * float(np.abs(a * b).sum())


@pytest.fixture(scope="module")
def grid():
    p, lat = build_grid_crossbar(
        n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
        defect_fraction=0.3, vacancy_concentration=0.1, seed=3,
    )
    m = JModel(p, lat)
    s = j_state(lat, p.background_temp)
    charge = j_charge(s.element, s.charge, m.tables.neigh_idx, m.tables.any_metal_nbr, m.vmax)
    return p, m, s, charge


def _both(grid, pb_prev, Vd, **kw):
    """The K solve by akmc_tpu and by the port's plain twin, same inputs."""
    p, m, s, charge = grid
    args = (p.high_G, p.low_G, p.num_atoms_first_layer)
    pb_j, res_j = j_solve(m.dia, m.dia_meta, s.element, charge, jnp.asarray(pb_prev), Vd,
                          *args, **kw)
    td, tm = convert.dia(m.dia, m.dia_meta)
    ks = k_system(td, tm, torch.tensor(np.asarray(s.element)), torch.tensor(np.asarray(charge)),
                  torch.tensor(np.asarray(pb_prev)), Vd, *args)
    n_int = s.element.shape[0] - 2 * p.num_atoms_first_layer
    res_t = dia_cg.dia_cg_solve_plain(td.operator(tm), *ks, 1e-14 * n_int,
                                      kw.get("max_iterations", 10000))
    return np.asarray(pb_j), res_j, torch.where(ks.is_int, res_t.x, 0.0).numpy(), res_t, (td, tm)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_plain_twin_matches_jax(grid, start):
    n = grid[2].element.shape[0]
    pb_prev = np.zeros(n)
    if start == "warm":
        pb_prev = _both(grid, pb_prev, 2.0)[0]    # the solve at another bias
    pb_j, res_j, pb_t, res_t, _ = _both(grid, pb_prev, 5.0)
    assert res_t.iterations == int(res_j.iterations) > 1
    np.testing.assert_allclose(pb_t, pb_j, rtol=1e-8, atol=1e-9)
    assert float(res_t.residual_sq) == pytest.approx(float(res_j.residual_sq), rel=1e-3)


def test_plain_twin_stops_at_max_iterations(grid):
    n = grid[2].element.shape[0]
    pb_j, res_j, pb_t, res_t, _ = _both(grid, np.zeros(n), 5.0, max_iterations=7)
    assert res_t.iterations == int(res_j.iterations) == 8     # k counts from 1
    np.testing.assert_allclose(pb_t, pb_j, rtol=1e-8, atol=1e-9)


def test_solve_dispatches_to_the_twin_on_cpu(grid):
    """``solve_potential_boundary_dia`` on CPU tensors is the plain twin, bit
    for bit, and counts no launch."""
    p, m, s, charge = grid
    n = s.element.shape[0]
    _, _, pb_t, res_t, (td, tm) = _both(grid, np.zeros(n), 5.0)
    before = dia_cg.dia_cg_solve.launches
    pb, res = t_solve(td, tm, torch.tensor(np.asarray(s.element)),
                      torch.tensor(np.asarray(charge)), torch.zeros(n, dtype=torch.float64),
                      5.0, p.high_G, p.low_G, p.num_atoms_first_layer)
    assert dia_cg.dia_cg_solve.launches == before
    assert isinstance(res.iterations, int) and res.iterations == res_t.iterations
    assert torch.equal(pb, torch.from_numpy(pb_t)) and torch.equal(res.r, res_t.r)


def test_dot_order_moves_the_solve_within_the_cg_tolerance(grid):
    """The blocked order and ``torch.sum`` are two roundings of the same dot:
    the same iteration count on this system, and potentials as close to each
    other as either is to akmc_tpu."""
    from akmc_tpu_torch.ops.dia_matvec import dia_combined_matvec_plain
    from akmc_tpu_torch.solvers.cg import jacobi_cg

    p, m, s, charge = grid
    n = s.element.shape[0]
    _, _, pb_t, res_t, (td, tm) = _both(grid, np.zeros(n), 5.0)
    ks = k_system(td, tm, torch.tensor(np.asarray(s.element)), torch.tensor(np.asarray(charge)),
                  torch.zeros(n, dtype=torch.float64), 5.0, p.high_G, p.low_G,
                  p.num_atoms_first_layer)
    op = td.operator(tm)

    def A(x):
        mv, corr = dia_combined_matvec_plain(op.diags, op.offsets_list, op.val_low, op.val_high,
                                             x, torch.where(ks.cvac, x, 0.0))
        return torch.where(ks.is_int, ks.diag_i * x - mv - ks.dgc * corr, x)

    res_s = jacobi_cg(A, ks.rhs, ks.x0, ks.inv_diag, 1e-14 * (n - 2 * p.num_atoms_first_layer),
                      10000, dot_fn=f64_vdot)
    assert res_s.iterations == res_t.iterations
    np.testing.assert_allclose(torch.where(ks.is_int, res_s.x, 0.0).numpy(), pb_t,
                               rtol=1e-8, atol=1e-9)


def _codes(n=64):
    return torch.ones((2, n), dtype=torch.int8), torch.tensor([-1, 1])


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device_type"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    n = 64
    cpu = torch.device("cpu")
    x = torch.zeros(n, dtype=torch.float64)
    require_tensor("x", x, torch.float64, (n,), cpu)            # what they do take
    with pytest.raises(ValueError):
        if bad == "dtype":
            require_tensor("x", x.float(), torch.float64, (n,), cpu)
        elif bad == "shape":
            require_tensor("x", x[:-1], torch.float64, (n,), cpu)
        elif bad == "strided":
            require_tensor("x", torch.zeros(2 * n, dtype=torch.float64)[::2],
                           torch.float64, (n,), cpu)
        else:
            require_tensor("x", x, torch.float64, (n,), torch.device("cuda", 0))


@pytest.mark.parametrize("bad", ["codes_dtype", "codes_rank", "offsets_dtype", "offsets_len",
                                 "codes_strided"])
def test_operator_refuses_a_malformed_operator(bad):
    diags, offsets = _codes()
    assert DiaOperator(diags, offsets, 1e-8, 1.0).offsets_list == [-1, 1]
    with pytest.raises(ValueError):
        if bad == "codes_dtype":
            DiaOperator(diags.to(torch.int32), offsets, 1e-8, 1.0)
        elif bad == "codes_rank":
            DiaOperator(diags[0], offsets, 1e-8, 1.0)
        elif bad == "offsets_dtype":
            DiaOperator(diags, offsets.to(torch.int32), 1e-8, 1.0)
        elif bad == "offsets_len":
            DiaOperator(diags, offsets[:1], 1e-8, 1.0)
        else:
            DiaOperator(torch.ones((2, 128), dtype=torch.int8)[:, ::2], offsets, 1e-8, 1.0)


def test_operator_is_built_once_per_structure(grid):
    _, m, _, _ = grid
    td, tm = convert.dia(m.dia, m.dia_meta)
    op = td.operator(tm)
    assert td.operator(tm) is op
    assert (op.D, op.n) == tuple(td.diags.shape) and op.offsets_list == list(tm.offsets)
    moved = td.to(torch.device("cpu"))
    assert moved.operator(tm) is not op and torch.equal(moved.diags, td.diags)
