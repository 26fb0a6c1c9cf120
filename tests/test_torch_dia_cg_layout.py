"""The per-row layout and the schedule of the fused K-solve CG
(``csrc/dia_cg.cu``) on the CPU.

* ``pack_row_masks_plain``, the plain twin of the words the kernel packs once
  per solve (edge, high_G and conductive-neighbour bits per group of 32
  diagonals), against ``akmc_tpu``: its cvac bits are
  ``akmc_tpu.solvers.dia.fold_cvac_codes(...) != 0``, its edge and high bits
  the codes whose column lies in range, and the matvec decoded from it
  (``masks_matvec_plain``) equals ``akmc_tpu``'s ``dia_combined_matvec`` at
  rtol 1e-15 (and the port's plain matvec bit for bit) on the n_yz = 6 and 8
  grid crossbars and on a random operator of D = 40 > 32 diagonals;
* the kernel's schedule restated in plain PyTorch (two phases per
  iteration; p = z + beta p recomputed from the published z and the previous
  p wherever A gathers it; two alternating p buffers; the masks' matvec;
  ``chunk_sums``/``finish_chunks`` dots) is bit-equal to
  ``dia_cg_solve_plain`` (x, r, iteration count, r.z) at several N, N not a
  multiple of 256 included, cold and warm, and cut by ``max_iterations``
  (the random systems are ``chip_smoke.py::random_k_system``'s).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akmc_tpu.lattice import metal_mask as j_metal_mask
from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.solvers.dia import DiaMeta as JDiaMeta
from akmc_tpu.solvers.dia import build_dia_k as j_build_dia_k
from akmc_tpu.solvers.dia import dia_combined_matvec as j_matvec
from akmc_tpu.solvers.dia import fold_cvac_codes as j_fold
from akmc_tpu_torch import convert
from akmc_tpu_torch.ops.dia_matvec import DiaOperator, dia_combined_matvec_plain
from akmc_tpu_torch.solvers import dia_cg
from akmc_tpu_torch.solvers.cg import CGResult
from akmc_tpu_torch.solvers.dia import k_system
from chip_smoke import random_k_system

# one thread, as in the other test_torch_* files that run beside JAX
torch.set_num_threads(1)


def _grid(n_yz):
    """(akmc_tpu's DiaK and DiaMeta, the port's, p, lat) of a small grid
    crossbar with every slice kind."""
    p, lat = build_grid_crossbar(n_yz=n_yz, contact_slices=2, oxide_slices=6, ti_slices=2,
                                 defect_fraction=0.3, vacancy_concentration=0.1, seed=3)
    jd, jm = j_build_dia_k(np.stack([lat.x, lat.y, lat.z], 1), lat.k_neigh_idx,
                           j_metal_mask(lat.element0, p.metals), p.num_atoms_first_layer,
                           p.high_G, p.low_G)
    return (jd, jm), convert.dia(jd, jm), p, lat


def _random_codes(rng, n, offsets):
    return np.where(rng.random((len(offsets), n)) < 0.5,
                    rng.integers(1, 3, (len(offsets), n)), 0).astype(np.int8)


def _layout_case(name):
    """(akmc_tpu dia, meta, the port's DiaOperator, cvac as numpy bool)."""
    rng = np.random.default_rng(11)
    if name.startswith("n_yz"):
        (jd, jm), (td, tm), _, lat = _grid(int(name[4:]))
        cvac = rng.random(lat.N) < 0.2
        return jd, jm, td.operator(tm), cvac
    offsets = sorted(int(o) for o in rng.choice(np.arange(-3000, 3001), 40, replace=False))
    n = 5000
    codes = _random_codes(rng, n, offsets)
    jd = types.SimpleNamespace(diags=jnp.asarray(codes))      # what the two functions read
    jm = JDiaMeta(offsets=tuple(offsets), val_low=1e-3, val_high=1.0)
    op = DiaOperator(torch.from_numpy(codes), torch.tensor(offsets), jm.val_low, jm.val_high)
    return jd, jm, op, rng.random(n) < 0.2


def _bits(words, D):
    """(3, groups, N) words -> (3, D, N) bool: bit d % 32 of group d // 32."""
    w = words.numpy()
    return np.stack([(w[:, d // 32] >> (d % 32)) & 1 for d in range(D)], axis=1).astype(bool)


@pytest.mark.parametrize("case", ["n_yz6", "n_yz8", "random_D40"])
def test_row_masks_match_akmc_tpu(case):
    jd, jm, op, cvac = _layout_case(case)
    n, D = op.n, op.D
    words = dia_cg.pack_row_masks_plain(op, torch.from_numpy(cvac))
    assert tuple(words.shape) == (3, -(-D // 32), n)
    assert int(words.min()) >= 0 and int(words.max()) < 2 ** 32
    edge, high, cvn = _bits(words, D)

    codes = np.asarray(jd.diags)
    cols = np.arange(n)[None, :] + np.asarray(jm.offsets)[:, None]
    in_range = (cols >= 0) & (cols < n)
    np.testing.assert_array_equal(edge, (codes != 0) & in_range)
    np.testing.assert_array_equal(high, (codes == 2) & in_range)
    np.testing.assert_array_equal(cvn, np.asarray(j_fold(jd, jm, jnp.asarray(cvac))) != 0)

    x = np.random.default_rng(5).standard_normal(n) * np.exp(np.random.default_rng(6)
                                                           .standard_normal(n))
    mv, corr = dia_cg.masks_matvec_plain(words, op.offsets_list, op.val_low, op.val_high,
                                         torch.from_numpy(x))
    jy, jv = j_matvec(jd, jm, jnp.asarray(x), jnp.asarray(np.where(cvac, x, 0.0)))
    np.testing.assert_allclose(mv.numpy(), np.asarray(jy), rtol=1e-15, atol=0)
    np.testing.assert_allclose(corr.numpy(), np.asarray(jv), rtol=1e-15, atol=0)
    # the kernel's sums in the twin's order: the port's plain matvec to the bit
    xt = torch.from_numpy(x)
    ty, tv = dia_combined_matvec_plain(op.diags, op.offsets_list, op.val_low, op.val_high,
                                       xt, torch.where(torch.from_numpy(cvac), xt, 0.0))
    assert torch.equal(mv, ty) and torch.equal(corr, tv)


def folded_cg(op, ks, relative_tolerance, max_iterations):
    """The kernel's schedule, phase for phase, on whole vectors."""
    cvac, is_int, diag_i, dgc, inv_diag, rhs, x0 = ks
    words = dia_cg.pack_row_masks_plain(op, cvac)
    n = op.n
    idx = torch.arange(n)
    neighbours = [(idx + o).clamp(0, n - 1) for o in op.offsets_list]
    lo, hi = (torch.tensor(w, dtype=torch.float64) for w in (op.val_low, op.val_high))

    def A(v_i, gathered):
        """A(v) with v_j = gathered(j) at each neighbour, as the kernel sums it."""
        mv, corr = torch.zeros(n, dtype=torch.float64), torch.zeros(n, dtype=torch.float64)
        for d, j in enumerate(neighbours):
            g, b = divmod(d, 32)
            edge, high, cvn = (((words[plane, g] >> b) & 1).bool() for plane in range(3))
            vj = gathered(j)
            mv = torch.where(edge, mv + torch.where(high, hi, lo) * vj, mv)
            corr = torch.where(cvn, corr + vj, corr)
        return torch.where(is_int, diag_i * v_i - mv - dgc * corr, v_i)

    def dot(a, b):
        return dia_cg.finish_chunks(dia_cg.chunk_sums(a, b))

    tol2 = relative_tolerance ** 2
    x = x0
    r = rhs - A(x0, lambda j: x0[j])
    z = r * inv_diag
    norm2_rhs, rz = dot(rhs, rhs), dot(r, z)
    p = [torch.full((n,), float("nan"), dtype=torch.float64) for _ in range(2)]
    beta = None
    k = 1
    while k <= max_iterations and bool(rz / norm2_rhs > tol2):
        # phase 1: p_k from z and p_{k-1}, for the own row and at every gather
        p_old = p[(k - 1) & 1]
        if k == 1:
            def p_at(j):
                return z[j]
        else:
            def p_at(j):
                return z[j] + beta * p_old[j]
        p[k & 1] = p_at(idx)
        pk = p[k & 1]
        Ap = A(pk, p_at)
        alpha = rz / dot(pk, Ap)
        # phase 2
        x = x + alpha * pk
        r = r - alpha * Ap
        z = r * inv_diag
        rz_new = dot(r, z)
        beta = rz_new / rz
        rz = rz_new
        k += 1
    return CGResult(x=x, iterations=k, residual_sq=rz, r=r)


def _schedule_case(name):
    """(operator, K system, rtol, max_iterations) of one case."""
    rng = np.random.default_rng(3)
    if name.startswith("grid"):
        _, (td, tm), p, lat = _grid(6)
        element = torch.as_tensor(lat.element0, dtype=torch.int32)
        zeros = torch.zeros(lat.N, dtype=torch.float64)
        geom = (p.high_G, p.low_G, p.num_atoms_first_layer)
        rtol = 1e-14 * (lat.N - 2 * p.num_atoms_first_layer)
        ks = k_system(td, tm, element, torch.zeros_like(element), zeros, 5.0, *geom)
        op = td.operator(tm)
        if name == "grid-warm":
            first = dia_cg.dia_cg_solve_plain(op, *ks, rtol, 10000)
            ks = k_system(td, tm, element, torch.zeros_like(element),
                          torch.where(ks.is_int, first.x, 0.0), 2.0, *geom)
        return op, ks, rtol, 7 if name == "grid-cut" else 10000
    n, offs = {"random-1000": (1000, [1, 3, 17]),
               "random-4097-D36": (4097, [1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377,
                                          610, 987, 1597, 2584, 4000]),
               "random-70001": (70_001, [1, 9, 81, 6561]),
               "random-1000-max0": (1000, [1, 3, 17])}[name]
    op, ks = random_k_system(rng, n, offs, torch.device("cpu"))
    return op, ks, 1e-10, 0 if name.endswith("max0") else 500


@pytest.mark.parametrize("case", ["grid-cold", "grid-warm", "grid-cut", "random-1000",
                                  "random-4097-D36", "random-70001", "random-1000-max0"])
def test_folded_schedule_is_the_twin(case):
    op, ks, rtol, max_it = _schedule_case(case)
    want = dia_cg.dia_cg_solve_plain(op, *ks, rtol, max_it)
    got = folded_cg(op, ks, rtol, max_it)
    assert got.iterations == want.iterations
    if case == "grid-cut":
        assert got.iterations == 8
    elif case.endswith("max0"):
        assert got.iterations == 1
    else:
        assert 5 < got.iterations < max_it
    assert torch.equal(got.x, want.x) and torch.equal(got.r, want.r)
    assert torch.equal(got.residual_sq, want.residual_sq)
