"""Boundary-potential (K system) solve over the ELL neighbor table, the
matrix-free fallback for structures with neither a DIA nor a banded form, and
the conduction-band edge (Laplace) solve of the full-physics mode.

Reference: background_potential_gpu_sparse (potential_solver_gpu.cu:846-1128)
and update_CB_edge_gpu_sparse (potential_solver_gpu.cu:673-772), as
``akmc_tpu/solvers/poisson.py`` realizes them.

The Kirchhoff network over the interface sites (everything except the first /
last contact slice of ``num_atoms_first_layer`` sites):

    A_ii = sum_j G_ij   (over ALL neighbors j, incl. contact slices)
    A_ij = -G_ij        (j an interface neighbor)
    rhs_i = Lsum_i * VL + Rsum_i * VR,  VL = -Vd/2, VR = +Vd/2
            (calc_rhs_for_A, potential_solver_gpu.cu:438-454; the committed
             solve stores the sign-flipped potential — kept as-is for parity)

with edge conductances (calc_off_diagonal_dist, potential_solver_gpu.cu:246):

    G_ij = high_G  if (metal_i and metal_j) or (neutral-vacancy_i and _j)
           low_G   otherwise

No matrix is assembled: the adjacency is the static padded table (PBC-aware,
= the K CSR sparsity); the conductance table ``G`` is computed once per solve
from element and charge, and each CG iteration is one gather, one multiply
and one row sum over (N_int, NN), in the device loop of ``solvers/cg.py``.

The contact-slice entries of the returned N-vector remain 0
(kmc_main.cpp:567-573 is commented out in the reference).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from akmc_tpu_torch.config import EV_TO_J
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.solvers.cg import (
    CGResult, Operator, jacobi_cg, jacobi_cg_plain, symscaled_cg, symscaled_cg_plain,
)


def edge_conductance(
    element: torch.Tensor,       # (N,) int32
    charge: torch.Tensor,        # (N,) int32
    k_neigh_idx: torch.Tensor,   # (R, NN) int64 PBC-aware adjacency of rows [row0, row0 + R)
    metal_edge: torch.Tensor,    # (R, NN) bool: metal_i & metal_j (static)
    high_G: float,
    low_G: float,
    row0: int = 0,
) -> torch.Tensor:
    """(R, NN) f64 edge conductances G_ij on the K sparsity of the table's
    rows (all N by default)."""
    j = k_neigh_idx.clamp(min=0)
    cvac = (element == int(ELEM.VACANCY)) & (charge == 0)
    cvac_edge = cvac[row0 : row0 + k_neigh_idx.shape[0], None] & cvac[j]
    hi = torch.full((), high_G, dtype=torch.float64, device=element.device)
    lo = torch.full((), low_G, dtype=torch.float64, device=element.device)
    return torch.where(metal_edge | cvac_edge, hi, lo)


def solve_potential_boundary(
    element: torch.Tensor,
    charge: torch.Tensor,
    potential_boundary_prev: torch.Tensor,   # (N,) f64 warm start
    k_neigh_idx: torch.Tensor,
    metal_edge: torch.Tensor,
    Vd: float,
    high_G: float,
    low_G: float,
    num_atoms_first_layer: int,
    rtol_coeff: float = 1e-14,
    max_iterations: int = 10000,
    shard=None,
    graphs=None,
) -> Tuple[torch.Tensor, CGResult]:
    """Solve the K system; returns the full-length N-vector (contacts zero)
    and CG diagnostics. rtol = rtol_coeff * N_interface
    (potential_solver_gpu.cu:884-886).

    ``shard`` (mesh, ranges): ``k_neigh_idx`` and ``metal_edge`` hold only
    this rank's interface rows ``ranges[mesh.rank]`` (counted from the first
    interface row); each rank computes its rows of every product, which are
    gathered whole (``interface_rows``), so the CG computes on every rank what
    it computes on one device; it runs the host loop there (gloo collectives
    cannot be captured), and on one device the device loop of
    ``solvers/cg.py`` with ``graphs`` the caller's ``LoopGraphs``."""
    n = element.shape[0]
    L = R = num_atoms_first_layer
    n_int = n - L - R
    i0, whole = interface_rows(shard)
    if shard is None:
        k_neigh_idx, metal_edge = k_neigh_idx[L : n - R], metal_edge[L : n - R]

    G = edge_conductance(element, charge, k_neigh_idx, metal_edge, high_G, low_G, row0=L + i0)

    nbr = k_neigh_idx
    valid = nbr >= 0
    Gv = torch.where(valid, G, 0.0)

    # row sums split by neighbor region (diagonal / rhs contributions)
    j = nbr.clamp(min=0)
    in_left = valid & (j < L)
    in_right = valid & (j >= n - R)
    in_int = valid & ~(j < L) & ~(j >= n - R)

    # interface rows only
    diag_r = torch.sum(Gv, dim=1)                         # A_ii = sum all G_ij
    diag = whole(diag_r)
    lsum = whole(torch.sum(torch.where(in_left, G, 0.0), dim=1))
    rsum = whole(torch.sum(torch.where(in_right, G, 0.0), dim=1))

    VL = -Vd / 2.0
    VR = Vd / 2.0
    rhs = lsum * VL + rsum * VR

    G_int = torch.where(in_int, G, 0.0)                   # (rows, NN)
    # interface-local column; contact neighbors carry G_int = 0 and are
    # clamped into range (akmc_tpu's gather clamps them the same way)
    nbr_int = (j - L).clamp(0, n_int - 1)
    A = _interface_operator("ell", diag_r, G_int, nbr_int, i0, whole)

    x0 = potential_boundary_prev[L : n - R]
    # zero-degree interface rows (e.g. a grid structure's null placeholder
    # slots) have diag 0: 1/diag = inf would NaN the preconditioned residual
    # and kill CG on the FIRST iteration; such rows carry rhs 0 and stay 0
    pos = diag > 0.0
    inv_diag = torch.where(pos, 1.0 / torch.where(pos, diag, 1.0), 1.0)
    if shard is None:
        res = jacobi_cg(A, rhs, x0, inv_diag, rtol_coeff * n_int, max_iterations, graphs=graphs)
    else:
        res = jacobi_cg_plain(A, rhs, x0, inv_diag, rtol_coeff * n_int, max_iterations)
    full = torch.zeros(n, dtype=res.x.dtype, device=res.x.device)
    full[L : n - R] = res.x
    return full, res


def _interface_op(x, diag_r, G_int, nbr_int, *, i0, whole):
    """A x = diag*x - sum_j G_ij x_j over interface neighbors, for the rows
    from ``i0`` on that ``diag_r`` holds, gathered whole."""
    rows = slice(i0, i0 + diag_r.shape[0])
    return whole(diag_r * x[rows] - torch.sum(G_int * x[nbr_int], dim=1))


def _interface_operator(name, diag_r, G_int, nbr_int, i0, whole) -> Operator:
    """The interface operator with its per-solve tables as operands (the
    gather columns too: recomputed per solve from the static table)."""
    return Operator(name, functools.partial(_interface_op, i0=i0, whole=whole),
                    (diag_r, G_int, nbr_int), (i0,))


def interface_rows(shard):
    """(first row, whole) of a solve over the interface rows: row 0 and the
    identity on one device; under ``shard`` (mesh, ranges) the rank's first
    row and the gather of its rows whole (``Mesh.gather_rows``)."""
    if shard is None:
        return 0, (lambda t: t)
    mesh, ranges = shard
    return ranges[mesh.rank][0], (lambda t: mesh.gather_rows(t, ranges))


def solve_cb_edge(
    element: torch.Tensor,
    charge: torch.Tensor,
    cb_edge_prev: torch.Tensor,              # (N,) f64 [J] warm start
    k_neigh_idx: torch.Tensor,
    metal_or_edge: torch.Tensor,             # (N, NN) bool: metal_i | metal_j (static)
    Vd: float,
    high_G: float,
    low_G: float,
    num_atoms_first_layer: int,
    tol: float = 1e-14,
    eV_to_J: float = EV_TO_J,
    shard=None,
    graphs=None,
    max_iterations: int = 100000,
) -> Tuple[torch.Tensor, CGResult]:
    """Laplace solve for the conduction-band edge profile, once per bias point.

    Reference: Assemble_A_CB + solve_sparse_CG_Jacobi + boundary fix + eV->J
    scaling (potential_solver_gpu.cu:574-772). The CB solve uses VL = +Vd/2,
    VR = -Vd/2 (the electron-energy sign) and the metal-OR rule for high-G
    edges (calc_off_diagonal_A_CB_gpu, 290-319); ``element`` and ``charge``
    do not enter it. ``shard`` and ``graphs`` as ``solve_potential_boundary``
    takes them. Inside a program's body ``Vd`` may be a 0-d tensor."""
    n = element.shape[0]
    L = R = num_atoms_first_layer
    n_int = n - L - R
    i0, whole = interface_rows(shard)
    if shard is None:
        k_neigh_idx, metal_or_edge = k_neigh_idx[L : n - R], metal_or_edge[L : n - R]

    nbr = k_neigh_idx
    valid = nbr >= 0
    hi = torch.full((), high_G, dtype=torch.float64, device=nbr.device)
    G = torch.where(metal_or_edge, hi, low_G)
    Gv = torch.where(valid, G, 0.0)

    j = nbr.clamp(min=0)
    in_left = valid & (j < L)
    in_right = valid & (j >= n - R)
    in_int = valid & ~(j < L) & ~(j >= n - R)

    diag_r = torch.sum(Gv, dim=1)
    diag = whole(diag_r)
    lsum = whole(torch.sum(torch.where(in_left, G, 0.0), dim=1))
    rsum = whole(torch.sum(torch.where(in_right, G, 0.0), dim=1))

    VL = Vd / 2.0
    VR = -Vd / 2.0
    rhs = lsum * VL + rsum * VR

    G_int = torch.where(in_int, G, 0.0)
    nbr_int = (j - L).clamp(0, n_int - 1)
    A = _interface_operator("cb_edge", diag_r, G_int, nbr_int, i0, whole)

    # warm start: the reference feeds the previous (J-scaled) buffer directly
    # as the V-space guess without undoing the eV->J scaling, i.e. a near-zero
    # guess; kept (potential_solver_gpu.cu:738)
    x0 = cb_edge_prev[L : n - R]
    if shard is None:
        res = symscaled_cg(A, diag, rhs, x0, tol=tol, max_iterations=max_iterations,
                           graphs=graphs)
    else:
        res = symscaled_cg_plain(A, diag, rhs, x0, tol=tol, max_iterations=max_iterations)

    full = torch.zeros(n, dtype=res.x.dtype, device=res.x.device)
    full[L : n - R] = res.x
    full[:L] = Vd / 2.0
    full[n - R :] = -Vd / 2.0
    return full * eV_to_J, res
