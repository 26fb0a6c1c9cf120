"""DIA (diagonal-offset) K operator for grid-native structures.

When the structure lives on a regular slot enumeration
(models/crossbar.py::grid_stack), the index offset j - i of every K edge
takes values in a small static set {o_1..o_D}, so the matvec decomposes by
offset:

    (K x)_i = diag_i x_i - sum_d w_d[i] x[i + o_d]

The static part (low_G adjacency + metal-metal high_G upgrades) is stored as
int8 codes per offset diagonal; the dynamic conductive-vacancy correction is
a second masked sum over the same diagonals. Both are the two halves of the
combined matvec (ops/dia_matvec.py). A K solve calls it once for the
conductive-vacancy degrees and then runs the whole Jacobi-CG through
solvers/dia_cg.py: one fused CUDA kernel on the card, the plain host loop on
the CPU. Reference semantics: background_potential_gpu_sparse,
potential_solver_gpu.cu:846-1128.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.ops.dia_matvec import DiaOperator
from akmc_tpu_torch.solvers.cg import CGResult
from akmc_tpu_torch.solvers.dia_cg import dia_cg_solve, dia_cg_solve_sharded


@dataclass
class DiaK:
    """Static pieces of the DIA-format K operator (site order = file order)."""

    diags: torch.Tensor        # (D, N) int8 edge codes: 0 none, 1 low_G, 2 high_G
    offsets: torch.Tensor      # (D,) int64 ascending offsets (the kernel's argument)
    deg_static: torch.Tensor   # (N,) f64 static diagonal (all-neighbor G sums)
    lsum: torch.Tensor         # (N,) f64 static left-contact row sums
    rsum: torch.Tensor         # (N,) f64 static right-contact row sums
    pos: torch.Tensor          # (N, 3) f64
    active_row: torch.Tensor   # (N,) bool: row has any edge (null slots -> False)

    def to(self, device: torch.device) -> "DiaK":
        return DiaK(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    def operator(self, meta: "DiaMeta", row0: int = 0, n: Optional[int] = None) -> DiaOperator:
        """The codes and offsets as the kernels take them, checked once and
        kept for every later solve. ``row0``/``n``: these codes are rows
        [row0, row0 + R) of an n-row operator (a rank's slab)."""
        op = self.__dict__.get("_operator")
        want = (meta.val_low, meta.val_high, row0, self.diags.shape[1] if n is None else n)
        if op is None or (op.val_low, op.val_high, op.row0, op.n) != want:
            op = self.__dict__["_operator"] = DiaOperator(
                self.diags, self.offsets, meta.val_low, meta.val_high, row0=row0, n=n
            )
        return op


class DiaMeta(NamedTuple):
    offsets: Tuple[int, ...]   # the same offsets as Python ints
    val_low: float = 0.0       # decode constants of the int8 codes
    val_high: float = 0.0


def _windows(v: torch.Tensor, offsets) -> list:
    """v[i + o] for every offset o, zero outside [0, n): the shifted views
    of one zero-padded copy."""
    n = v.shape[0]
    maxo = max(abs(int(o)) for o in offsets)
    vp = torch.zeros(n + 2 * maxo, dtype=v.dtype, device=v.device)
    vp[maxo: maxo + n] = v
    return [vp[maxo + int(o): maxo + int(o) + n] for o in offsets]


def dia_matvec(dia: DiaK, meta: DiaMeta, x: torch.Tensor) -> torch.Tensor:
    """y = W @ x: one shifted multiply-add per diagonal in ascending d, the
    edge values decoded from the int8 codes ({0, low_G, high_G})."""
    hi, lo = (torch.tensor(float(v), dtype=x.dtype, device=x.device)
              for v in (meta.val_high, meta.val_low))
    y = torch.zeros_like(x)
    for c, w in zip(dia.diags, _windows(x, meta.offsets)):
        y = y + torch.where(c == 2, hi, torch.where(c == 1, lo, 0.0)) * w
    return y


def fold_cvac_codes(dia: DiaK, meta: DiaMeta, cvac: torch.Tensor) -> torch.Tensor:
    """(D, N) int8: 1 where row i has an edge at offset o_d and its source
    column i + o_d is a conductive vacancy, else 0. The kernel packs the
    same bits into its row words (``solvers/dia_cg.py::pack_row_masks_plain``)."""
    return torch.stack([(c != 0).to(torch.int8) * w
                        for c, w in zip(dia.diags, _windows(cvac.to(torch.int8), meta.offsets))])


def dia_adj_matvec(dia: DiaK, meta: DiaMeta, x: torch.Tensor) -> torch.Tensor:
    """y_i = sum of x[i + o_d] over the K-adjacency edges of row i (0/1
    weights). The combined kernel's second output is this product of the
    conductive-vacancy indicator, which is how the K solve gets it."""
    y = torch.zeros_like(x)
    for c, w in zip(dia.diags, _windows(x, meta.offsets)):
        y = y + torch.where(c != 0, w, 0.0)
    return y


def make_dia(diags, deg_static, lsum, rsum, pos, active_row, offsets,
             low_G, high_G) -> Tuple[DiaK, DiaMeta]:
    """(DiaK, DiaMeta) on the CPU from host arrays."""
    dia = DiaK(
        diags=torch.tensor(np.asarray(diags, np.int8)),
        offsets=torch.tensor(np.asarray(offsets, np.int64)),
        deg_static=torch.tensor(np.asarray(deg_static, np.float64)),
        lsum=torch.tensor(np.asarray(lsum, np.float64)),
        rsum=torch.tensor(np.asarray(rsum, np.float64)),
        pos=torch.tensor(np.asarray(pos, np.float64)),
        active_row=torch.tensor(np.asarray(active_row, bool)),
    )
    meta = DiaMeta(
        offsets=tuple(int(o) for o in offsets),
        val_low=float(low_G), val_high=float(high_G),
    )
    return dia, meta


def build_dia_k(
    pos: np.ndarray,
    k_neigh_idx: np.ndarray,
    is_metal: np.ndarray,
    num_atoms_first_layer: int,
    high_G: float,
    low_G: float,
    max_diags: int = 160,
) -> Optional[Tuple[DiaK, DiaMeta]]:
    """Host-side construction from the K adjacency table. Returns None when
    the structure's offset set is larger than ``max_diags`` (disordered
    structures such as the 5 nm device, which use the banded operator)."""
    n = pos.shape[0]
    valid = k_neigh_idx >= 0
    if not valid.any():
        return None
    rows_v, cols_v = np.nonzero(valid)
    jc_v = k_neigh_idx[rows_v, cols_v].astype(np.int64)
    offs_v = jc_v - rows_v
    uniq = np.unique(offs_v)
    if len(uniq) > max_diags:
        return None

    mm_v = is_metal[rows_v] & is_metal[jc_v]
    vals_v = np.where(mm_v, high_G, low_G)

    diags = np.zeros((len(uniq), n), np.int8)
    d_idx = np.searchsorted(uniq, offs_v)
    np.add.at(diags, (d_idx, rows_v), np.int8(1))
    # no two edges may share a (row, offset) slot: code 2 is reserved for
    # the metal-metal value
    if int(diags.max()) > 1:
        raise ValueError("duplicate (row, offset) edge in k_neigh_idx")
    np.add.at(diags, (d_idx[mm_v], rows_v[mm_v]), np.int8(1))

    deg_static = np.bincount(rows_v, weights=vals_v, minlength=n)
    L = R = num_atoms_first_layer
    in_left = jc_v < L
    in_right = jc_v >= n - R
    lsum = np.bincount(rows_v[in_left], weights=vals_v[in_left], minlength=n)
    rsum = np.bincount(rows_v[in_right], weights=vals_v[in_right], minlength=n)
    return make_dia(diags, deg_static, lsum, rsum, pos, valid.any(axis=1),
                    uniq, low_G, high_G)


class KSystem(NamedTuple):
    """The once-per-solve vectors of one boundary-potential K solve: what
    ``solvers/dia_cg.py::dia_cg_solve`` takes beside the operator."""

    cvac: torch.Tensor       # (N,) bool: conductive vacancy (all rows)
    is_int: torch.Tensor     # (N,) bool: interior row with at least one edge
    diag_i: torch.Tensor     # (N,) f64: K diagonal, 1 outside the interior
    dgc: torch.Tensor        # (N,) f64: high_G - low_G on conductive vacancies
    inv_diag: torch.Tensor   # (N,) f64: Jacobi preconditioner
    rhs: torch.Tensor        # (N,) f64
    x0: torch.Tensor         # (N,) f64: warm start, zero outside the interior


def k_system(
    dia: DiaK,
    meta: DiaMeta,
    element: torch.Tensor,
    charge: torch.Tensor,
    potential_boundary_prev: torch.Tensor,
    Vd: float,
    high_G: float,
    low_G: float,
    num_atoms_first_layer: int,
    row0: int = 0,
) -> KSystem:
    """Matrix diagonal, right-hand side and start of the K solve; one
    combined-matvec call for the conductive-vacancy degrees. ``row0``: ``dia``
    holds rows [row0, row0 + R) of the operator (a rank's slab), and every
    vector but ``cvac`` (whole) is those rows of the whole solve's."""
    n = element.shape[0]
    rows = dia.diags.shape[1]
    L = R = num_atoms_first_layer
    dG = high_G - low_G
    f64 = torch.float64
    sl = slice(row0, row0 + rows)

    # conductive vacancies couple through the same nn_dist adjacency: the
    # combined matvec's V half on the vacancy indicator counts each site's
    # conductive-vacancy neighbours
    cvac = (element == int(ELEM.VACANCY)) & (charge == 0)
    cv = cvac.to(f64)
    vdeg = dia.operator(meta, row0, n).matvec(cv, cv)[1]
    cvac_r = cvac[sl]
    diag = dia.deg_static + dG * torch.where(cvac_r, vdeg, 0.0)

    idxs = torch.arange(row0, row0 + rows, device=element.device)
    is_int = (idxs >= L) & (idxs < n - R) & dia.active_row

    rhs = (dia.lsum * (-Vd / 2.0) + dia.rsum * (Vd / 2.0)) * is_int

    # CG keeps every iterate exactly zero outside the interior (x0 and rhs
    # are masked, A passes exterior rows through), so the masks fold into
    # these once-per-solve vectors
    diag_i = torch.where(is_int, diag, 1.0)
    dgc = torch.where(cvac_r, torch.tensor(dG, dtype=f64, device=diag.device), 0.0)
    x0 = torch.where(is_int, potential_boundary_prev[sl], 0.0)
    inv_diag = torch.where(is_int, 1.0 / diag_i, 1.0)
    return KSystem(cvac=cvac, is_int=is_int, diag_i=diag_i, dgc=dgc,
                   inv_diag=inv_diag, rhs=rhs, x0=x0)


def solve_potential_boundary_dia(
    dia: DiaK,
    meta: DiaMeta,
    element: torch.Tensor,
    charge: torch.Tensor,
    potential_boundary_prev: torch.Tensor,
    Vd: float,
    high_G: float,
    low_G: float,
    num_atoms_first_layer: int,
    rtol_coeff: float = 1e-14,
    max_iterations: int = 10000,
) -> Tuple[torch.Tensor, CGResult]:
    """Boundary-potential K solve: same matrix entries, right-hand side,
    zero-outside-interior start and CG stop rule as
    ``akmc_tpu/solvers/dia.py::solve_potential_boundary_dia``. On the card
    the CG is one launch of the fused kernel and the iteration count is the
    solve's only host read; on the CPU it is the plain host loop with the
    kernel's dot-product order."""
    ks = k_system(dia, meta, element, charge, potential_boundary_prev, Vd,
                  high_G, low_G, num_atoms_first_layer)
    n_int = element.shape[0] - 2 * num_atoms_first_layer
    res = dia_cg_solve(dia.operator(meta), *ks, rtol_coeff * n_int, max_iterations)
    res = res._replace(iterations=int(res.iterations))   # on the card: the one host read
    return torch.where(ks.is_int, res.x, 0.0), res


def solve_potential_boundary_dia_sharded(
    dia: DiaK,
    meta: DiaMeta,
    mesh,
    ranges,
    element: torch.Tensor,
    charge: torch.Tensor,
    potential_boundary_prev: torch.Tensor,
    Vd: float,
    high_G: float,
    low_G: float,
    num_atoms_first_layer: int,
    rtol_coeff: float = 1e-14,
    max_iterations: int = 10000,
) -> Tuple[torch.Tensor, CGResult]:
    """``solve_potential_boundary_dia`` over the ranks of ``mesh``: ``dia``
    holds this rank's rows ``ranges[mesh.rank]`` (whole 256-row chunks; the
    last rank takes the ragged end) and the solve is
    ``solvers/dia_cg.py::dia_cg_solve_sharded``, one row-window matvec per
    rank for the degrees and one per CG iteration. Returns the whole
    potential on every rank, equal to the one-device solve's to the bit."""
    r0, _ = ranges[mesh.rank]
    ks = k_system(dia, meta, element, charge, potential_boundary_prev, Vd,
                  high_G, low_G, num_atoms_first_layer, row0=r0)
    n_int = element.shape[0] - 2 * num_atoms_first_layer
    op = dia.operator(meta, r0, element.shape[0])
    res = dia_cg_solve_sharded(op, mesh, ranges, *ks, rtol_coeff * n_int, max_iterations)
    pot = mesh.gather_rows(torch.where(ks.is_int, res.x, 0.0), ranges)
    return pot, res
