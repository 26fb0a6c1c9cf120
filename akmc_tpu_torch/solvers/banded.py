"""Banded-dense K operator for narrow-band disordered structures (the 5 nm
device class), as ``akmc_tpu/solvers/banded.py`` defines it.

The edge conductance of the K matrix decomposes as

    G_ij = high_G  if (metal_i & metal_j) or (cvac_i & cvac_j) else low_G
         = low_G + dG*[metal_i & metal_j] + dG*[cvac_i & cvac_j]

(the two indicator sets are disjoint — metals are never vacancies). The
first two terms are STATIC: positions, adjacency and metal sites never
change during a run. Only the conductive-vacancy correction is dynamic,
and it is supported on <= VMAX vacancy sites. Therefore:

    A x = diag .* x - BAND(x) - dG * S_cvac(x)

where BAND is a precomputed dense-banded matrix (low_G*adjacency +
dG*metal-metal edges), stored as int8 codes in (nb, T, W) blocks of T rows
with a window of W = T + 2*half_band columns each, and S_cvac is a small
on-the-fly (VMAX x VMAX) adjacency among the compacted conductive
vacancies. Sites are internally permuted to a locality (lexicographic)
order so the adjacency bandwidth is ~2 x-slices; permutation in/out of the
solver frame costs two O(N) gathers per solve.

``band_matvec`` applies the band as one batched dense product of the blocks,
decoded once per operator into f64 with the host-summed constants of
``BandMeta``, with the strided windows of the padded vector: a library
product (``torch.bmm``) of a plain dense matrix, which ``akmc_tpu`` too
computes outside any hand-written kernel. The CG around it is the device
loop of ``solvers/cg.py::jacobi_cg`` (k iterations per CUDA-graph replay);
under a mesh, its host loop.

Reference semantics preserved (same matrix entries, same CG, same stopping
rule — background_potential_gpu_sparse, potential_solver_gpu.cu:846-1128);
only float summation order changes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.ops.compact import compact_mask
from akmc_tpu_torch.solvers.cg import (
    CGResult, Operator, addresses, f64_matvec, jacobi_cg, jacobi_cg_plain,
)


@dataclass
class BandedK:
    """Static pieces of the banded K operator, all in the SOLVER frame."""

    perm: torch.Tensor          # (N,) int64 site index (orig) per solver-frame slot
    inv_perm: torch.Tensor      # (N,) int64 solver-frame slot per site
    blocks: torch.Tensor        # (nb, T, W) int8 band codes: 0 = no edge,
    #                             1 = low_G edge, 2 = metal-metal (low_G + dG) edge
    deg_static: torch.Tensor    # (N,) f64 static diagonal part
    lsum: torch.Tensor          # (N,) f64 static left-contact row sums
    rsum: torch.Tensor          # (N,) f64 static right-contact row sums
    pos_p: torch.Tensor         # (N, 3) f64 positions
    is_vac_site: torch.Tensor   # (N,) bool static possibly-vacancy mask
    is_int: torch.Tensor        # (N,) bool static interface-row mask

    def to(self, device: torch.device) -> "BandedK":
        return BandedK(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    def values(self, meta: "BandMeta") -> torch.Tensor:
        """(nb, T, W) f64 band values: the codes decoded once with the
        constants of ``meta``, on the device the codes live on, and kept for
        every later matvec (8 bytes per slot instead of 1: 514 MB at
        N = 31,088, T = 512, W = 2,056)."""
        cached = self.__dict__.get("_values")
        if cached is None or cached[0] != (meta.val_low, meta.val_both):
            c = self.blocks
            zero = torch.zeros((), dtype=torch.float64, device=c.device)
            dec = torch.where(c == 2, zero + meta.val_both,
                              torch.where(c == 1, zero + meta.val_low, zero))
            cached = self.__dict__["_values"] = ((meta.val_low, meta.val_both), dec)
        return cached[1]


class BandMeta(NamedTuple):
    half_band: int
    block_rows: int
    n_pad: int
    # band-value decode constants (host f64): code 1 -> val_low, code 2 ->
    # val_both (= low_G + dG summed on the HOST, so the decoded values are
    # the same f64 numbers on every device)
    val_low: float = 0.0
    val_both: float = 0.0


def build_banded_k(
    pos: np.ndarray,                # (N, 3)
    k_neigh_idx: np.ndarray,        # (N, NN) PBC-aware adjacency, -1 pad
    is_metal: np.ndarray,           # (N,) bool
    element0: np.ndarray,           # (N,) initial elements (for vacancy support)
    num_atoms_first_layer: int,
    high_G: float,
    low_G: float,
    block_rows: int = 512,
    max_bandwidth: Optional[int] = None,
    max_band_bytes: float = 4e9,
) -> Optional[Tuple[BandedK, BandMeta]]:
    """Host-side construction (tensors on the CPU). Returns None if the
    lexsorted bandwidth is too wide for the dense band to pay off, or if the
    int8 band blocks would exceed ``max_band_bytes`` (fall back to the ELL
    path)."""
    n = pos.shape[0]
    valid = k_neigh_idx >= 0
    if not valid.any():
        return None

    # internal ordering: axis-permuted lexsort, keeping whichever outer axis
    # yields the smallest measured bandwidth (thin-x device stacks prefer
    # x-outer, wide-y/z crossbar sheets z-outer)
    jc = np.clip(k_neigh_idx, 0, None)
    best = None
    for keys in (
        (pos[:, 2], pos[:, 1], pos[:, 0]),      # x-outer
        (pos[:, 2], pos[:, 0], pos[:, 1]),      # y-outer
        (pos[:, 0], pos[:, 1], pos[:, 2]),      # z-outer
    ):
        o = np.lexsort(keys)
        iv = np.empty(n, np.int64)
        iv[o] = np.arange(n)
        b = int(np.abs(np.where(valid, iv[jc] - iv[:, None], 0)).max())
        if best is None or b < best[0]:
            best = (b, o, iv)
    B, order, inv = best

    limit = max_bandwidth if max_bandwidth is not None else n // 4
    if B > limit:
        return None

    T = block_rows
    nb = -(-n // T)
    n_pad = nb * T
    W = T + 2 * B
    if nb * T * W * 1.0 > max_band_bytes:
        return None

    dG = high_G - low_G
    mm = is_metal[:, None] & is_metal[jc] & valid

    # scatter edge CODES into band blocks (solver frame): 1 = low_G edge,
    # 2 = metal-metal (low_G + dG) edge
    blocks = np.zeros((nb, T, W), np.int8)
    src_rows = np.broadcast_to(inv[:, None], k_neigh_idx.shape)[valid]
    src_cols = inv[jc][valid]
    b_idx = src_rows // T
    r_idx = src_rows % T
    w_idx = src_cols - (b_idx * T - B)
    if not ((w_idx >= 0) & (w_idx < W)).all():
        raise ValueError("an edge of k_neigh_idx falls outside its band window")
    np.add.at(blocks, (b_idx, r_idx, w_idx), np.int8(1))
    # no two edges may share a band slot (adjacency rows hold unique cols):
    # a colliding edge would decode as code 2 = the metal-metal value
    if blocks.max() > 1:
        raise ValueError("duplicate (row, col) edge in k_neigh_idx")
    mm_e = mm[valid]
    np.add.at(blocks, (b_idx[mm_e], r_idx[mm_e], w_idx[mm_e]), np.int8(1))

    # static diagonal / contact row sums / interface mask, stored permuted
    L = R = num_atoms_first_layer
    G = np.where(mm, high_G, low_G)
    deg_static = np.where(valid, G, 0.0).sum(1)
    lsum = np.where(valid & (jc < L), G, 0.0).sum(1)
    rsum = np.where(valid & (jc >= n - R), G, 0.0).sum(1)

    poss_vac = np.isin(
        element0, [int(ELEM.O), int(ELEM.VACANCY), int(ELEM.OXYGEN_DEFECT), int(ELEM.DEFECT)]
    )

    bk = BandedK(
        perm=torch.from_numpy(order.astype(np.int64)),
        inv_perm=torch.from_numpy(inv.astype(np.int64)),
        blocks=torch.from_numpy(blocks),
        deg_static=torch.from_numpy(deg_static[order]),
        lsum=torch.from_numpy(lsum[order]),
        rsum=torch.from_numpy(rsum[order]),
        pos_p=torch.from_numpy(np.ascontiguousarray(pos[order], dtype=np.float64)),
        is_vac_site=torch.from_numpy(poss_vac[order]),
        is_int=torch.from_numpy((order >= L) & (order < n - R)),
    )
    return bk, BandMeta(
        half_band=B, block_rows=T, n_pad=n_pad,
        val_low=float(low_G), val_both=float(low_G + dG),
    )


def band_matvec(bk: BandedK, meta: BandMeta, x_p: torch.Tensor,
                block0: int = 0) -> torch.Tensor:
    """y = BAND @ x in the solver frame. x_p: (N,) full-length (contacts
    included).

    Block t holds rows [t*T, (t+1)*T) against the window
    x[t*T - B : t*T + T + B]; the windows are a strided view of the
    zero-padded vector (no gather), and the product is one ``torch.bmm`` of
    the decoded (nb, T, W) f64 blocks with them. ``block0``: ``bk`` holds
    blocks [block0, block0 + nb) of the band (a rank's share), and the
    result is their rows."""
    n = x_p.shape[0]
    B, T, n_pad = meta.half_band, meta.block_rows, meta.n_pad
    W = T + 2 * B
    nb = bk.blocks.shape[0]
    xe = torch.zeros(n_pad + 2 * B, dtype=x_p.dtype, device=x_p.device)
    xe[B : B + n] = x_p
    windows = xe.unfold(0, W, T)[block0 : block0 + nb]      # windows[t] = xe[t*T : t*T + W]
    y = torch.bmm(bk.values(meta), windows.unsqueeze(-1)).squeeze(-1)
    return y.reshape(nb * T)[: max(0, min(nb * T, n - block0 * T))]


def sharded_band_matvec(bk: BandedK, meta: BandMeta, x_p: torch.Tensor, shard) -> torch.Tensor:
    """``band_matvec`` whole on every rank: ``shard`` (mesh, every rank's
    block range), ``bk`` this rank's blocks; each rank computes its blocks'
    rows, which are gathered (``Mesh.gather_rows``). None: ``band_matvec``."""
    if shard is None:
        return band_matvec(bk, meta, x_p)
    mesh, br = shard
    n, T = x_p.shape[0], meta.block_rows
    rows = [(min(a * T, n), min(b * T, n)) for a, b in br]
    return mesh.gather_rows(band_matvec(bk, meta, x_p, br[mesh.rank][0]), rows)


def cvac_correction(
    bk: BandedK,
    cvac_p: torch.Tensor,        # (N,) bool conductive-vacancy mask, solver frame
    nn_dist: float,
    lattice: torch.Tensor,
    pbc: bool,
    vmax: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compacted conductive-vacancy adjacency: returns (idx (VMAX,), valid,
    W (VMAX, VMAX) 0/1, deg (VMAX,)). Edges = pairs of cvac sites within
    nn_dist (PBC-aware — matches the K sparsity rule). The index list is
    ``compact_mask``'s, in its order."""
    idx, vv = compact_mask(cvac_p, vmax)
    p = bk.pos_p[idx.clamp(min=0)]
    d = p[:, None, :] - p[None, :, :]
    if pbc:
        dy = d[..., 1] / lattice[1]
        dy = (dy - torch.round(dy)) * lattice[1]
        dz = d[..., 2] / lattice[2]
        dz = (dz - torch.round(dz)) * lattice[2]
        d2 = d[..., 0] ** 2 + dy**2 + dz**2
    else:
        d2 = torch.sum(d * d, -1)
    same = idx[:, None] == idx[None, :]
    W = ((d2 < nn_dist * nn_dist) & ~same & vv[:, None] & vv[None, :]).to(d2.dtype)
    return idx, vv, W, torch.sum(W, dim=1)


class KCarry(NamedTuple):
    """Warm-solve carry (solver frame): the previous solve's final
    residual, diagonal and compacted cvac correction. Lets the next solve
    rebase  r0 = r + (diag_prev - diag_new)∘x0 + (S_new - S_prev)(x0)
    — exact ΔA·x0 terms from O(N) vector ops and the two compacted
    (vmax, vmax) planes — instead of paying the band matvec for a fresh
    b - A·x0. The band part of A is static, which is what makes the delta
    exact; r is a recurrence residual, so a caller re-bases with a fresh
    matvec (``carry=None``) now and then."""

    r: torch.Tensor           # (N,) final residual, solver frame
    diag: torch.Tensor        # (N,) diagonal used in that solve
    vidx: torch.Tensor        # (VMAX,) compacted cvac sites of that solve
    vv: torch.Tensor          # (VMAX,) valid mask
    Wv: torch.Tensor          # (VMAX, VMAX) cvac adjacency of that solve


def _scatter(n, idx_, vv_, vals):
    """Zeros with ``vals`` added at the valid ``idx_``: every real target
    occurs once (``compact_mask``'s list) and pad slots add exact zeros at
    index 0, so the sum is the same in any order of the device's atomics."""
    out = torch.zeros(n, dtype=torch.float64, device=vals.device)
    return out.index_add_(0, idx_.clamp(min=0), torch.where(vv_, vals, 0.0))


def _s_corr(x_p, vidx_, vv_, Wv_, dG):
    """dG-scaled compacted cvac-adjacency scatter term."""
    xv = torch.where(vv_, x_p[vidx_.clamp(min=0)], 0.0)
    return _scatter(x_p.shape[0], vidx_, vv_, dG * f64_matvec(Wv_, xv))


def _banded_op(x_p, diag_p, vidx, vv, Wv, *, bk, meta, dG, shard):
    """A x in the solver frame: x_p a full-length vector, contacts implicitly
    zero."""
    is_int_p = bk.is_int
    xz = torch.where(is_int_p, x_p, 0.0)
    y = diag_p * xz - sharded_band_matvec(bk, meta, xz, shard)
    y = y - _s_corr(xz, vidx, vv, Wv, dG)
    # BAND includes edges to contact columns, but xz zeroes them; rows of
    # contacts are masked out of the solve entirely:
    return torch.where(is_int_p, y, x_p)


def _assemble_banded(bk, meta, element, charge, Vd, high_G, low_G,
                     num_atoms_first_layer, nn_dist, lattice, pbc, vmax, shard=None):
    """The solve's pieces; the operator is an ``Operator`` over the
    per-solve diagonal and compacted cvac plane. ``shard`` (mesh, block
    ranges): ``bk`` holds this rank's band blocks and the band product is
    gathered whole (``sharded_band_matvec``); every vector stays whole on
    every rank, so the CG computes on each what it computes on one device."""
    n = element.shape[0]
    dG = high_G - low_G
    cvac = (element == int(ELEM.VACANCY)) & (charge == 0)
    cvac_p = cvac[bk.perm]
    vidx, vv, Wv, vdeg = cvac_correction(bk, cvac_p, nn_dist, lattice, pbc, vmax)

    # diagonal: static all-neighbor sums + dynamic cvac-edge upgrades
    diag_p = bk.deg_static + dG * _scatter(n, vidx, vv, vdeg)
    is_int_p = bk.is_int
    rhs_p = (bk.lsum * (-Vd / 2.0) + bk.rsum * (Vd / 2.0)) * is_int_p

    A_frame = Operator(
        "banded", functools.partial(_banded_op, bk=bk, meta=meta, dG=dG, shard=shard),
        (diag_p, vidx, vv, Wv),
        (addresses(bk.values(meta), bk.is_int, bk.perm), meta, dG),
    )

    def S_corr(x_p, vidx_, vv_, Wv_):
        return _s_corr(x_p, vidx_, vv_, Wv_, dG)

    return cvac_p, (vidx, vv, Wv), diag_p, is_int_p, rhs_p, A_frame, S_corr


def _k_cg(A, rhs_p, x0_p, inv_diag_p, rtol, max_iterations, shard, graphs, r0=None):
    """The K-CG: the device loop, or under ``shard`` the host loop (gloo
    collectives cannot be captured into a graph)."""
    if shard is None:
        return jacobi_cg(A, rhs_p, x0_p, inv_diag_p, rtol, max_iterations, r0=r0,
                         graphs=graphs)
    return jacobi_cg_plain(A, rhs_p, x0_p, inv_diag_p, rtol, max_iterations, r0=r0)


def solve_potential_boundary_banded(
    bk: BandedK,
    meta: BandMeta,
    element: torch.Tensor,
    charge: torch.Tensor,
    potential_boundary_prev: torch.Tensor,
    Vd: float,
    high_G: float,
    low_G: float,
    num_atoms_first_layer: int,
    nn_dist: float,
    lattice: torch.Tensor,
    pbc: bool,
    vmax: int,
    rtol_coeff: float = 1e-14,
    max_iterations: int = 10000,
    shard=None,
    graphs=None,
) -> Tuple[torch.Tensor, CGResult]:
    """Drop-in replacement for poisson.solve_potential_boundary using the
    static band + dynamic cvac correction. ``shard`` (mesh, block ranges):
    ``bk`` holds this rank's blocks (``_assemble_banded``). ``graphs``: the
    caller's ``LoopGraphs`` for the CG's device loop (``solvers/cg.py``)."""
    n = element.shape[0]
    n_int = n - 2 * num_atoms_first_layer

    _, _, diag_p, is_int_p, rhs_p, A_frame, _ = _assemble_banded(
        bk, meta, element, charge, Vd, high_G, low_G,
        num_atoms_first_layer, nn_dist, lattice, pbc, vmax, shard,
    )

    # CG over the full-length frame with identity on contact rows: keeps the
    # solve equivalent to the interface-restricted system since rhs and x0
    # are zero on contacts.
    x0_p = torch.where(is_int_p, potential_boundary_prev[bk.perm], 0.0)
    inv_diag_p = torch.where(is_int_p, 1.0 / diag_p, 1.0)

    res = _k_cg(A_frame, rhs_p, x0_p, inv_diag_p, rtol_coeff * n_int, max_iterations,
                shard, graphs)
    full = torch.where(is_int_p, res.x, 0.0)[bk.inv_perm]
    return full, res


def solve_potential_boundary_banded_carry(
    bk: BandedK,
    meta: BandMeta,
    element: torch.Tensor,
    charge: torch.Tensor,
    potential_boundary_prev: torch.Tensor,
    Vd: float,
    high_G: float,
    low_G: float,
    num_atoms_first_layer: int,
    nn_dist: float,
    lattice: torch.Tensor,
    pbc: bool,
    vmax: int,
    carry: Optional[KCarry],
    rtol_coeff: float = 1e-14,
    max_iterations: int = 10000,
    shard=None,
    graphs=None,
) -> Tuple[torch.Tensor, CGResult, KCarry]:
    """Warm solve with an incrementally-rebased initial residual.

    With ``carry`` (None = fresh) the entry matvec r0 = b - A·x0 is replaced
    by the exact identity r0 = carry.r + (carry.diag - diag)∘x0 +
    (S_new - S_prev)(x0): the band is static, so A only changes through the
    diagonal and the compacted cvac adjacency, both cheap; S_prev reuses the
    carried compacted plane. b is constant within a bias (rhs = static
    contact sums × Vd). carry=None (a bias change, or a periodic re-base)
    runs the fresh path, which also re-bases any recurrence-residual drift
    from the CG iterations of previous steps. ``shard`` and ``graphs`` as
    ``solve_potential_boundary_banded`` takes them."""
    n = element.shape[0]
    n_int = n - 2 * num_atoms_first_layer

    _, (vidx, vv, Wv), diag_p, is_int_p, rhs_p, A_frame, S_corr = _assemble_banded(
        bk, meta, element, charge, Vd, high_G, low_G,
        num_atoms_first_layer, nn_dist, lattice, pbc, vmax, shard,
    )
    x0_p = torch.where(is_int_p, potential_boundary_prev[bk.perm], 0.0)
    inv_diag_p = torch.where(is_int_p, 1.0 / diag_p, 1.0)

    if carry is None:
        r0 = rhs_p - A_frame(x0_p)
    else:
        d_diag = (carry.diag - diag_p) * x0_p
        dS = S_corr(x0_p, vidx, vv, Wv) - S_corr(x0_p, carry.vidx, carry.vv, carry.Wv)
        r0 = torch.where(is_int_p, carry.r + d_diag + dS, 0.0)

    res = _k_cg(A_frame, rhs_p, x0_p, inv_diag_p, rtol_coeff * n_int, max_iterations,
                shard, graphs, r0=r0)
    full = torch.where(is_int_p, res.x, 0.0)[bk.inv_perm]
    new_carry = KCarry(r=res.r, diag=diag_p, vidx=vidx, vv=vv, Wv=Wv)
    return full, res, new_carry
