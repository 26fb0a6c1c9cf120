"""Pairwise screened-Coulomb potential of the charged defects.

Reference: poisson_gridless_gpu / calculate_pairwise_interaction_indexed
(potential_solver_gpu.cu:1525-1655):

    potential[i] = sum_{j within cutoff, j != i, charge_j != 0}
                   charge_j * erfc(d_ij / (sigma*sqrt(2))) * k * e / d_ij

with d_ij = 1e-10 * the non-PBC Euclidean distance. The summand is nonzero
only for currently charged sites, so every path sums over a compacted
charged-site list of at most ``qmax`` entries (``compact_mask``; an overflow
flag tells the caller to grow the cap). Three paths, the same pair set and
per-pair operations in each (``akmc_tpu/ops/pairwise.py``):

* ``pairwise_potential_table``: charged sites are always drawn from the
  static possibly-charged (active) class and positions never change, so the
  kernel g(d_iq) is tabulated once for every (active site q, site i) pair
  (full f64 storage); each superstep gathers the rows of the charged sites
  and takes one multiply-reduce.
* ``pairwise_potential_tiled``: for structures whose table does not fit.
  Sites are binned into cubic tiles; per solve each tile gets a compacted
  list of the charged sites within reach (cutoff + tile circumradius) and
  the erfc plane shrinks from (N, qmax) to (T, S, C). On a card one
  hand-written kernel (``csrc/pair_tiled.cu``) does it all on chip; its
  plain twin ``pairwise_potential_tiled_plain`` runs on the CPU.
* ``pairwise_potential``: the on-the-fly (N, qmax) plane, row-blocked.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from akmc_tpu_torch.ops import cuda_build, device_loop
from akmc_tpu_torch.ops.compact import compact_mask

Q_E = 1.60217663e-19


class PairTiling(NamedTuple):
    """Static spatial tiling for the tiled pairwise solve."""

    tile_sites: torch.Tensor    # (T, S) int64 site ids, -1 pad
    pos_tiles: torch.Tensor     # (T, S, 3) f64 site positions (pad -> 1e30)
    tile_center: torch.Tensor   # (T, 3) f64 tile centers

    def to(self, device) -> "PairTiling":
        return PairTiling(*(t.to(device) for t in self))


def _charged_list(pos, charge, qmax):
    """The compacted charged-site list every path sums over:
    (q_idx, valid, positions (Q, 3), charges (Q,) as f64, overflow flag)."""
    charged = charge != 0
    q_idx, qv = compact_mask(charged, qmax)
    qi = q_idx.clamp(min=0)
    q_val = torch.where(qv, charge[qi], 0).to(pos.dtype)
    return q_idx, qv, pos[qi], q_val, charged.sum() > qmax


def pairwise_potential(
    pos: torch.Tensor,         # (N, 3) f64 [Angstrom]
    charge: torch.Tensor,      # (N,) int32
    cutoff_radius: float,      # [Angstrom]
    sigma: float,              # [m]
    k: float,                  # [N m^2 / C^2]
    qmax: int = 2048,
    row_block: Optional[int] = None,
    plane_budget: int = 512 * 1024 * 1024,
    row_range: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-the-fly solve. Returns ((N,) potential [V], overflow flag).

    Rows are independent, so any partition into row blocks gives the same
    values; planes past ``plane_budget`` bytes are cut into blocks of 4096
    rows. ``row_range`` (start, stop): only those rows' potentials (a rank's
    share)."""
    n = pos.shape[0]
    start, stop = (0, n) if row_range is None else row_range
    if row_block is None:
        row_block = n if n * qmax * 8 <= plane_budget else 4096
    q_idx, qv, q_pos, q_val, overflow = _charged_list(pos, charge, qmax)

    inv_sig = 1.0 / (sigma * math.sqrt(2.0))
    cut2 = cutoff_radius * cutoff_radius
    kq = k * Q_E
    rows = torch.arange(start, stop, device=pos.device)
    out = torch.empty(stop - start, dtype=pos.dtype, device=pos.device)
    for s in range(0, stop - start, row_block):
        r = rows[s : s + row_block]
        # exact difference-based d^2 (same rounding class as the reference's
        # site_dist_gpu)
        d2 = torch.sum((pos[r][:, None, :] - q_pos[None, :, :]) ** 2, dim=-1)
        valid = (d2 < cut2) & (r[:, None] != q_idx[None, :]) & qv[None, :]
        d = 1e-10 * torch.sqrt(torch.where(valid, d2, 1.0))
        v = q_val[None, :] * torch.special.erfc(d * inv_sig) * kq / d
        out[s : s + row_block] = torch.sum(torch.where(valid, v, 0.0), dim=1)
    return out, overflow


def build_pair_table(
    pos: torch.Tensor,          # (N, 3) f64 [Angstrom]
    poss_idx: torch.Tensor,     # (NP,) int64 possibly-charged sites (static)
    cutoff_radius: float,
    sigma: float,
    k: float,
    row_block: int = 256,
) -> torch.Tensor:
    """Static table gT[(q, i)] = g(d_iq), cutoff and self-exclusion baked in
    as exact zeros, NP padded up to the block size with all-zero rows.

    Built block by block straight into one preallocated (NP_pad, N) f64
    tensor, so no second copy of it ever exists (3.73 GB at the n_yz=24
    crossbar)."""
    n = pos.shape[0]
    np_rows = poss_idx.shape[0]
    nblk = -(-np_rows // row_block)
    table = torch.empty((nblk * row_block, n), dtype=pos.dtype, device=pos.device)
    inv_sig = 1.0 / (sigma * math.sqrt(2.0))
    cut2 = cutoff_radius * cutoff_radius
    kq = k * Q_E
    pad = torch.full((nblk * row_block - np_rows,), -1, dtype=torch.int64, device=pos.device)
    pi = torch.cat([poss_idx.to(torch.int64), pad])
    site_ids = torch.arange(n, device=pos.device)
    for b in range(nblk):
        pi_blk = pi[b * row_block : (b + 1) * row_block]
        q_pos = pos[pi_blk.clamp(min=0)]                            # (B, 3)
        d2 = torch.sum((q_pos[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
        valid = (
            (d2 < cut2)
            & (pi_blk[:, None] != site_ids[None, :])
            & (pi_blk[:, None] >= 0)
        )
        d = 1e-10 * torch.sqrt(torch.where(valid, d2, 1.0))
        g = torch.special.erfc(d * inv_sig) * kq / d
        table[b * row_block : (b + 1) * row_block] = torch.where(valid, g, 0.0)
    return table


def pairwise_potential_table(
    table: torch.Tensor,      # (NP_pad, N) f64 static interaction table
    site2col: torch.Tensor,   # (N,) int64 site -> table row
    charge: torch.Tensor,     # (N,) int32
    qmax: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ((N,) potential [V], overflow flag: more than ``qmax``
    charged sites, in which case the caller doubles qmax and repeats).

    ``table`` may hold some of the N site columns only (a rank's share): the
    result is then those sites' potentials. Each column adds its terms one
    after the other in the charged list's order (a running sum down the
    rows), an order that depends neither on how many columns there are nor
    on the device, so any split of the columns gives the same bits."""
    np_rows = table.shape[0]
    charged = charge != 0
    q_idx, qv = compact_mask(charged, qmax)
    qi = q_idx.clamp(min=0)
    q_val = torch.where(qv, charge[qi], 0).to(table.dtype)
    cols = site2col[qi].clamp(0, np_rows - 1)
    rows = table[cols]                                   # (Q, N) contiguous rows, a copy
    rows.mul_(q_val[:, None])
    pot = rows.cumsum_(0)[-1]                            # sequential down each column
    return pot, charged.sum() > qmax


def build_pair_tiling(
    pos: np.ndarray,           # (N, 3) f64 [Angstrom], host
    cutoff_radius: float,
    tile_edge: Optional[float] = None,
) -> Tuple[PairTiling, float]:
    """Host-side tile construction (tensors on the CPU). Returns (tiling,
    r_tile) where r_tile is the tile circumradius."""
    h = float(tile_edge if tile_edge is not None else cutoff_radius)
    mins = pos.min(axis=0)
    idx3 = np.floor((pos - mins) / h).astype(np.int64)
    dims = idx3.max(axis=0) + 1
    tid = (idx3[:, 0] * dims[1] + idx3[:, 1]) * dims[2] + idx3[:, 2]
    uniq, inv = np.unique(tid, return_inverse=True)
    T = len(uniq)
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv, minlength=T)
    S = int(counts.max())
    tile_sites = np.full((T, S), -1, np.int64)
    col = np.concatenate([np.arange(c) for c in counts])
    tile_sites[inv[order], col] = order
    pos_tiles = np.where(
        (tile_sites >= 0)[:, :, None], pos[tile_sites.clip(0)], 1e30
    )
    # centers of the occupied tiles, in the same grid frame
    t3 = np.stack(
        [uniq // (dims[1] * dims[2]), (uniq // dims[2]) % dims[1], uniq % dims[2]],
        axis=1,
    )
    centers = mins[None, :] + (t3 + 0.5) * h
    r_tile = h * float(np.sqrt(3.0)) / 2.0
    return (
        PairTiling(
            tile_sites=torch.from_numpy(tile_sites),
            pos_tiles=torch.from_numpy(pos_tiles),
            tile_center=torch.from_numpy(centers),
        ),
        r_tile,
    )


def _reach(tiling: PairTiling, r_tile: float, cutoff_radius: float) -> torch.Tensor:
    """The candidate filter's squared reach (0-d f32): cutoff + tile
    circumradius, padded against rounding proportionally to the coordinate
    magnitude. 0-d constants are made by a fill on the device, not copied
    from the host: the pairwise solve runs inside a captured superstep
    (models/step_program.py)."""
    f32, dev = torch.float32, tiling.tile_center.device
    coord_scale = torch.max(torch.abs(tiling.tile_center.to(f32)))
    pad = torch.full((), 1e-3, dtype=f32, device=dev) + 64.0 * torch.full(
        (), 1.2e-7, dtype=f32, device=dev) * coord_scale
    return (torch.full((), cutoff_radius + r_tile, dtype=f32, device=dev) + pad) ** 2


def _d2(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """(dx·dx + dy·dy) + dz·dz: the one order of the squared distance that
    the filter, the plane and ``csrc/pair_tiled.cu`` share."""
    return (dx * dx + dy * dy) + dz * dz


def tile_candidates(
    tiling: PairTiling,
    r_tile: float,
    q_pos: torch.Tensor,       # (Q, 3) f64 positions of the charged list
    qv: torch.Tensor,          # (Q,) bool valid entries of the charged list
    cutoff_radius: float,
    cand_cap: int,
    plane_budget: int = 512 * 1024 * 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per tile, the first ``cand_cap`` entries of the charged list within
    reach of the tile: (selected (T, C) bool, list positions (T, C) int64,
    overflow flag). Candidates keep the list's order: it is the summation
    order of the plane, and what makes any two devices agree.

    The filter runs in f32, blocked over tile chunks. It selects only: the
    reach is padded against rounding proportionally to the coordinate
    magnitude, the exact ``d2 < cutoff^2`` test still runs in the compute
    plane, and over-inclusion is harmless."""
    T = tiling.tile_center.shape[0]
    cen32 = tiling.tile_center.to(torch.float32)
    qp32 = q_pos.to(torch.float32)
    reach = _reach(tiling, r_tile, cutoff_radius)
    fblk = max(1, min(T, plane_budget // max(1, 4 * qv.shape[0])))
    sel, cand, cnt = [], [], []
    for s in range(0, T, fblk):
        diff = [cen32[s : s + fblk, None, a] - qp32[None, :, a] for a in range(3)]
        mask = (_d2(*diff) < reach) & qv[None, :]
        # in-reach entries first, each group in ascending list position: a
        # stable sort, because top-k selection does not keep ties in order
        ci = torch.sort((~mask).to(torch.int8), dim=1, stable=True).indices[:, :cand_cap]
        sel.append(torch.gather(mask, 1, ci))
        cand.append(ci)
        cnt.append(mask.sum(dim=1))
    return torch.cat(sel), torch.cat(cand), torch.cat(cnt).max() > cand_cap


def pairwise_potential_tiled_plain(
    tiling: PairTiling,
    r_tile: float,             # tile circumradius [Angstrom]
    pos: torch.Tensor,         # (N, 3) f64 (charged-site position source)
    charge: torch.Tensor,      # (N,) int32
    cutoff_radius: float,
    sigma: float,
    k: float,
    qmax: int,
    cand_cap: int,
    tile_block: Optional[int] = None,
    plane_budget: int = 512 * 1024 * 1024,
    plane_f32: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin of ``csrc/pair_tiled.cu`` on any device (on a
    card it materialises the (B, S, C) plane, blocked to ``plane_budget``
    bytes or ``tile_block`` tiles): the candidate lists of
    ``tile_candidates``, the pair term per (site, candidate), and each site's
    terms added one after the other down the candidate axis in the plane's
    type (a running sum, as the kernel adds them), then converted to the
    position type. Same results, bit for bit, as the kernel."""
    n = pos.shape[0]
    dt = pos.dtype
    T, S = tiling.tile_sites.shape
    # a tile can never hold more than qmax candidates (the list has qmax
    # slots); at cand_cap == qmax overflow is impossible
    cand_cap = min(cand_cap, qmax)

    q_idx, qv, q_pos, q_val, q_overflow = _charged_list(pos, charge, qmax)
    sel, candq, cand_overflow = tile_candidates(
        tiling, r_tile, q_pos, qv, cutoff_radius, cand_cap, plane_budget
    )
    pdt = torch.float32 if plane_f32 else dt
    q_posc = q_pos.to(pdt)[candq]                                   # (T, C, 3)
    q_valc = torch.where(sel, q_val[candq], 0.0).to(pdt)
    q_sitec = torch.where(sel, q_idx[candq], -1)                    # absolute site ids

    if tile_block is None:
        tile_block = (
            T if T * S * cand_cap * 8 <= plane_budget
            else max(1, plane_budget // (S * cand_cap * 8))
        )
    dev = pos.device
    cut2_p = torch.full((), cutoff_radius * cutoff_radius, dtype=dt, device=dev).to(pdt)
    inv_sig_p = torch.full((), 1.0 / (sigma * math.sqrt(2.0)), dtype=pdt, device=dev)
    kq_p = torch.full((), k * Q_E, dtype=pdt, device=dev)
    ang = torch.full((), 1e-10, dtype=pdt, device=dev)
    one = torch.ones((), dtype=pdt, device=dev)
    zero = torch.zeros((), dtype=pdt, device=dev)
    pos_tiles = tiling.pos_tiles.to(pdt)

    vals = torch.empty((T, S), dtype=dt, device=dev)
    for s in range(0, T, tile_block):
        b = slice(s, s + tile_block)
        ts, qs = tiling.tile_sites[b], q_sitec[b]
        d2 = _d2(*(pos_tiles[b][:, :, None, a] - q_posc[b][:, None, :, a] for a in range(3)))
        valid = (
            (d2 < cut2_p)
            & (ts[:, :, None] != qs[:, None, :])
            & (qs[:, None, :] >= 0)
        )                                                           # (B, S, C)
        d = ang * torch.sqrt(torch.where(valid, d2, one))
        v = q_valc[b][:, None, :] * torch.special.erfc(d * inv_sig_p) * kq_p / d
        v = torch.where(valid, v, zero)
        acc = torch.zeros(v.shape[:2], dtype=pdt, device=dev)
        for c in range(v.shape[2]):
            acc = acc + v[:, :, c]
        vals[b] = acc.to(dt)

    # every site lies in exactly one tile slot and pad slots add exact zeros
    # at index 0, so the scatter-add has one order only
    pot = torch.zeros(n, dtype=dt, device=dev).index_add_(
        0, tiling.tile_sites.clamp(min=0).reshape(-1),
        torch.where(tiling.tile_sites >= 0, vals, 0.0).reshape(-1),
    )
    return pot, q_overflow, cand_overflow


# the spatial hash of ``_buckets``
_HASH = (73856093, 19349663, 83492791)


def _buckets(tiling: PairTiling, reach: torch.Tensor, q_pos: torch.Tensor, qv: torch.Tensor):
    """The charged list's valid entries by coarse cell, hashed into H buckets
    (a power of two, at least twice the list), and the cells each tile's
    reach meets: (list positions ordered by bucket (Q,), each bucket's first
    place in that order (H + 1,), H, (T, 27) the bucket of each cell a tile
    tests, -1 past its cells). Invalid entries go past the last bucket.

    A tile tests the entries within ``rl`` of its center on each axis: the
    filter's squared ``reach`` as a distance, with room for the f32 rounding
    of the coordinates and of the test, so every entry the test passes lies
    inside. The cells' edge is the largest ``rl``, so a tile meets at most
    three a side. Cells that share a bucket only cost a few extra tests."""
    Q, dev = q_pos.shape[0], q_pos.device
    H = 1 << max(6, (2 * Q - 1).bit_length())
    center = tiling.tile_center
    rl = (reach.to(torch.float64).sqrt() * (1.0 + 1e-4)
          + 1e-6 * center.abs().sum(dim=1, keepdim=True) + 1e-2)           # (T, 1)
    inv_edge = 1.0 / rl.max()

    def key(ix, iy, iz):
        return ((ix * _HASH[0]) ^ (iy * _HASH[1]) ^ (iz * _HASH[2])) & (H - 1)

    cell = torch.floor(q_pos * inv_edge).to(torch.int64)
    bucket = torch.where(qv, key(cell[:, 0], cell[:, 1], cell[:, 2]), H)
    order = torch.argsort(bucket, stable=True)
    start = torch.searchsorted(bucket[order], torch.arange(H + 1, device=dev))
    lo = torch.floor((center - rl) * inv_edge).to(torch.int64)
    hi = torch.floor((center + rl) * inv_edge).to(torch.int64)
    c = lo[:, :, None] + torch.arange(3, device=dev)                       # (T, axis, 3)
    met = c <= hi[:, :, None]
    T = c.shape[0]
    cells = torch.where(
        met[:, 0, :, None, None] & met[:, 1, None, :, None] & met[:, 2, None, None, :],
        key(c[:, 0, :, None, None], c[:, 1, None, :, None], c[:, 2, None, None, :]), -1)
    return order, start, H, cells.reshape(T, 27)


_KERNEL = "pair_tiled"


class _PairArgs(ctypes.Structure):
    """``struct PairArgs`` of ``csrc/pair_tiled.cu``."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "tile_sites", "pos_tiles", "tile_center", "q_pos", "q_val", "q_idx", "reach",
            "order", "start", "cells", "pot", "cand_overflow")),
        *((name, ctypes.c_longlong) for name in ("T", "S", "Q", "cand_cap")),
        *((name, ctypes.c_double) for name in ("cut2", "inv_sig", "kq", "ang")),
        ("plane_f32", ctypes.c_int),
    ]


def _launcher():
    """The library's C entry point, built and typed on first use."""
    fn = cuda_build.load(_KERNEL).pair_tiled_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_PairArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pairwise_potential_tiled(
    tiling: PairTiling,
    r_tile: float,             # tile circumradius [Angstrom]
    pos: torch.Tensor,         # (N, 3) f64 (charged-site position source)
    charge: torch.Tensor,      # (N,) int32
    cutoff_radius: float,
    sigma: float,
    k: float,
    qmax: int,
    cand_cap: int,             # per-tile candidate cap (grown by the caller
    #                            on overflow like qmax)
    plane_f32: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ((N,) potential, q_overflow, cand_overflow): on CUDA tensors
    the kernel ``csrc/pair_tiled.cu`` (one launch after the charged list,
    nothing of size T·Q or T·S·C in device memory), on CPU tensors the twin
    ``pairwise_potential_tiled_plain``; the two agree bit for bit. The
    tiling may hold some of the tiles only (a rank's share): the potential
    is then those tiles' sites', exact zeros elsewhere.

    Same pair set as ``pairwise_potential`` (the extra tile filter only
    removes pairs beyond the cutoff); per-site summation order follows the
    per-tile candidate list instead of the global charged list, so values
    agree to summation-order reassociation.

    ``plane_f32``: evaluate the distance/erfc plane in f32; the f64 path
    stays the default and the oracle. Error model: coordinates are exact in
    f32 to ~1e-5 relative, the difference-first d2 has no cancellation, and
    the per-site running sum over <= C terms lands ~1e-6 relative on the
    potential. The in-cutoff membership test also rounds in f32, so a pair
    within ~1e-5 relative of the cutoff shell may classify differently from
    the f64 path: a real pair-set difference, not just rounding."""
    if pos.device.type == "cpu":
        return pairwise_potential_tiled_plain(
            tiling, r_tile, pos, charge, cutoff_radius, sigma, k, qmax, cand_cap,
            plane_f32=plane_f32)
    launch, out = kernel_call(tiling, r_tile, pos, charge, cutoff_radius, sigma, k, qmax,
                              cand_cap, plane_f32)
    launch()
    return out


def kernel_call(tiling, r_tile, pos, charge, cutoff_radius, sigma, k, qmax, cand_cap,
                plane_f32):
    """``pairwise_potential_tiled``'s work on a card up to the kernel: its
    inputs made on the device, and (the kernel's launch, (potential,
    q_overflow, cand_overflow)). The kernel writes the given tiles' sites
    and may set the flag, nothing else, so launching it again gives the
    same outputs: chip_smoke.py times the launch alone."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"pairwise_potential_tiled: unsupported device {dev}")
    from akmc_tpu_torch.ops.dia_matvec import current_raw_stream, require_tensor

    n = pos.shape[0]
    T, S = tiling.tile_sites.shape
    if n >= 1 << 31:
        raise ValueError(f"pairwise_potential_tiled: {n} sites do not fit the kernel's int ids")
    f64 = torch.float64
    require_tensor("pos", pos, f64, (n, 3), dev)
    require_tensor("tile_sites", tiling.tile_sites, torch.int64, (T, S), dev)
    require_tensor("pos_tiles", tiling.pos_tiles, f64, (T, S, 3), dev)
    require_tensor("tile_center", tiling.tile_center, f64, (T, 3), dev)

    q_idx, qv, q_pos, q_val, q_overflow = _charged_list(pos, charge, qmax)
    reach = _reach(tiling, r_tile, cutoff_radius)
    order, start, _, cells = _buckets(tiling, reach, q_pos, qv)
    pot = torch.zeros(n, dtype=f64, device=dev)
    cand_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    args = _PairArgs(
        tiling.tile_sites.data_ptr(), tiling.pos_tiles.data_ptr(), tiling.tile_center.data_ptr(),
        q_pos.data_ptr(), q_val.data_ptr(), q_idx.data_ptr(), reach.data_ptr(),
        order.data_ptr(), start.data_ptr(), cells.data_ptr(), pot.data_ptr(),
        cand_overflow.data_ptr(), T, S, qmax, min(cand_cap, qmax),
        cutoff_radius * cutoff_radius, 1.0 / (sigma * math.sqrt(2.0)), k * Q_E, 1e-10,
        int(plane_f32),
    )

    def launch():
        device_loop.bind(*tiling, q_pos, q_val, q_idx, reach, order, start, cells, pot,
                         cand_overflow)
        call = (ctypes.byref(args), current_raw_stream(dev.index))
        if torch.cuda.current_device() == dev.index:
            err = _launcher()(*call)
        else:
            with torch.cuda.device(dev):
                err = _launcher()(*call)
        if err != 0:
            raise RuntimeError(f"pair_tiled kernel launch failed: CUDA error {err}")
        device_loop.count_launch(pairwise_potential_tiled)

    return launch, (pot, q_overflow, cand_overflow)


pairwise_potential_tiled.launches = 0   # kernel launches (in a graph: launches as replayed)
