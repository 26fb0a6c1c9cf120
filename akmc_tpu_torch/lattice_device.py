"""Neighbor and cutoff lists built on the card: the counterpart of
``akmc_tpu/lattice_jax.py``.

A blocked O(N^2) scan in f64 on the tensors' device. For each block of rows:
squared distances to every site formed as
``akmc_tpu/lattice_jax.py::_block_dist2`` forms them (PBC in y/z only;
``lattice.py::_dist2`` forms the same), candidates ``sqrt(d2) < cutoff``
with the column mask and ``j != i``, and per row the first k candidate
columns in ascending index order, -1 padded, with the row's candidate count.
The reference's GPU scan keeps the same ascending-j order
(neighbor_lists_gpu.cu:55-136).

``sqrt(d2) < cutoff`` is the rule of the k-d tree builders in
``lattice.py`` (``site_dist``: the same d2, the same correctly rounded
square root), so the lists are those of the host builders entry for entry
whichever device built them, and the list cache holds one set.
``lattice_jax`` keeps a pair by ``d2 < cutoff^2`` instead; the two rules
part only on a pair within a rounding of the cutoff.

``lattice.build_lattice`` builds a structure file's lists with these on a
CUDA device; on the CPU its k-d tree builders stay the builders, and they
are the twins these are held against.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from akmc_tpu_torch.device import resolve_device
from akmc_tpu_torch.lattice import _POSSIBLY_CHARGED

# the (B, N) temporaries of one row block: two f64 planes (the squared
# distance beside a coordinate difference or its root), the candidate mask
# and the comparison's own, rounded up
BYTES_PER_PAIR = 24
# their share of the device's free memory (ranks that share one card each
# size their blocks from the same free memory), and the largest block
MEMORY_SHARE = 0.125
MAX_BLOCK = 4096


def row_block(n: int, device: torch.device) -> int:
    """Rows per block for a scan over ``n`` sites on ``device``: its (B, n)
    temporaries within MEMORY_SHARE of the device's free memory (the card's,
    or the host's available pages), at most MAX_BLOCK rows."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(max(1, min(n, MAX_BLOCK, MEMORY_SHARE * free // (BYTES_PER_PAIR * max(n, 1)))))


def _block_dist2(rows: torch.Tensor, cols: Tuple[torch.Tensor, ...], lattice, pbc: bool):
    """Squared distances (B, N) from the positions ``rows`` (B, 3) to the
    columns ``cols`` = (x, y, z): dx*dx + dy*dy + dz*dz left to right, the y
    and z differences wrapped by ``(d / L - round(d / L)) * L`` when ``pbc``.
    ``lattice`` holds 0-d tensors on the device: a CUDA division by a host
    scalar is a multiplication by its reciprocal, which rounds otherwise."""
    d2 = None
    for a in range(3):
        d = rows[:, a, None] - cols[a][None, :]
        if pbc and a > 0:
            d /= lattice[a]
            d -= torch.round(d)
            d *= lattice[a]
        d *= d
        if d2 is None:
            d2 = d
        else:
            d2 += d
    return d2


def _scan(pos: torch.Tensor, cand: Optional[torch.Tensor], cutoff: float,
          k: Optional[int], lattice, pbc: bool, block: int):
    """For each row i, the first ``k`` columns j (ascending) with
    ``sqrt(d2) < cutoff``, ``j != i`` and ``cand[j]``, -1 padded; ``k`` None:
    as many as the fullest row holds. Returns (table (N, K) int32 numpy,
    counts (N,) int64 numpy).

    A block scans only the columns whose x lies within the cutoff (and a
    relative 1e-6) of its rows' x range, in ascending order: x never wraps,
    and ``d2 >= dx*dx`` in floating point too, so no candidate is lost. On a
    structure sorted by x (every structure file of the reference) that is a
    narrow window."""
    dev = pos.device
    n = pos.shape[0]
    x = pos[:, 0].contiguous()
    lat = [torch.tensor(float(v), dtype=torch.float64, device=dev) for v in lattice]
    reach = cutoff * (1.0 + 1e-6)
    tables, counts = [], []
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        xr = x[r0:r1]
        lo, hi = (torch.stack([xr.min(), xr.max()]) + torch.tensor(
            [-reach, reach], dtype=torch.float64, device=dev)).unbind()
        col = torch.nonzero((x >= lo) & (x <= hi)).squeeze(1)     # ascending
        pc = pos[col]
        ok = torch.sqrt(_block_dist2(pos[r0:r1], tuple(pc[:, a] for a in range(3)), lat,
                                     pbc)) < cutoff
        if cand is not None:
            ok &= cand[col][None, :]
        ok &= torch.arange(r0, r1, device=dev)[:, None] != col[None, :]     # j != i
        cnt = ok.sum(dim=1)
        r, cw = torch.nonzero(ok, as_tuple=True)          # row-major: ascending j per row
        c = col[cw]
        width = k if k is not None else int(cnt.max())
        slot = torch.arange(r.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[r]
        keep = slot < width
        t = torch.full((r1 - r0, width), -1, dtype=torch.int32, device=dev)
        t[r[keep], slot[keep]] = c[keep].to(torch.int32)
        tables.append(t.cpu().numpy())
        counts.append(cnt.cpu().numpy())
    width = k if k is not None else max((t.shape[1] for t in tables), default=0)
    out = np.full((n, width), -1, np.int32)
    r0 = 0
    for t in tables:
        out[r0:r0 + t.shape[0], : t.shape[1]] = t
        r0 += t.shape[0]
    return out, (np.concatenate(counts) if counts else np.zeros(0, np.int64))


def build_neighbor_list_device(
    pos: np.ndarray,
    nn_dist: float,
    max_nn: int,
    lattice: Optional[Sequence[float]] = None,
    pbc: bool = False,
    strict: bool = True,
    device=None,
    block: Optional[int] = None,
) -> np.ndarray:
    """Padded neighbor table (N, max_nn) int32: for each site, ascending
    j != i with distance < nn_dist, -1 padded; PBC in y/z when ``pbc``.
    ``strict`` raises when a site has more than ``max_nn`` (the reference
    truncates silently). ``block``: rows per block (default ``row_block``)."""
    dev = resolve_device(device)
    pos_t = torch.as_tensor(np.asarray(pos, np.float64), device=dev)
    block = block or row_block(pos_t.shape[0], dev)
    idx, counts = _scan(pos_t, None, nn_dist, max_nn,
                        lattice if lattice is not None else (1.0, 1.0, 1.0), pbc, block)
    if strict and counts.max(initial=0) > max_nn:
        i = int(np.argmax(counts))
        raise ValueError(
            f"site {i} has {counts[i]} neighbors > max_num_neighbors={max_nn}; raise the cap "
            f"(reference would silently truncate, Device.cpp:59)")
    return idx


def build_cutoff_list_device(
    pos: np.ndarray,
    element: np.ndarray,
    cutoff_radius: float,
    device=None,
    block: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Padded cutoff-candidate table of the pairwise Coulomb sum: for each
    site, ascending j != i with non-PBC distance < cutoff_radius and
    element[j] possibly charged. Returns (table (N, N_cutoff) int32 -1
    padded, N_cutoff), N_cutoff the largest row count (at least 1, as
    ``akmc_tpu``'s two-pass scan sizes it). One pass: each block keeps its
    own rows' width, and the blocks are padded to the widest at the end."""
    dev = resolve_device(device)
    pos_t = torch.as_tensor(np.asarray(pos, np.float64), device=dev)
    element = np.asarray(element)
    cand = torch.as_tensor(np.isin(element, np.array(_POSSIBLY_CHARGED, element.dtype)),
                           device=dev)
    block = block or row_block(pos_t.shape[0], dev)
    idx, counts = _scan(pos_t, cand, cutoff_radius, None, (1.0, 1.0, 1.0), False, block)
    maxc = max(int(counts.max(initial=0)), 1)
    if idx.shape[1] < maxc:
        idx = np.concatenate([idx, np.full((idx.shape[0], maxc - idx.shape[1]), -1, np.int32)], 1)
    return idx, maxc
