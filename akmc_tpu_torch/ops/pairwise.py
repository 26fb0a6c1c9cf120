"""Pairwise screened-Coulomb potential of the charged defects, from a
static interaction table.

Reference: poisson_gridless_gpu / calculate_pairwise_interaction_indexed
(potential_solver_gpu.cu:1525-1655):

    potential[i] = sum_{j within cutoff, j != i, charge_j != 0}
                   charge_j * erfc(d_ij / (sigma*sqrt(2))) * k * e / d_ij

with d_ij = 1e-10 * the non-PBC Euclidean distance. Charged sites are always
drawn from the static possibly-charged (active) class and positions never
change, so the kernel g(d_iq) is tabulated once for every (active site q,
site i) pair; each superstep then gathers the rows of the charged sites and
takes one multiply-reduce (``akmc_tpu/ops/pairwise.py``, full f64 storage).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from akmc_tpu_torch.ops.compact import compact_mask

Q_E = 1.60217663e-19


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
    charged sites, in which case the caller doubles qmax and repeats)."""
    np_rows = table.shape[0]
    charged = charge != 0
    q_idx, qv = compact_mask(charged, qmax)
    qi = q_idx.clamp(min=0)
    q_val = torch.where(qv, charge[qi], 0).to(table.dtype)
    cols = site2col[qi].clamp(0, np_rows - 1)
    rows = table[cols]                                   # (Q, N) contiguous rows
    pot = torch.sum(rows.T * q_val[None, :], dim=1)      # (N, Q) -> (N,)
    return pot, charged.sum() > qmax
