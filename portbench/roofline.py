"""Peaks and the frozen count of a K-solve iteration.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the full
700 W power limit): f64 outside the tensor cores 34 TFLOP/s, HBM3
3.35 TB/s. A share is stated with the card's power limit beside it.

One Jacobi-CG iteration on the K system of n interface rows with nnz
structural nonzeros (the diagonal and every interface-interface neighbor
pair) must at least read the operator, one int8 code a nonzero, read the
f64 vectors x, r, p and the inverse diagonal and write x, r and p back:
nnz + 7 * 8 * n bytes. It computes the product (2 flops a nonzero) and the
vector updates and dots (12 flops a row). The count is taken from the
operator's structure, not from any kernel's packed layout, so it reads the
same work whatever implements it.
"""

from __future__ import annotations

import torch

PEAK_F64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12


def k_solve_nnz(nbr: torch.Tensor, L: int):
    """(interface rows, structural nonzeros) of the K system on the
    neighbor lists ``nbr`` with contacts of ``L`` sites each side."""
    n = nbr.shape[0]
    rows = nbr[L:n - L]
    inner = (rows >= L) & (rows < n - L)
    return n - 2 * L, int(inner.sum()) + (n - 2 * L)


def k_iteration_least_s(n_rows: int, nnz: int) -> float:
    flops = 2.0 * nnz + 12.0 * n_rows
    bytes_ = nnz + 7 * 8.0 * n_rows
    return max(flops / PEAK_F64_FLOPS, bytes_ / PEAK_HBM_BYTES)


def k_solve_least_s(nbr: torch.Tensor, L: int, iterations: int) -> float:
    n_rows, nnz = k_solve_nnz(nbr, L)
    return iterations * k_iteration_least_s(n_rows, nnz)
