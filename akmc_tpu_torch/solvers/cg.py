"""Jacobi-preconditioned conjugate gradient on tensors.

Mirrors ``conjugate_gradient_jacobi`` (dist_conjugate_gradient.cpp:149-276)
as ``akmc_tpu/solvers/cg.py::jacobi_cg`` does: preconditioned dot r.z
against ||b||^2, squared-tolerance test ``r.z / b.b > rtol^2``, warm start,
iteration counter starting at 1. The loop runs on the host: each test of the
stop rule reads one scalar from the device (one synchronisation per
iteration).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Operator = Callable[[torch.Tensor], torch.Tensor]


def f64_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vector dot as multiply + sum (the reduction the DIA path uses)."""
    return torch.sum(a * b)


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int              # final k; the solve applied A exactly k times
    residual_sq: torch.Tensor    # final r.z
    r: torch.Tensor              # final (recurrence) residual vector


def jacobi_cg(
    A: Operator,
    b: torch.Tensor,
    x0: torch.Tensor,
    inv_diag: torch.Tensor,
    relative_tolerance: float,
    max_iterations: int,
    dot_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = f64_vdot,
) -> CGResult:
    """Stops when r.z / b.b <= rtol^2 or k > max_iterations."""
    tol2 = relative_tolerance**2
    norm2_rhs = dot_fn(b, b)
    x = x0
    r = b - A(x0)
    z = r * inv_diag
    p = z
    rz = dot_fn(r, z)
    k = 1
    while k <= max_iterations and bool(rz / norm2_rhs > tol2):
        Ap = A(p)
        a = rz / dot_fn(p, Ap)
        x = x + a * p
        r = r - a * Ap
        z = r * inv_diag
        rz_new = dot_fn(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x=x, iterations=k, residual_sq=rz, r=r)
