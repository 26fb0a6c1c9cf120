"""Conjugate-gradient solvers on tensors, as host loops.

Semantics of ``akmc_tpu/solvers/cg.py``:
  * ``jacobi_cg`` mirrors ``conjugate_gradient_jacobi``
    (dist_conjugate_gradient.cpp:149-276): preconditioned dot r.z against
    ||b||^2, squared-tolerance test ``r.z / b.b > rtol^2``, warm start,
    iteration counter starting at 1.
  * ``symscaled_cg`` mirrors ``solve_sparse_CG_Jacobi``
    (iterative_solvers_gpu.cu:716-887): symmetric Jacobi scaling
    D^-1/2 A D^-1/2 + plain CG with ||r||^2 <= tol^2 in the scaled space.

Both loops run on the host: each test of the stop rule reads one scalar from
the device (one synchronisation per iteration).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

Operator = Callable[[torch.Tensor], torch.Tensor]
Dot = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f64_matvec(M: torch.Tensor, v: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Dense f64 matvec as broadcast-multiply + reduce, the form
    ``akmc_tpu`` uses for every small dense product on its parity paths.
    ``axis=1`` computes M @ v; ``axis=0`` computes M.T @ v without
    materializing M.T."""
    if axis == 1:
        return torch.sum(M * v[None, :], dim=1)
    return torch.sum(M * v[:, None], dim=0)


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
    r0: Optional[torch.Tensor] = None,
    dot_fn: Dot = torch.dot,
) -> CGResult:
    """Stops when r.z / b.b <= rtol^2 or k > max_iterations.

    ``r0``: optional precomputed initial residual b - A(x0) (carried across
    warm-started solves); when given, the entry matvec is skipped, so a
    converged warm start applies the operator no time at all.

    ``dot_fn``: the vector dot; ``torch.dot`` by default, as ``akmc_tpu``
    defaults to ``jnp.dot``."""
    tol2 = relative_tolerance**2
    norm2_rhs = dot_fn(b, b)
    x = x0
    r = (b - A(x0)) if r0 is None else r0
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


def symscaled_cg(
    A: Operator,
    diag: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float = 1e-14,
    max_iterations: int = 100000,
    dot_fn: Dot = torch.dot,
) -> CGResult:
    """CG on the symmetrically-scaled system (D^-1/2 A D^-1/2) y = D^-1/2 b,
    y = D^1/2 x. Reference: solve_sparse_CG_Jacobi
    (iterative_solvers_gpu.cu:716-887); loop test ||r||^2 > tol^2, iteration
    counter starting at 0."""
    inv_sqrt_d = 1.0 / torch.sqrt(diag)

    def As(y):
        return inv_sqrt_d * A(inv_sqrt_d * y)

    bs = b * inv_sqrt_d
    y = x0 / inv_sqrt_d       # 'unprecondition' of the warm start
    r = As(y) - bs
    p = -r
    k = 0
    t = dot_fn(r, r)
    while k < max_iterations and bool(t > tol * tol):
        Ap = As(p)
        alpha = t / dot_fn(p, Ap)
        y = y + alpha * p
        r = r + alpha * Ap
        t_new = dot_fn(r, r)
        p = (t_new / t) * p - r
        t = t_new
        k += 1
    return CGResult(x=y * inv_sqrt_d, iterations=k, residual_sq=t, r=r)
