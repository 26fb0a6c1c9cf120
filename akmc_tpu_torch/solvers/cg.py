"""Conjugate-gradient solvers on tensors.

Semantics of ``akmc_tpu/solvers/cg.py``:
  * ``jacobi_cg`` mirrors ``conjugate_gradient_jacobi``
    (dist_conjugate_gradient.cpp:149-276): preconditioned dot r.z against
    ||b||^2, squared-tolerance test ``r.z / b.b > rtol^2``, warm start,
    iteration counter starting at 1.
  * ``symscaled_cg`` mirrors ``solve_sparse_CG_Jacobi``
    (iterative_solvers_gpu.cu:716-887): symmetric Jacobi scaling
    D^-1/2 A D^-1/2 + plain CG with ||r||^2 <= tol^2 in the scaled space.

``akmc_tpu`` runs both as a ``lax.while_loop`` on the device. Here
``jacobi_cg`` and ``symscaled_cg`` keep the loop's state in tensors that a
program owns (``ops/device_loop.py``) and run ``k`` guarded iterations per
CUDA-graph replay (CG_K on a card, 1 on the CPU, where the same step runs
eagerly), with one host read of a packed flag vector per replay. Every write
of a step is ``torch.where(live, new, old)``, so iterations past the stop
change nothing and the result (x, r, residual, iteration count) is the host
loop's to the bit. The host loops are ``jacobi_cg_plain`` and
``symscaled_cg_plain``, one read of the stop rule per iteration.

Inside a program's body (``ops/device_loop.py::in_program``: a superstep
captured whole, ``models/step_program.py``) the same k-iteration step is the
body of a ``while_loop``, a conditional while node of the program's graph on a
card, and nothing is read: the iteration count of the result is a 0-d device
tensor, and the passes and live iterations are recorded for the program's
one read (``CGResult.iterations`` is then a tensor).

A graph binds addresses. The operator is therefore an ``Operator``: a
function of the vector and of the tensors that change between solves
(``operands``, copied into the program's own buffers before each solve),
with a key (``static``) of everything else its graph depends on: Python
constants and the addresses of the static tables it reads. The caller's
``LoopGraphs`` keeps one program per key, so a sweep captures each once.
"""

from __future__ import annotations

from typing import Callable, Hashable, NamedTuple, Optional

import torch

from akmc_tpu_torch.ops import device_loop
from akmc_tpu_torch.ops.device_loop import GraphLoop, program

Dot = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# iterations per replay of a CG device loop on a card, and of a solve's first
# replay: the sweeps' solves either converge at entry (a warm start: one dead
# iteration) or run a hundred and more. See PERF.md §6 for the readings
CG_K = 16
CG_FIRST = 1
# iterations per pass of a CG while node inside a program on a card: a dead
# iteration costs a whole one, a pass a few µs (PERF.md §6)
CG_NODE_K = 4


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
    #                              (a 0-d device tensor inside a program)
    residual_sq: torch.Tensor    # final r.z
    r: torch.Tensor              # final (recurrence) residual vector


class Operator(NamedTuple):
    """y = fn(v, *operands). ``operands``: the tensors that change between
    solves; ``static``: with ``name``, everything else ``fn`` reads that
    shapes its graph (Python constants, the addresses of static tables).
    Two operators with equal names, statics and operand shapes must compute
    the same function of their operands."""

    name: str
    fn: Callable[..., torch.Tensor]
    operands: tuple = ()
    static: tuple = ()

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.fn(v, *self.operands)


def addresses(*tables) -> tuple:
    """(address, shape) of each static table, for an ``Operator``'s key."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in tables)


# solves, replays (one host read each), iterations run (live and dead) and
# live iterations of the CG device loops since the last reset, by operator
# name (each program also keeps its own, ``_CGProgram.counts``)
COUNT_KEYS = ("solves", "replays", "steps", "live_steps")
CG_COUNTS: dict = {}


def reset_cg_counts() -> None:
    CG_COUNTS.clear()


def jacobi_cg_plain(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    inv_diag: torch.Tensor,
    relative_tolerance: float,
    max_iterations: int,
    r0: Optional[torch.Tensor] = None,
    dot_fn: Dot = torch.dot,
) -> CGResult:
    """The host loop: stops when r.z / b.b <= rtol^2 or k > max_iterations,
    reading the test once per iteration.

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


def symscaled_cg_plain(
    A: Callable[[torch.Tensor], torch.Tensor],
    diag: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float = 1e-14,
    max_iterations: int = 100000,
    dot_fn: Dot = torch.dot,
) -> CGResult:
    """The host loop of the CG on the symmetrically-scaled system
    (D^-1/2 A D^-1/2) y = D^-1/2 b, y = D^1/2 x. Reference:
    solve_sparse_CG_Jacobi (iterative_solvers_gpu.cu:716-887); loop test
    ||r||^2 > tol^2, iteration counter starting at 0."""
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


class _CGProgram:
    """State and k-iteration body of one CG device loop over its own copies
    of the operator's operands. Everything it writes is owned here and
    starts dead (``max_it`` -1): it is captured so, on the first solve's
    operands."""

    def __init__(self, A: Operator, n: int, dtype, device, dot_fn: Dot, k: int, names):
        f = dict(dtype=dtype, device=device)
        self.name, self.fn, self.dot = A.name, A.fn, dot_fn
        self.ops = tuple(t.clone() for t in A.operands)     # valid while the graph is captured
        for name in names:
            setattr(self, name, torch.zeros(n, **f))
        self.s = torch.zeros((), **f)                       # rz or t
        self.norm2 = torch.zeros((), **f)                   # b.b (jacobi)
        self.tol2 = torch.zeros((), **f)
        self.it = torch.zeros((), dtype=torch.int64, device=device)
        self.max_it = torch.full((), -1, dtype=torch.int64, device=device)
        self.flags = torch.zeros(2, dtype=torch.float64, device=device)
        self.live = torch.zeros((), dtype=torch.bool, device=device)
        self.k = k
        self.counts = dict.fromkeys(COUNT_KEYS, 0)
        self._loop = None
        if not device_loop.in_program():
            self._make_loop()

    def _make_loop(self) -> None:
        """Capture the replays of the host-driven loop. A capture runs the
        body, so it runs with the loop dead (``max_it`` -1), and a state
        loaded before is left as it was."""
        kept = self.max_it.clone()
        self.max_it.fill_(-1)
        try:
            self._loop = GraphLoop(self._body, self.k, self.it.device, self.flags, 1,
                                   first=CG_FIRST)
        finally:
            self.max_it.copy_(kept)

    @property
    def loop(self) -> GraphLoop:
        """The replays of the host-driven loop: captured when the program is
        made, or, for one made inside a superstep's program, on first use."""
        if self._loop is None:
            self._make_loop()
        return self._loop

    @property
    def capture_s(self) -> float:
        return 0.0 if self._loop is None else self._loop.capture_s

    def A(self, v):
        return self.fn(v, *self.ops)

    def _body(self, n):
        for _ in range(n):
            self._step()
        self.flags.copy_(torch.stack([self._live().to(torch.float64),
                                      self.it.to(torch.float64)]))

    def load(self, A: Operator, max_iterations: int, tol2: float) -> None:
        for dst, src in zip(self.ops, A.operands):
            dst.copy_(src)
        self.tol2.fill_(tol2)
        self.max_it.fill_(max_iterations)

    def run(self, it0: int) -> int:
        """Replays until the loop is dead: the iteration count. On the CPU,
        where a read costs nothing and a dead step a whole step, a loop dead
        at entry (a converged warm start) runs no step, as the plain loop."""
        if self.it.device.type != "cuda" and not bool(self._live()):
            self._count(0, 0, 0)
            return it0
        (_, it), replays, steps = self.loop.run()
        it = int(it)
        self._count(replays, steps, it - it0)
        return it

    def run_nested(self, it0: int) -> torch.Tensor:
        """The loop as a ``while_loop`` of k-iteration passes inside a
        program: the iteration count as a 0-d device tensor; the passes and
        live iterations are recorded for the program's read."""
        passes = torch.zeros((), dtype=torch.int64, device=self.it.device)

        def body():
            for _ in range(self.k):
                self._step()
            passes.add_(1)
            self.live.copy_(self._live())

        self.live.copy_(self._live())
        device_loop.while_loop(self.live, body)
        it = self.it.clone()
        device_loop.record((passes, it - it0), lambda v: self._count(
            int(v[0]), int(v[0]) * self.k, int(v[1])))
        return it

    def _count(self, replays: int, steps: int, live: int) -> None:
        for counts in (self.counts, CG_COUNTS.setdefault(self.name,
                                                         dict.fromkeys(COUNT_KEYS, 0))):
            for key, n in zip(COUNT_KEYS, (1, replays, steps, live)):
                counts[key] += n


class _JacobiProgram(_CGProgram):
    def __init__(self, A, n, dtype, device, dot_fn, k):
        super().__init__(A, n, dtype, device, dot_fn, k, ("x", "r", "z", "p", "inv_diag"))

    def _live(self):
        return (self.it <= self.max_it) & (self.s / self.norm2 > self.tol2)

    def _step(self):
        live = self._live()
        rz, p, dot = self.s, self.p, self.dot
        Ap = self.A(p)
        a = rz / dot(p, Ap)
        x = self.x + a * p
        r = self.r - a * Ap
        z = r * self.inv_diag
        rz_new = dot(r, z)
        beta = rz_new / rz
        p_new = z + beta * p
        for dst, new in ((self.x, x), (self.r, r), (self.z, z), (self.p, p_new),
                         (self.s, rz_new)):
            dst.copy_(torch.where(live, new, dst))
        self.it.add_(live.to(torch.int64))


class _SymscaledProgram(_CGProgram):
    def __init__(self, A, n, dtype, device, dot_fn, k):
        super().__init__(A, n, dtype, device, dot_fn, k, ("y", "r", "p", "inv_sqrt_d"))

    def _live(self):
        return (self.it < self.max_it) & (self.s > self.tol2)

    def _step(self):
        live = self._live()
        t, p, w, dot = self.s, self.p, self.inv_sqrt_d, self.dot
        Ap = w * self.A(w * p)
        alpha = t / dot(p, Ap)
        y = self.y + alpha * p
        r = self.r + alpha * Ap
        t_new = dot(r, r)
        p_new = (t_new / t) * p - r
        for dst, new in ((self.y, y), (self.r, r), (self.p, p_new), (self.s, t_new)):
            dst.copy_(torch.where(live, new, dst))
        self.it.add_(live.to(torch.int64))


def _steps(k: Optional[int], device: torch.device) -> int:
    if k is not None:
        return k
    if device.type != "cuda":
        return 1
    return CG_NODE_K if device_loop.in_program() else CG_K


def _run(prog, it0: int):
    """The loop of a loaded program: inside a program's body a while loop
    (the count a device tensor), else the replays (an int)."""
    return prog.run_nested(it0) if device_loop.in_program() else prog.run(it0)


def _program(kind, cls, graphs, A, b: torch.Tensor, dot_fn: Dot, k: int):
    if not isinstance(A, Operator):
        if graphs is not None:
            raise TypeError("a CG program kept in LoopGraphs needs an Operator, whose key "
                            "says what its graph reads")
        A = Operator("callable", A)       # a program of its own for this solve
    key: Hashable = (kind, A.name, A.static, tuple(b.shape), b.dtype, b.device, dot_fn, k,
                     CG_FIRST, tuple((tuple(t.shape), t.dtype) for t in A.operands))
    return A, program(graphs, key, lambda: cls(A, b.shape[0], b.dtype, b.device, dot_fn, k))


def jacobi_cg(
    A,
    b: torch.Tensor,
    x0: torch.Tensor,
    inv_diag: torch.Tensor,
    relative_tolerance: float,
    max_iterations: int,
    r0: Optional[torch.Tensor] = None,
    dot_fn: Dot = torch.dot,
    graphs=None,
    k: Optional[int] = None,
) -> CGResult:
    """``jacobi_cg_plain`` kept on the device: k iterations (default CG_K
    on a card, 1 on the CPU; the first replay at most CG_FIRST) per replay
    of the program of ``A``'s key, one host read per replay. ``A``: an
    ``Operator``, or without ``graphs`` any function of the vector. The
    entry (b.b, r0, z0, r0.z0) runs eagerly as the plain loop runs it; x and
    r are copied out of the program, so the next solve leaves them alone.
    ``graphs``: the caller's ``LoopGraphs`` (without one, each call builds
    and captures its own program)."""
    k = _steps(k, b.device)
    A, prog = _program("jacobi", _JacobiProgram, graphs, A, b, dot_fn, k)
    prog.load(A, max_iterations, relative_tolerance**2)
    prog.norm2.copy_(dot_fn(b, b))
    prog.x.copy_(x0)
    prog.r.copy_((b - A(x0)) if r0 is None else r0)
    prog.inv_diag.copy_(inv_diag)
    torch.mul(prog.r, prog.inv_diag, out=prog.z)
    prog.p.copy_(prog.z)
    prog.s.copy_(dot_fn(prog.r, prog.z))
    prog.it.fill_(1)
    it = _run(prog, 1)
    return CGResult(x=prog.x.clone(), iterations=it, residual_sq=prog.s.clone(),
                    r=prog.r.clone())


def symscaled_cg(
    A,
    diag: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float = 1e-14,
    max_iterations: int = 100000,
    dot_fn: Dot = torch.dot,
    graphs=None,
    k: Optional[int] = None,
) -> CGResult:
    """``symscaled_cg_plain`` kept on the device, as ``jacobi_cg`` keeps
    ``jacobi_cg_plain``; the scaling and the entry residual run eagerly."""
    k = _steps(k, b.device)
    A, prog = _program("symscaled", _SymscaledProgram, graphs, A, b, dot_fn, k)
    prog.load(A, max_iterations, tol * tol)
    w = prog.inv_sqrt_d
    w.copy_(1.0 / torch.sqrt(diag))
    prog.y.copy_(x0 / w)
    prog.r.copy_(w * A(w * prog.y) - b * w)
    torch.neg(prog.r, out=prog.p)
    prog.s.copy_(dot_fn(prog.r, prog.r))
    prog.it.zero_()
    it = _run(prog, 0)
    return CGResult(x=prog.y * w, iterations=it, residual_sq=prog.s.clone(), r=prog.r.clone())
