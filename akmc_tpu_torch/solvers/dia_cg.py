"""The whole Jacobi-CG of one boundary-potential K solve: the fused CUDA
kernel (``csrc/dia_cg.cu``, one cooperative launch per solve), its plain
PyTorch twin, and its form sharded over ranks (``dia_cg_solve_sharded``).

``dia_cg_solve(op, cvac, is_int, diag_i, dgc, inv_diag, rhs, x0, rtol, max_it)``
is ``solvers/cg.py::jacobi_cg`` with the operator of ``solvers/dia.py``,

    A(v) = is_int ? diag_i*v - W v - dgc*(adjacency (cvac ? v : 0)) : v,

where ``W`` and ``adjacency`` are the two halves of the DIA combined matvec
(``ops/dia_matvec.py``). ``akmc_tpu`` keeps this loop on the device
(``lax.while_loop`` around ``akmc_tpu/ops/pallas_dia.py``'s kernel); on the
card the port runs it as one kernel, with no host read per iteration.

Kernel and twin agree bit for bit: the same products and sums in the same
order, and the same order inside the dot products (``blocked_vdot`` below
repeats the kernel's reduction tree). Dispatch is by the device of the
tensors: CUDA tensors launch the kernel or raise, CPU tensors take the twin.
There is no fallback between the two.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from akmc_tpu_torch.ops import cuda_build, device_loop
from akmc_tpu_torch.ops.dia_matvec import (
    DiaOperator,
    current_raw_stream,
    dia_combined_matvec_plain,
    require_tensor,
)
from akmc_tpu_torch.solvers.cg import CGResult, jacobi_cg, jacobi_cg_plain

_KERNEL = "dia_cg"
CHUNK = 256      # rows per first-level reduction: kChunk of csrc/dia_cg.cu
MASK_DIAGS = 32  # diagonals per group of packed mask words: kMaskDiags of csrc/dia_cg.cu
_WARP = 32
_ERRORS = {
    -1: "more offset diagonals than the kernel stages",
    -2: "the device does not support cooperative launches",
    -3: "no block of the kernel can be resident on the device",
    -4: "bad argument",
}


def _halve(t: torch.Tensor) -> torch.Tensor:
    """Halving tree over the last axis (a power of two): t[i] += t[i + n/2]
    until one value is left."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _tree(t: torch.Tensor) -> torch.Tensor:
    """(..., CHUNK) -> (...): the halving tree inside each run of 32 values,
    then over the 8 run sums: a warp's shuffles, then the block's warp sums."""
    return _halve(_halve(t.reshape(*t.shape[:-1], CHUNK // _WARP, _WARP)))


def _chunked(t: torch.Tensor) -> torch.Tensor:
    """(n,) -> (ceil(n / CHUNK), CHUNK), padded with +0.0."""
    rows = -(-t.shape[0] // CHUNK)
    return F.pad(t, (0, rows * CHUNK - t.shape[0])).reshape(rows, CHUNK)


def chunk_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The first level of ``blocked_vdot``: rounded products, and per chunk
    of 256 consecutive entries (the last padded with +0.0) the tree of
    ``_tree``. A rank whose rows are whole chunks computes its chunks' sums
    as the whole vector's dot computes them."""
    return _tree(_chunked(a * b))


def finish_chunks(sums: torch.Tensor) -> torch.Tensor:
    """The second level of ``blocked_vdot`` over all chunk sums in order: laid
    out as rows of 256 (padded with +0.0), the rows added in ascending order,
    then the same tree over the 256 column sums."""
    rows = _chunked(sums)
    acc = rows[0]
    for m in range(1, rows.shape[0]):
        acc = acc + rows[m]
    return _tree(acc)


def blocked_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b in the fixed order of the fused kernel, which depends on the
    length alone: ``chunk_sums``, then ``finish_chunks``."""
    return finish_chunks(chunk_sums(a, b))


def pack_row_masks_plain(op: DiaOperator, cvac: torch.Tensor) -> torch.Tensor:
    """The per-row words the fused kernel packs from the codes and ``cvac``
    once per solve and reads in every iteration after: a (3, groups, N)
    int64 tensor of 32-bit words, groups = ceil(D / 32). Bit b of group g
    stands for diagonal d = 32 g + b of row i, and j = i + o_d:
    ``[0]`` edge: code != 0 and 0 <= j < N; ``[1]`` high: an edge of code 2;
    ``[2]`` cvn: an edge into a conductive vacancy (``cvac[j]``)."""
    n = op.n
    words = torch.zeros((3, -(-op.D // MASK_DIAGS), n), dtype=torch.int64, device=op.device)
    idx = torch.arange(n, device=op.device)
    for d, o in enumerate(op.offsets_list):
        g, b = divmod(d, MASK_DIAGS)
        j = idx + o
        edge = (op.diags[d] != 0) & (j >= 0) & (j < n)
        for plane, bits in enumerate((edge, edge & (op.diags[d] == 2),
                                      edge & cvac[j.clamp(0, n - 1)])):
            words[plane, g] |= bits.to(torch.int64) << b
    return words


def masks_matvec_plain(words: torch.Tensor, offsets, val_low: float, val_high: float,
                       v: torch.Tensor):
    """(W v, adjacency (cvac ? v : 0)) decoded from ``pack_row_masks_plain``'s
    words as the kernel decodes them: per row, the set edge bits in ascending
    d, each term added only where its bit is set."""
    n = v.shape[0]
    idx = torch.arange(n, device=v.device)
    lo, hi = (torch.tensor(w, dtype=v.dtype, device=v.device) for w in (val_low, val_high))
    mv, corr = torch.zeros_like(v), torch.zeros_like(v)
    for d, o in enumerate(offsets):
        g, b = divmod(d, MASK_DIAGS)
        edge, high, cvn = (((words[plane, g] >> b) & 1).bool() for plane in range(3))
        vj = v[(idx + o).clamp(0, n - 1)]
        mv = torch.where(edge, mv + torch.where(high, hi, lo) * vj, mv)
        corr = torch.where(cvn, corr + vj, corr)
    return mv, corr


def dia_cg_solve_plain(
    op: DiaOperator,
    cvac: torch.Tensor,
    is_int: torch.Tensor,
    diag_i: torch.Tensor,
    dgc: torch.Tensor,
    inv_diag: torch.Tensor,
    rhs: torch.Tensor,
    x0: torch.Tensor,
    relative_tolerance: float,
    max_iterations: int,
) -> CGResult:
    """Plain PyTorch twin on any device: the host loop ``jacobi_cg_plain`` over the
    plain matvec with ``blocked_vdot``. It repeats the kernel bit for bit.
    Inside a program's body (``ops/device_loop.py::in_program``) the same
    iteration runs as ``jacobi_cg``'s while loop, which reads nothing back
    (the iteration count a 0-d tensor) and equals the host loop to the bit."""
    offsets = op.offsets_list

    def A(x):
        xv = torch.where(cvac, x, 0.0)
        mv, corr = dia_combined_matvec_plain(op.diags, offsets, op.val_low, op.val_high, x, xv)
        return torch.where(is_int, diag_i * x - mv - dgc * corr, x)

    cg = jacobi_cg if device_loop.in_program() else jacobi_cg_plain
    return cg(A, rhs, x0, inv_diag, relative_tolerance, max_iterations, dot_fn=blocked_vdot)


def dia_cg_solve_sharded(
    op: DiaOperator,          # this rank's row window of the operator
    mesh,                     # parallel/mesh.py::Mesh
    ranges,                   # every rank's [row0, row1): whole CHUNKs, the last ragged
    cvac: torch.Tensor,       # (N,) bool, replicated
    is_int: torch.Tensor,     # the rank's rows of the vectors of ``dia_cg_solve``
    diag_i: torch.Tensor,
    dgc: torch.Tensor,
    inv_diag: torch.Tensor,
    rhs: torch.Tensor,
    x0: torch.Tensor,
    relative_tolerance: float,
    max_iterations: int,
) -> CGResult:
    """``dia_cg_solve`` with its rows sharded over the ranks of ``mesh``: the
    iteration of ``solvers/cg.py::jacobi_cg`` on the rank's rows of x, r, z
    and p. A product runs the row-window matvec (``ops/dia_matvec.py``; the
    CUDA kernel on the card) on the rank's rows of the whole p. A dot product
    gathers every rank's ``chunk_sums`` and finishes them on the host
    (``finish_chunks``: the same additions in the same order as on the card).
    The rows are whole chunks, so every rank holds what the fused kernel and
    ``dia_cg_solve_plain`` compute, to the bit, iteration count included.

    Two all-gathers per iteration (``Mesh.gather_flat``): p.Ap's chunk sums,
    then z's rows with r.z's chunk sums, from which every rank forms the
    whole next p = z + beta p itself (its own rows of it are its p: the same
    operations on the same values). ``x`` and ``r`` of the result are the
    rank's rows; ``iterations`` is an int."""
    chunk_ranges = [(a // CHUNK, -(-b // CHUNK)) for a, b in ranges]
    dev = rhs.device
    tol2 = relative_tolerance ** 2

    def A(p_whole, p):
        mv, corr = op.matvec(p_whole, torch.where(cvac, p_whole, 0.0))
        return torch.where(is_int, diag_i * p - mv - dgc * corr, p)

    def gather(rows=None, pairs=()):
        """(``rows`` whole on the device, or None; the dot of each pair)."""
        pieces = [] if rows is None else [(rows, ranges, dev)]
        pieces += [(chunk_sums(a, b), chunk_ranges, "cpu") for a, b in pairs]
        out = mesh.gather_flat(pieces)
        dots = [np.float64(finish_chunks(c)) for c in out[len(out) - len(pairs):]]
        return (None if rows is None else out[0]), dots

    def quotient(a, b):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.float64(a) / np.float64(b)    # IEEE, as 0-d tensors divide

    x = x0
    x0_whole, _ = gather(x0)
    r = rhs - A(x0_whole, x0)
    z = r * inv_diag
    p = z
    p_whole, (norm2_rhs, rz) = gather(z, [(rhs, rhs), (r, z)])
    k = 1
    while k <= max_iterations and quotient(rz, norm2_rhs) > tol2:
        Ap = A(p_whole, p)
        _, (pAp,) = gather(pairs=[(p, Ap)])
        a = float(quotient(rz, pAp))
        x = x + a * p
        r = r - a * Ap
        z = r * inv_diag
        z_whole, (rz_new,) = gather(z, [(r, z)])
        beta = float(quotient(rz_new, rz))
        p = z + beta * p
        p_whole = z_whole + beta * p_whole
        rz = rz_new
        k += 1
    return CGResult(x=x, iterations=k, residual_sq=torch.tensor(float(rz), dtype=rhs.dtype),
                    r=r)


def _library():
    """The kernel's library, built and its entry points typed on first use."""
    lib = cuda_build.load(_KERNEL)
    fn = lib.dia_cg_solve_launch
    if fn.argtypes is None:
        if lib.dia_cg_chunk() != CHUNK:
            raise RuntimeError("csrc/dia_cg.cu and solvers/dia_cg.py disagree on the chunk size")
        v, d, i = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
        lib.dia_cg_workspace_doubles.argtypes = [i, ctypes.c_longlong]
        lib.dia_cg_workspace_doubles.restype = ctypes.c_longlong
        fn.argtypes = [v, v, i, ctypes.c_longlong, d, d, v, v, v, v, v, v, v, d, i,
                       v, v, v, v, v, v, v, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    return lib


def _raise_launch_error(err: int) -> None:
    raise RuntimeError(f"dia_cg_solve kernel launch failed: {_ERRORS.get(err, f'CUDA error {err}')}")


_iteration_totals: Dict[int, torch.Tensor] = {}


def _iterations_total(dev: torch.device) -> torch.Tensor:
    """The device's running sum of iteration counts, which the kernel adds
    to itself: a run can total its solves without a host read per solve."""
    total = _iteration_totals.get(dev.index)
    if total is None:
        total = _iteration_totals[dev.index] = torch.zeros((), dtype=torch.int64, device=dev)
    return total


def _workspace(op: DiaOperator, size: int) -> torch.Tensor:
    """The operator's scratch of ``size`` doubles, made on its first solve and
    kept for every later one (a solve inside a captured graph then reads and
    writes the same buffer at every replay)."""
    work = op.__dict__.get("_cg_work")
    if work is None or work.numel() != size:
        work = op.__dict__["_cg_work"] = torch.empty(size, dtype=torch.float64,
                                                     device=op.device)
    return work


def dia_cg_solve(
    op: DiaOperator,
    cvac: torch.Tensor,       # (N,) bool: conductive vacancy
    is_int: torch.Tensor,     # (N,) bool: interior row of the K system
    diag_i: torch.Tensor,     # (N,) f64: K diagonal, 1 outside the interior
    dgc: torch.Tensor,        # (N,) f64: high_G - low_G on conductive vacancies, else 0
    inv_diag: torch.Tensor,   # (N,) f64: the Jacobi preconditioner
    rhs: torch.Tensor,        # (N,) f64
    x0: torch.Tensor,         # (N,) f64
    relative_tolerance: float,
    max_iterations: int,
) -> CGResult:
    """The solve in one kernel launch on CUDA tensors, the plain twin on CPU
    tensors. On the card nothing is read back: ``iterations`` and
    ``residual_sq`` of the result are 0-d tensors on the device. The
    scratch is the operator's (``_workspace``), so solves of one operator
    run one after the other on one stream. Inside a program the launch is
    counted once per run of the program (``device_loop.count_launch``), and
    the kernel adds its count to ``iterations_total`` at every run."""
    dev = op.device
    if op.rows != op.n:
        raise ValueError("dia_cg_solve takes the whole operator, not a row window")
    if dev.type == "cpu":
        return dia_cg_solve_plain(op, cvac, is_int, diag_i, dgc, inv_diag, rhs, x0,
                                  relative_tolerance, max_iterations)
    n = op.n
    for name, t in (("cvac", cvac), ("is_int", is_int)):
        require_tensor(name, t, torch.bool, (n,), dev)
    for name, t in (("diag_i", diag_i), ("dgc", dgc), ("inv_diag", inv_diag),
                    ("rhs", rhs), ("x0", x0)):
        require_tensor(name, t, torch.float64, (n,), dev)
    lib = _library()
    out = torch.empty((2, n), dtype=torch.float64, device=dev)        # x, r
    iterations = torch.empty((), dtype=torch.int32, device=dev)
    residual_sq = torch.empty((), dtype=torch.float64, device=dev)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        # z, two p buffers, the chunk sums; the streaming case's Ap and masks
        size = lib.dia_cg_workspace_doubles(op.D, n)
        if size < 0:      # an error code; a CUDA error e comes as -1000 - e
            _raise_launch_error(size if size > -1000 else -1000 - size)
        work = _workspace(op, size)
        device_loop.bind(op.diags, op.offsets, cvac, is_int, diag_i, dgc, inv_diag, rhs, x0,
                         out, work, iterations, residual_sq, _iterations_total(dev))
        err = lib.dia_cg_solve_launch(
            op.diags.data_ptr(), op.offsets.data_ptr(), op.D, n, op.val_low, op.val_high,
            cvac.data_ptr(), is_int.data_ptr(), diag_i.data_ptr(), dgc.data_ptr(),
            inv_diag.data_ptr(), rhs.data_ptr(), x0.data_ptr(),
            float(relative_tolerance) ** 2, int(max_iterations),
            out[0].data_ptr(), out[1].data_ptr(), work.data_ptr(), iterations.data_ptr(),
            residual_sq.data_ptr(), _iterations_total(dev).data_ptr(),
            current_raw_stream(dev.index), info,
        )
    if err != 0:
        _raise_launch_error(err)
    device_loop.count_launch(dia_cg_solve)
    dia_cg_solve.last_grid = (info[0], bool(info[1]))
    return CGResult(x=out[0], iterations=iterations, residual_sq=residual_sq, r=out[1])


dia_cg_solve.launches = 0
dia_cg_solve.last_grid = None    # (blocks, rows held in registers) of the last launch


def _indexed(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.index is not None else torch.device(dev.type, torch.cuda.current_device())


def iterations_total(device) -> int:
    """Sum of the iteration counts of every fused solve on ``device`` since
    ``reset_iterations_total`` (one host read)."""
    return int(_iterations_total(_indexed(device)))


def reset_iterations_total(device) -> None:
    _iterations_total(_indexed(device)).zero_()


@contextlib.contextmanager
def iterations_total_kept(device):
    """The running sum as it was before the block, whatever the block's
    solves added (a program's warm run before its capture): device copies,
    no read."""
    total = _iterations_total(_indexed(device))
    kept = total.clone()
    try:
        yield
    finally:
        total.copy_(kept)
