"""The DIA combined matvec of the K-CG: the hand-written CUDA kernel
(``csrc/dia_matvec.cu``) and its plain PyTorch twin.

``dia_combined_matvec(diags, offsets, val_low, val_high, x, xv)`` returns
``(W @ x, adjacency @ xv)`` for the int8-coded offset-diagonal operator of
``solvers/dia.py``: per row, y = sum of w·x[i+o_d] over the nonzero codes
(w = val_low for code 1, val_high for code 2) and V = sum of xv[i+o_d] over
them. It replaces ``akmc_tpu/ops/pallas_dia.py::dia_combined_matvec_pallas``.
Kernel, twin and ``akmc_tpu/solvers/dia.py::dia_combined_matvec`` add the
terms in the same order (ascending d) with the same roundings, so all three
agree bit for bit.

Dispatch is by the device of the tensors: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain twin. There is no fallback between
the two. ``DiaOperator`` is the same product with the static operator checked
and its kernel arguments prepared once; the fused CG kernel
(``solvers/dia_cg.py``) takes it too.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from akmc_tpu_torch.ops import cuda_build, device_loop

_KERNEL = "dia_matvec"


def current_raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as the integer a launch
    takes. PyTorch's raw accessor costs a tenth of building a
    ``torch.cuda.Stream`` object per call; where it is missing, the public
    call gives the same stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


class _DiaOp(ctypes.Structure):
    """``struct DiaOp`` of ``csrc/dia_matvec.cu``."""

    _fields_ = [
        ("diags", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
        ("D", ctypes.c_int), ("N", ctypes.c_longlong),
        ("val_low", ctypes.c_double), ("val_high", ctypes.c_double),
        ("row0", ctypes.c_longlong), ("rows", ctypes.c_longlong),
    ]


def _launcher():
    """The library's C entry point, built and typed on first use."""
    fn = cuda_build.load(_KERNEL).dia_combined_matvec_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_DiaOp)] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return fn


def require_tensor(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    """Refuse what the kernels do not take: another device, type or shape,
    or a tensor that is not contiguous."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name} must be {dtype} {shape} on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class DiaOperator:
    """The static int8-coded operator, checked once. A K solve, or a loop of
    matvecs, builds it once and calls it many times: a call then checks only
    its two vectors, and on the card it passes the kernel one prepared
    argument block. It holds the tensors, so the pointers stay
    valid for its lifetime.

    Row window: with ``row0`` and ``n``, ``diags`` is the (D, R) array of the
    codes of rows [row0, row0 + R) of an n-row operator, and a product gives
    those R rows of (W @ x, adjacency @ xv) from x and xv over all n columns
    (a rank's share of a sharded K solve). Keep the array one of its own: a
    view into a larger array loses the kernel's 16-byte code loads."""

    def __init__(self, diags: torch.Tensor, offsets: torch.Tensor,
                 val_low: float, val_high: float, row0: int = 0,
                 n: Optional[int] = None):
        dev = diags.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"DiaOperator: unsupported device {dev}")
        if diags.dim() != 2:
            raise ValueError(f"diags must be (D, N), got {tuple(diags.shape)}")
        self.D, self.rows = diags.shape
        self.row0 = int(row0)
        self.n = self.rows if n is None else int(n)
        if self.row0 < 0 or self.row0 + self.rows > self.n:
            raise ValueError(f"rows [{self.row0}, {self.row0 + self.rows}) lie outside "
                             f"the operator's {self.n}")
        require_tensor("diags", diags, torch.int8, (self.D, self.rows), dev)
        require_tensor("offsets", offsets, torch.int64, (self.D,), dev)
        self.diags, self.offsets = diags, offsets
        self.val_low, self.val_high = float(val_low), float(val_high)
        self.device = dev
        # on the CPU the offsets are at hand; on the card read once, when first asked
        self._offsets_list: Optional[Sequence[int]] = (
            offsets.tolist() if dev.type == "cpu" else None)
        if dev.type == "cuda":
            self._op = _DiaOp(diags.data_ptr(), offsets.data_ptr(), self.D, self.n,
                              self.val_low, self.val_high, self.row0, self.rows)
            self._op_ref = ctypes.byref(self._op)
            self._launch = _launcher()

    @property
    def offsets_list(self) -> Sequence[int]:
        """The offsets as Python ints (one device read, the first time)."""
        if self._offsets_list is None:
            self._offsets_list = self.offsets.tolist()
        return self._offsets_list

    def matvec(self, x: torch.Tensor, xv: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W @ x, adjacency @ xv) on the operator's rows: the kernel on the
        card, the plain twin on the CPU. ``out``, if given, is a (2, rows) f64
        tensor that receives both results (the card only)."""
        dev = self.device
        if dev.type == "cpu":
            return dia_combined_matvec_plain(
                self.diags, self.offsets_list, self.val_low, self.val_high, x, xv,
                row0=self.row0,
            )
        n = self.n
        require_tensor("x", x, torch.float64, (n,), dev)
        require_tensor("xv", xv, torch.float64, (n,), dev)
        if out is None:
            out = torch.empty((2, self.rows), dtype=torch.float64, device=dev)
        else:
            require_tensor("out", out, torch.float64, (2, self.rows), dev)
        device_loop.bind(self.diags, self.offsets, x, xv, out)
        args = (self._op_ref, x.data_ptr(), xv.data_ptr(), out.data_ptr(),
                current_raw_stream(dev.index))
        if torch.cuda.current_device() == dev.index:
            err = self._launch(*args)
        else:                    # entering a device context costs as much as the launch
            with torch.cuda.device(dev):
                err = self._launch(*args)
        if err != 0:
            raise RuntimeError(f"dia_combined_matvec kernel launch failed: CUDA error {err}")
        device_loop.count_launch(dia_combined_matvec)
        return out.unbind(0)     # one call for both views


def dia_combined_matvec(
    diags: torch.Tensor,     # (D, N) int8 codes {0, 1, 2}
    offsets: torch.Tensor,   # (D,) int64 ascending offsets
    val_low: float,
    val_high: float,
    x: torch.Tensor,         # (N,) f64
    xv: torch.Tensor,        # (N,) f64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W @ x, adjacency @ xv) in one call: the kernel on CUDA tensors, the
    plain twin on CPU tensors. Checks the operator every time; a caller with
    many products of one operator keeps a ``DiaOperator``."""
    if x.device != diags.device:
        raise ValueError(f"x is on {x.device}, the operator on {diags.device}")
    return DiaOperator(diags, offsets, val_low, val_high).matvec(x, xv)


dia_combined_matvec.launches = 0   # kernel launches, through either entry point


def dia_combined_matvec_plain(
    diags: torch.Tensor,
    offsets: Sequence[int],
    val_low: float,
    val_high: float,
    x: torch.Tensor,
    xv: torch.Tensor,
    row0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin on any device: one shifted multiply-add per
    diagonal over zero-padded copies of x and xv, in ascending d — the loop
    of ``akmc_tpu/solvers/dia.py::dia_combined_matvec``. With ``row0``,
    ``diags`` holds the codes of rows [row0, row0 + R) and the result is
    those rows of the whole product: each row's terms are the same, in the
    same order."""
    n = x.shape[0]
    rows = diags.shape[1]
    maxo = max(abs(int(o)) for o in offsets)
    xp = torch.zeros(n + 2 * maxo, dtype=x.dtype, device=x.device)
    xp[maxo : maxo + n] = x
    vp = torch.zeros(n + 2 * maxo, dtype=xv.dtype, device=xv.device)
    vp[maxo : maxo + n] = xv
    hi = torch.full((), float(val_high), dtype=x.dtype, device=x.device)
    lo = torch.full((), float(val_low), dtype=x.dtype, device=x.device)
    y = torch.zeros(rows, dtype=x.dtype, device=x.device)
    yv = torch.zeros(rows, dtype=xv.dtype, device=xv.device)
    for d, o in enumerate(offsets):
        c = diags[d]
        bf = torch.where(c == 2, hi, torch.where(c == 1, lo, 0.0))
        s = maxo + int(row0) + int(o)
        y = y + bf * xp[s : s + rows]
        yv = yv + torch.where(c != 0, vp[s : s + rows], 0.0)
    return y, yv
