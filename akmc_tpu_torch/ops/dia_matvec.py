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

from akmc_tpu_torch.ops import cuda_build

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
    valid for its lifetime."""

    def __init__(self, diags: torch.Tensor, offsets: torch.Tensor,
                 val_low: float, val_high: float):
        dev = diags.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"DiaOperator: unsupported device {dev}")
        if diags.dim() != 2:
            raise ValueError(f"diags must be (D, N), got {tuple(diags.shape)}")
        self.D, self.n = diags.shape
        require_tensor("diags", diags, torch.int8, (self.D, self.n), dev)
        require_tensor("offsets", offsets, torch.int64, (self.D,), dev)
        self.diags, self.offsets = diags, offsets
        self.val_low, self.val_high = float(val_low), float(val_high)
        self.device = dev
        self._offsets_list: Optional[Sequence[int]] = None
        if dev.type == "cuda":
            self._op = _DiaOp(diags.data_ptr(), offsets.data_ptr(), self.D, self.n,
                              self.val_low, self.val_high)
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
        """(W @ x, adjacency @ xv): the kernel on the card, the plain twin
        on the CPU. ``out``, if given, is a (2, N) f64 tensor that receives
        both results (the card only)."""
        dev = self.device
        if dev.type == "cpu":
            return dia_combined_matvec_plain(
                self.diags, self.offsets_list, self.val_low, self.val_high, x, xv
            )
        n = self.n
        require_tensor("x", x, torch.float64, (n,), dev)
        require_tensor("xv", xv, torch.float64, (n,), dev)
        if out is None:
            out = torch.empty((2, n), dtype=torch.float64, device=dev)
        else:
            require_tensor("out", out, torch.float64, (2, n), dev)
        args = (self._op_ref, x.data_ptr(), xv.data_ptr(), out.data_ptr(),
                current_raw_stream(dev.index))
        if torch.cuda.current_device() == dev.index:
            err = self._launch(*args)
        else:                    # entering a device context costs as much as the launch
            with torch.cuda.device(dev):
                err = self._launch(*args)
        if err != 0:
            raise RuntimeError(f"dia_combined_matvec kernel launch failed: CUDA error {err}")
        dia_combined_matvec.launches += 1
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin on any device: one shifted multiply-add per
    diagonal over zero-padded copies of x and xv, in ascending d — the loop
    of ``akmc_tpu/solvers/dia.py::dia_combined_matvec``."""
    n = x.shape[0]
    maxo = max(abs(int(o)) for o in offsets)
    xp = torch.zeros(n + 2 * maxo, dtype=x.dtype, device=x.device)
    xp[maxo : maxo + n] = x
    vp = torch.zeros(n + 2 * maxo, dtype=xv.dtype, device=xv.device)
    vp[maxo : maxo + n] = xv
    hi = torch.tensor(float(val_high), dtype=x.dtype, device=x.device)
    lo = torch.tensor(float(val_low), dtype=x.dtype, device=x.device)
    y = torch.zeros_like(x)
    yv = torch.zeros_like(xv)
    for d, o in enumerate(offsets):
        c = diags[d]
        bf = torch.where(c == 2, hi, torch.where(c == 1, lo, 0.0))
        s = maxo + int(o)
        y = y + bf * xp[s : s + n]
        yv = yv + torch.where(c != 0, vp[s : s + n], 0.0)
    return y, yv
