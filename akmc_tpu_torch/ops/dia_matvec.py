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
the two.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from akmc_tpu_torch.ops import cuda_build

_KERNEL = "dia_matvec"
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launcher():
    """The library's C entry point, built and typed on first use."""
    fn = cuda_build.load(_KERNEL).dia_combined_matvec_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def dia_combined_matvec(
    diags: torch.Tensor,     # (D, N) int8 codes {0, 1, 2}
    offsets: torch.Tensor,   # (D,) int64 ascending offsets
    val_low: float,
    val_high: float,
    x: torch.Tensor,         # (N,) f64
    xv: torch.Tensor,        # (N,) f64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W @ x, adjacency @ xv): the kernel on CUDA tensors, the plain twin
    on CPU tensors."""
    dev = x.device
    if dev.type == "cpu":
        return dia_combined_matvec_plain(
            diags, offsets.tolist(), val_low, val_high, x, xv
        )
    if dev.type != "cuda":
        raise ValueError(f"dia_combined_matvec: unsupported device {dev}")
    D, n = diags.shape
    for name, t, dtype, shape in (
        ("diags", diags, torch.int8, (D, n)),
        ("offsets", offsets, torch.int64, (D,)),
        ("x", x, torch.float64, (n,)),
        ("xv", xv, torch.float64, (n,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"dia_combined_matvec: {name} must be {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"dia_combined_matvec: {name} must be contiguous")
    y = torch.empty_like(x)
    v = torch.empty_like(xv)
    with torch.cuda.device(dev):
        err = _launcher()(
            diags.data_ptr(), offsets.data_ptr(), D, n, x.data_ptr(),
            xv.data_ptr(), float(val_low), float(val_high), y.data_ptr(),
            v.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dia_combined_matvec kernel launch failed: CUDA error {err}")
    dia_combined_matvec.launches += 1
    return y, v


dia_combined_matvec.launches = 0


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
