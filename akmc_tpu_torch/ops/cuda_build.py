"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/akmc_tpu_torch/`` beside
the package, keyed by a hash of the source, then loaded with ``ctypes``.
Nothing is built at import time: the first launch builds (a few seconds),
later launches reuse the loaded library. ``build`` compiles several sources
at once, one ``nvcc`` each.

``-fmad=false``: the kernels feed the K-system CG, whose trajectory reacts to
the last bit of every product (see ``csrc/dia_matvec.cu``), so no multiply-add
may be contracted behind the source's back; the sources also spell every
rounding out with intrinsics. A source in ``FMAD_AS_TORCH`` calls the CUDA
math library where its twin calls PyTorch's kernels, which nvcc builds with
its default ``-fmad=true``: the library's ``pow`` rounds otherwise under
``-fmad=false`` (about four values in a million differ in the last bit), so
such a source is built as PyTorch is; its own operations are ``_rn``
intrinsics, which no setting contracts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "akmc_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",    # registers, shared memory and spills, kept in the build log
]

FMAD_AS_TORCH = ("wkb_ct",)

_loaded: Dict[str, ctypes.CDLL] = {}


def flags(name: str) -> list:
    """``nvcc``'s flags for ``csrc/<name>.cu``."""
    if name not in FMAD_AS_TORCH:
        return NVCC_FLAGS
    return ["-fmad=true" if f == "-fmad=false" else f for f in NVCC_FLAGS]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """What ``nvcc`` and ``ptxas -v`` printed when ``csrc/<name>.cu`` was built."""
    return library_path(name).with_suffix(".log")


def build(names: Iterable[str]) -> None:
    """Compile every ``csrc/<name>.cu`` that has no library yet, all at the
    same time; raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        log_path(name).write_text(text)
        os.replace(tmp, out)     # atomic: concurrent builders never see a partial file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
