"""akmc_tpu_torch — the kinetic Monte Carlo simulator of resistive-memory
arrays on PyTorch and CUDA.

A port of ``akmc_tpu`` (JAX on a TPU) that runs in IEEE f64 on an NVIDIA
Hopper card, with the TPU's Pallas kernels rewritten by hand in CUDA C++
(``csrc/``). It imports neither JAX nor ``akmc_tpu``; ``convert.py`` turns
that package's objects, as numpy arrays, into this one's tensors so the
tests can feed both the same inputs.

Entry points run on the card (``device=None`` means CUDA) and raise where
there is none, unless the caller passes ``device="cpu"``.
"""

from akmc_tpu_torch.config import KMCParameters, Layer, default_layers
from akmc_tpu_torch.lattice import ELEM, Lattice, read_xyz, write_xyz_snapshot
from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
from akmc_tpu_torch.state import DeviceState, make_device_state

__version__ = "0.1.0"

__all__ = [
    "KMCParameters",
    "Layer",
    "default_layers",
    "ELEM",
    "Lattice",
    "read_xyz",
    "write_xyz_snapshot",
    "BufferedStream",
    "ReferenceRNG",
    "DeviceState",
    "make_device_state",
    "__version__",
]
