"""Random streams, written from their public definitions.

* mt19937: std::mt19937 seeded with ``init_genrand`` (NumPy's legacy
  ``RandomState`` seeding is the same routine); a double of
  ``uniform_real_distribution<double>(0, 1)`` in libstdc++ takes two 32-bit
  outputs x0, x1 and is (x0 + x1 * 2^32) / 2^64.
* threefry-2x32 (Salmon et al., SC'11, 20 rounds) as ``jax.random`` uses it
  with ``jax_threefry_partitionable``: a key is the two 32-bit words
  (seed >> 32, seed & 0xFFFFFFFF); ``split(key, n)`` hashes the counters
  (0, i); n values hash the counters (i >> 32, i & 0xFFFFFFFF) to words
  (b0, b1); an f64 uniform is the double with mantissa bits
  ((b0 << 32) | b1) >> 12 in [1, 2) minus 1, an f32 one the float with
  mantissa bits (b0 ^ b1) >> 9.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def mt19937_uniforms(seed: int, start: int, count: int) -> np.ndarray:
    """Doubles ``start`` .. ``start + count`` of the mt19937 stream of ``seed``."""
    state = np.random.RandomState(int(seed) & MASK32).get_state()
    bitgen = np.random.MT19937()
    bitgen.state = {"bit_generator": "MT19937", "state": {"key": state[1], "pos": state[2]}}
    words = bitgen.random_raw(2 * (start + count))[2 * start:].astype(np.float64)
    return (words[0::2] + words[1::2] * 4294967296.0) / 18446744073709551616.0


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round block function on int64 tensors holding 32-bit words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([b0, b1], dim=1)


def uniform(k: torch.Tensor, n: int, dtype) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[0], k[1], i >> 32, i & MASK32)
    if dtype == torch.float64:
        return ((b0 << 20) | (b1 >> 12) | 0x3FF0000000000000).view(torch.float64) - 1.0
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
