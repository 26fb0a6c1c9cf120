"""Fixed-size, order-stable compaction of a boolean mask, and the blocked
prefix count of ``akmc_tpu/ops/compact.py``."""

from __future__ import annotations

from typing import Tuple

import torch


def compact_mask(mask: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending indices of True entries, truncated or -1 padded to
    ``size`` — the ``jnp.nonzero(mask, size=size, fill_value=-1)`` contract
    of ``akmc_tpu/ops/compact.py::compact_mask``.

    Returns (idx int64 (size,), valid bool (size,)). Nothing is read back to
    the host, so it runs inside a captured CUDA graph: each True entry's
    slot is its integer prefix count (exact in any order of summation), and
    one scatter writes every index to its slot; entries past ``size`` and
    False entries go to one spill slot, which is dropped."""
    n = mask.shape[0]
    slot = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    slot = torch.where(mask & (slot < size), slot, size)
    idx = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=mask.device))
    idx = idx[:size]
    return idx, idx >= 0


_B = 512


def prefix_count(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix count of a boolean vector as f32, formed as
    ``akmc_tpu`` forms it: each 512-entry block times an upper-triangular
    ones matrix, plus the cumulative block totals. Exact while the counts
    stay below 2^24, so longer vectors raise."""
    n = mask.shape[0]
    if n >= 1 << 24:
        raise ValueError(
            f"prefix_count: N={n} >= 2^24: f32 counts would lose exactness")
    nb = -(-n // _B)
    m = torch.zeros(nb * _B, dtype=torch.float32, device=mask.device)
    m[:n] = mask.to(torch.float32)
    m = m.reshape(nb, _B)
    tri = torch.triu(torch.ones((_B, _B), dtype=torch.float32, device=mask.device))
    inner = m @ tri
    tot = inner[:, -1]
    offs = torch.cumsum(tot, dim=0) - tot
    return (offs[:, None] + inner).reshape(-1)[:n]
