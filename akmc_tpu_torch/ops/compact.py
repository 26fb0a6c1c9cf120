"""Fixed-size, order-stable compaction of a boolean mask, and the blocked
prefix count of ``akmc_tpu/ops/compact.py``."""

from __future__ import annotations

from typing import Tuple

import torch


def compact_mask(mask: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending indices of True entries, truncated or -1 padded to
    ``size`` — the ``jnp.nonzero(mask, size=size, fill_value=-1)`` contract
    of ``akmc_tpu/ops/compact.py::compact_mask``.

    Returns (idx int64 (size,), valid bool (size,)). On CUDA the nonzero
    reads its count back to the host (one synchronisation)."""
    nz = torch.nonzero(mask).flatten()[:size]
    idx = torch.full((size,), -1, dtype=torch.int64, device=mask.device)
    idx[: nz.numel()] = nz
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
