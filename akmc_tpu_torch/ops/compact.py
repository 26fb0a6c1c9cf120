"""Fixed-size, order-stable compaction of a boolean mask."""

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
