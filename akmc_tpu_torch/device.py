"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The entry points run on the card: ``None`` means ``cuda``, and asking
    for CUDA where there is none raises instead of quietly running on the
    CPU. Pass ``device="cpu"`` to run the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "akmc_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
