"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA device on a machine without one raises; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "transfusion_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
