"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from transfusion_torch.parallel.mesh import initialized, local_rank


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Under a process group a bare ``cuda`` is the rank's card,
    ``cuda:LOCAL_RANK`` (modulo the cards there are, so ranks may share
    one). A CUDA device on a machine without one raises; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "transfusion_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda" and dev.index is None and initialized():
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev
