"""Device choice for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one.

    With no device given and no CUDA device present this raises; it never
    moves to the CPU quietly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: nvblox_mindmap_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
