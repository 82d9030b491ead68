"""Device selection for the port's entry points.

Entry points default to the card.  Without one, a run that did not ask
for the CPU fails here instead of carrying on quietly on the host.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: Union[str, torch.device, None] = None) -> torch.device:
    """The torch.device for `device` (default "cuda"); raises if it
    names CUDA and no CUDA device is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the command line) to run on the host")
    return dev
