"""Device selection for the port's entry points: the card by default."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``.  The CPU is used only when it is asked for.

    Raises ``RuntimeError`` when a CUDA device is wanted and none is present:
    an entry point never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU"
        )
    return dev
