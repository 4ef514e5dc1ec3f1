"""Device selection for the port.

Every entry point takes ``device=None``, which means the CUDA card. There
is no fallback: without a card, ``resolve_device(None)`` raises, and the
CPU is used only when the caller names it (as the CPU tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is present); otherwise
    the named device, which must be ``cpu`` or ``cuda[:i]``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev
