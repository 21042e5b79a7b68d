"""Explicit device resolution for the port's entry points.

An entry point runs on the CUDA card unless its caller names another
device. There is no silent fallback: with no device named and no CUDA, or
with ``cuda`` named and no CUDA, it raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); otherwise the named
    device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
