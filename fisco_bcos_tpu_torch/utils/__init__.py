"""Host helpers the port's modules share (the port's copies of the few
pieces of the JAX package's ``utils`` that it needs)."""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    """Float env knob with fallback on unset/empty/malformed — the one
    parser every tunable shares (the plane's window and marks, the device
    observatory's storm bounds)."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


__all__ = ["env_float"]
