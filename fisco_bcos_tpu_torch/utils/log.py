"""The swallowed-error observer and the module loggers (the port's copies
of ``note_swallowed`` and ``get_logger`` from the JAX package's
``utils/log.py``)."""

from __future__ import annotations

import logging


def note_swallowed(site: str, exc: BaseException | None = None) -> None:
    """Observe an intentionally-swallowed error instead of erasing it: a
    debug log line plus ``fisco_swallowed_errors_total{site=...}``."""
    try:
        from .metrics import REGISTRY

        REGISTRY.counter_add(
            f'fisco_swallowed_errors_total{{site="{site}"}}',
            1.0,
            help="errors intentionally swallowed (tolerated), by site",
        )
    except Exception:  # the swallow observer itself must never raise
        pass
    if exc is not None:
        logging.getLogger("fisco.swallowed").debug("swallowed at %s: %r", site, exc)


def get_logger(name: str) -> logging.Logger:
    """The named logger of a port module (the JAX package's
    ``utils/log.get_logger``, without its root-handler setup: the embedding
    program configures logging)."""
    return logging.getLogger(name)
