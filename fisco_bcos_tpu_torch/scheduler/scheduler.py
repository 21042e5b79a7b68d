"""Scheduler — the two names of the JAX package's ``scheduler/scheduler.py``
that consensus imports: the pipeline switch and the scheduler's error.

The ``Scheduler`` class (block execution and the commit 2PC) is not carried
yet; an engine takes any object with its interface (``execute_block``,
``commit_block``, ``commit_block_async``, ``in_flight_commits``,
``staged_state``).
"""

from __future__ import annotations

import os

from ..utils.error import ErrorCode


def pipeline_on() -> bool:
    """The throughput-campaign switch: ``FISCO_PIPELINE=0`` restores the
    lock-step block loop (execute force-syncs its roots, the checkpoint
    handler drives the 2PC inline, the sealer chains on the durable
    ledger head) as a byte-identical passthrough. Read per call so tests
    can flip it."""
    return os.environ.get("FISCO_PIPELINE", "1") != "0"


class SchedulerError(Exception):
    def __init__(self, code: ErrorCode, msg: str):
        super().__init__(msg)
        self.code = code
