"""Resilience: named deterministic in-process crash points
(:mod:`.crashpoints`, ``CrashPlan`` / ``FISCO_CRASH_PLAN``), planted across
the consensus path so kill-and-reboot recovery is testable on demand (the
port's copy of that piece of the JAX package's ``resilience``; the fault
plan, retry and breaker modules belong to the node)."""

from __future__ import annotations

from .crashpoints import (  # noqa: F401
    CRASH_POINTS,
    CrashPlan,
    InjectedCrash,
    active_crash_plan,
    clear_crash_plan,
    crashpoint,
    install_crash_plan,
)
