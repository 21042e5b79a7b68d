"""Named, deterministic in-process crash points — the process-death analog
of :mod:`.faults`.

A :class:`FaultPlan` injures the *wire* (drop/corrupt/kill a connection —
``kill`` severs the link, the process keeps running); a :class:`CrashPlan`
kills the *process* at a named seam: the Nth time execution reaches an
armed :func:`crashpoint`, :class:`InjectedCrash` is raised and the node is
dead from that instant — whatever was durably written stays written,
whatever was in memory is gone (the harness abandons the node objects and
reboots a fresh node over the same storage).

The seams are planted across the pipelined commit path — exactly the
windows the pipelined commit's overlap opened:

- ``engine.pre_commit_broadcast`` — after ``save_prepared`` made the
  prepared proposal durable, before the COMMIT vote broadcasts: a
  restarted node must re-offer the proposal in view change, never
  equivocate against its own durable vote.
- ``engine.post_head_advance`` — after the optimistic ``consensus_head()``
  advanced, while the 2PC may still be queued on the commit worker: the
  optimistic head dies with the process and must be rebuilt from the
  durable ledger at boot.
- ``scheduler.mid_2pc`` — on the commit path between ``prepare`` and
  ``commit``: a durable prepared-but-unresolved 2PC slot survives the
  crash and boot must re-drive or roll it back (Node's boot scan rolls
  back stale local slots; consensus/block-sync re-drives the block).
- ``sealer.mid_prebuild`` — after the prebuild sealed its txs out of the
  pool, before the proposal exists: the reboot's ``reload_persisted``
  must return them to the sealable set.

Determinism: a rule fires on the Nth *matching* hit of its named seam
(``after`` hits pass first), scoped to one node of a multi-node process by
substring match on the seam's ``scope`` tag (each Node tags its engine/
scheduler/sealer with its pubkey prefix). No RNG — crash points are
count-deterministic, not probabilistic.

Activation mirrors the fault plan: zero overhead when off (one module
global read per seam), armed explicitly (:func:`install_crash_plan`) or
from the environment::

    FISCO_CRASH_PLAN="scheduler.mid_2pc@a1b2c3d4,after=1"

Spec grammar: ``;``-separated clauses ``name[@scope][,after=N][,count=M]``
(scope = substring of the node tag, default ``*`` = any node; count
defaults to 1 — a process only dies once per life).

:class:`InjectedCrash` subclasses ``BaseException`` so no ``except
Exception`` guard on the commit/consensus path can absorb it — it kills
worker threads and halts the engine exactly like process death, and only
the drive/transport boundaries (tests, the engine's message entry) are
allowed to observe it.
"""

from __future__ import annotations

import os
import threading

from ..utils.log import get_logger
from ..utils.metrics import REGISTRY

_log = get_logger("crashpoints")


class InjectedCrash(BaseException):
    """A deliberately injected process death. BaseException on purpose:
    the failure-handling ``except Exception`` paths under test must not be
    able to survive it — a crashed process runs nothing."""


# the registry: every planted seam, by name (tests iterate this to build
# the kill/reboot matrix; arming an unknown name is a loud error)
CRASH_POINTS = (
    "engine.pre_commit_broadcast",
    "engine.post_head_advance",
    "scheduler.mid_2pc",
    "sealer.mid_prebuild",
)


class CrashRule:
    __slots__ = ("name", "scope", "after", "count", "seen", "fired")

    def __init__(self, name: str, scope: str = "*", after: int = 0, count: int = 1):
        if name not in CRASH_POINTS:
            raise ValueError(
                f"unknown crash point {name!r} (known: {', '.join(CRASH_POINTS)})"
            )
        self.name = name
        self.scope = scope or "*"
        self.after = int(after)
        self.count = int(count)
        self.seen = 0
        self.fired = 0

    def matches(self, name: str, scope: str) -> bool:
        if self.name != name:
            return False
        return self.scope == "*" or self.scope in scope

    def __repr__(self) -> str:
        return (
            f"CrashRule({self.name}@{self.scope} after={self.after} "
            f"count={self.count} fired={self.fired})"
        )


class CrashPlan:
    """A set of armed crash rules plus what actually fired.

    ``fired`` lists ``(name, scope)`` in firing order — the harness's
    crash witness (a kill that propagated through worker threads has no
    other observable)."""

    def __init__(self):
        self._rules: list[CrashRule] = []
        self._lock = threading.Lock()
        self.fired: list[tuple[str, str]] = []

    @property
    def crashed(self) -> bool:
        return bool(self.fired)

    def arm(self, name: str, scope: str = "*", after: int = 0, count: int = 1) -> "CrashPlan":
        self._rules.append(CrashRule(name, scope, after, count))
        return self

    @classmethod
    def from_spec(cls, spec: str) -> "CrashPlan":
        """Parse the ``FISCO_CRASH_PLAN`` grammar (module docstring)."""
        plan = cls()
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            head, _, tail = clause.partition(",")
            name, _, scope = head.partition("@")
            kw: dict = {}
            if tail:
                for pair in tail.split(","):
                    k, _, v = pair.partition("=")
                    k = k.strip()
                    if k in ("after", "count"):
                        kw[k] = int(v)
                    else:
                        raise ValueError(f"unknown crash key {k!r} in {clause!r}")
            plan.arm(name.strip(), scope.strip() or "*", **kw)
        return plan

    def hit(self, name: str, scope: str) -> None:
        """One execution reached the named seam: fire the first matching
        armed rule (raising :class:`InjectedCrash`) or pass through."""
        with self._lock:
            rule = None
            for r in self._rules:
                if not r.matches(name, scope):
                    continue
                r.seen += 1
                if r.seen <= r.after:
                    continue
                if r.fired >= r.count:
                    continue
                r.fired += 1
                self.fired.append((name, scope))
                rule = r
                break
        if rule is None:
            return
        REGISTRY.counter_add(
            f'fisco_crashpoints_fired_total{{point="{name}"}}',
            help="injected process deaths by crash point",
        )
        _log.error("crash point %s fired at scope %r — node dies here", name, scope)
        # black box: the firing is the death certificate — record
        # it and flush BEFORE raising, while this "process" still runs; the
        # dying node's last events must not depend on anyone catching the
        # crash. Lazy import: resilience must stay importable without the
        # observability layer mid-boot.
        try:
            from ..observability.flight import FLIGHT

            FLIGHT.record("crash", "fired", scope=scope, point=name)
            FLIGHT.flush(scope or "node", f"crash:{name}")
        except Exception as e:
            from ..utils.log import note_swallowed

            note_swallowed("crashpoints.flight", e)
        raise InjectedCrash(f"injected crash at {name} (scope {scope!r})")


# -- global activation (one pointer read per seam when off) -------------------

_PLAN: CrashPlan | None = None
_env_checked = False


def install_crash_plan(plan: CrashPlan | None) -> None:
    """Explicit arming (tests / harnesses). ``None`` clears."""
    global _PLAN
    _PLAN = plan
    if plan is not None:
        try:
            from ..observability.flight import FLIGHT

            for r in plan._rules:
                FLIGHT.record(
                    "crash", "armed", point=r.name, scope_filter=r.scope,
                    after=r.after, count=r.count,
                )
        except Exception as e:
            from ..utils.log import note_swallowed

            note_swallowed("crashpoints.arm_flight", e)


def clear_crash_plan() -> None:
    install_crash_plan(None)


def active_crash_plan() -> CrashPlan | None:
    return _PLAN


def crashpoint(name: str, scope: str = "") -> None:
    """The seam: zero-overhead no-op unless a plan is armed. ``scope``
    tags which node of a multi-node process is executing (Node sets
    ``crash_scope`` on its engine/scheduler/sealer)."""
    plan = _PLAN
    if plan is not None:
        plan.hit(name, scope)


def ensure_env_crash_plan() -> None:
    """Install the ``FISCO_CRASH_PLAN`` plan once, if the env asks for
    one (called at consensus/scheduler module import — a missing var
    costs one getenv per process lifetime)."""
    global _env_checked, _PLAN
    if _env_checked:
        return
    _env_checked = True
    spec = os.environ.get("FISCO_CRASH_PLAN")
    if spec:
        install_crash_plan(CrashPlan.from_spec(spec))
        _log.warning("crash plan active from FISCO_CRASH_PLAN: %s", spec)
