"""Crash flight recorder — the black box.

The crash lab can kill a node at any armed seam, but once the process
(or the in-proc emulation of one) is dead, the only evidence is whatever it
logged. This module keeps a lock-cheap bounded ring of structured
last-events — engine phase edges (fed by the round ledger), 2PC steps,
pipeline stage transitions, crash-point arming/firing, halt reasons — and
flushes it to ``flight_<node>.json`` at the four death doors: InjectedCrash
(the crash plan flushes *before* raising), ``Node.stop``, the fatal-halt
path, and SIGTERM (:func:`install_signal_flush`).

Ring appends are one ``deque.append`` of a small tuple — atomic under the
GIL, no lock on the hot path; flush and :meth:`FlightRecorder.snapshot`
copy the ring in one pass. Events carry only the monotonic clock; the wall
anchor is taken once at flush time, so :func:`post_mortem` can place every
node's last events on one wall-clock timeline without per-event
``time.time()`` costs.

``FISCO_FLEET_OBS=0`` disables the process recorder: ``record`` is one
attribute check and a return.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque

from ..utils.log import get_logger, note_swallowed
from .roundlog import fleet_obs_enabled

_log = get_logger("flight")

FLIGHT_CAP = 512


def flight_dir() -> str:
    """Where flush lands its dumps (``FISCO_FLIGHT_DIR``, default cwd)."""
    return os.environ.get("FISCO_FLIGHT_DIR", ".")


class FlightRecorder:
    """Bounded last-events ring. ``clock``/``wallclock`` are injectable
    (the interleave harness drives deterministic time); ``enabled=None``
    reads ``FISCO_FLEET_OBS`` at construction."""

    def __init__(
        self,
        cap: int = FLIGHT_CAP,
        clock=time.perf_counter,
        wallclock=time.time,
        enabled: bool | None = None,
    ):
        self.enabled = fleet_obs_enabled() if enabled is None else enabled
        self.clock = clock
        self.wallclock = wallclock
        # (t_mono, scope, category, name, detail) — appended without a lock
        # (GIL-atomic deque.append); maxlen gives the bounded ring
        self._ring: deque[tuple] = deque(maxlen=cap)
        self._flush_lock = threading.Lock()

    def record(self, category: str, name: str, scope: str = "", **detail) -> None:
        if not self.enabled:
            return
        self._ring.append((self.clock(), scope, category, name, detail))

    def snapshot(self) -> list[dict]:
        return [
            {
                "t": t,
                "scope": scope,
                "category": category,
                "name": name,
                "detail": detail,
            }
            for (t, scope, category, name, detail) in list(self._ring)
        ]

    def flush(
        self,
        tag: str,
        reason: str,
        directory: str | None = None,
        rounds: dict | None = None,
    ) -> str | None:
        """Write ``flight_<tag>.json`` (atomic tmp+rename): the ring, the
        death reason, the mono/wall clock anchor pair, and optionally the
        node's round-ledger snapshot so one file explains the death.
        Swallows IO errors — a failing disk must not mask the original
        death — and returns the written path (None when disabled/failed)."""
        if not self.enabled:
            return None
        directory = directory if directory is not None else flight_dir()
        doc = {
            "node": tag,
            "reason": reason,
            "mono_at_flush": self.clock(),
            "wall_at_flush": self.wallclock(),
            "events": self.snapshot(),
        }
        if rounds is not None:
            doc["rounds"] = rounds
        path = os.path.join(directory, f"flight_{tag or 'node'}.json")
        try:
            with self._flush_lock:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f, default=str)
                os.replace(tmp, path)
        except OSError as e:
            note_swallowed("flight.flush", e)
            return None
        _log.warning("flight recorder flushed to %s (%s)", path, reason)
        return path


# process-wide recorder: every subsystem records through this one
FLIGHT = FlightRecorder()


def flush_node(node, reason: str, directory: str | None = None) -> str | None:
    """Flush the process ring tagged with ``node``'s crash scope, embedding
    its round ledger — the one-call form the death doors use."""
    tag = getattr(getattr(node, "engine", None), "crash_scope", "") or "node"
    ledger = getattr(getattr(node, "engine", None), "roundlog", None)
    rounds = ledger.snapshot() if ledger is not None and ledger.enabled else None
    return FLIGHT.flush(tag, reason, directory=directory, rounds=rounds)


_prev_sigterm = None


def install_signal_flush(tag_fn, directory: str | None = None) -> None:
    """Install a SIGTERM handler that flushes the process ring before
    chaining to the previous handler (an operator kill leaves a black box
    too). ``tag_fn`` resolves the flush tag at signal time — node identity
    may not exist yet when the handler is installed."""
    if not FLIGHT.enabled:
        return
    global _prev_sigterm

    def _on_term(signum, frame):
        FLIGHT.record("halt", "sigterm")
        try:
            FLIGHT.flush(tag_fn(), "sigterm", directory=directory)
        except Exception as e:  # a broken flush must not eat the signal
            note_swallowed("flight.sigterm", e)
        prev = _prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
    except ValueError as e:  # not the main thread (embedded/test harness)
        note_swallowed("flight.signal_install", e)


# -- post-mortem --------------------------------------------------------------


def post_mortem(directory: str | None = None) -> dict:
    """Merge every ``flight_*.json`` in ``directory`` (plus the embedded
    round ledgers) into one wall-clock-ordered timeline: who died, why, and
    what each node was doing in its last recorded moments.

    Per-node event wall time = ``wall_at_flush - (mono_at_flush - t)`` —
    the flush-time anchor pair converts monotonic stamps without requiring
    synchronized monotonic clocks across processes."""
    directory = directory if directory is not None else flight_dir()
    nodes: dict[str, dict] = {}
    timeline: list[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        names = []
    for name in names:
        if not (name.startswith("flight_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            note_swallowed("flight.post_mortem", e)
            continue
        tag = doc.get("node", name)
        anchor_mono = float(doc.get("mono_at_flush", 0.0))
        anchor_wall = float(doc.get("wall_at_flush", 0.0))

        def wall(t_mono: float) -> float:
            return anchor_wall - (anchor_mono - t_mono)

        nodes[tag] = {
            "reason": doc.get("reason", ""),
            "flushed_at": anchor_wall,
            "events": len(doc.get("events", ())),
        }
        for ev in doc.get("events", ()):
            timeline.append(
                {
                    "wall": wall(float(ev.get("t", 0.0))),
                    "node": tag,
                    "scope": ev.get("scope", ""),
                    "category": ev.get("category", ""),
                    "name": ev.get("name", ""),
                    "detail": ev.get("detail", {}),
                }
            )
        for rd in doc.get("rounds", {}).get("rounds", ()):
            for event, t in rd.get("events", {}).items():
                timeline.append(
                    {
                        "wall": wall(float(t)),
                        "node": tag,
                        "scope": "",
                        "category": "round",
                        "name": event,
                        "detail": {"height": rd.get("height"),
                                   "view": rd.get("view")},
                    }
                )
    timeline.sort(key=lambda e: e["wall"])
    return {"nodes": nodes, "timeline": timeline}
