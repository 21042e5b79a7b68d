"""Worker / ThreadPool / Timer — the bcos-utilities concurrency kit.

Reference: bcos-utilities/{Worker.h, ThreadPool.h, Timer.cpp,
ConcurrentQueue.h}.  Every reference module owns a named worker thread or
pool; here the same three shapes back the node runtime, gateway, and RPC:

- ``Worker``: one named thread draining a task queue (Worker.h's
  startWorking/stopWorking loop).
- ``ThreadPool``: N workers over one queue (ThreadPool.h enqueue semantics).
- ``RepeatingTimer``: fixed-interval callback with drift correction
  (Timer.cpp's restart/destroy contract).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

from .log import get_logger

_log = get_logger("worker")


class Worker:
    """One named thread draining a task queue."""

    def __init__(self, name: str = "worker"):
        self.name = name
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._queue.put(None)
        self._thread.join(timeout=5)
        self._thread = None

    def post(self, task: Callable[[], None]) -> None:
        self._queue.put(task)

    def _run(self) -> None:
        while True:
            task = self._queue.get()
            if task is None:
                return
            try:
                task()
            except Exception:
                _log.exception("task failed on %s", self.name)


class ThreadPool:
    """N workers over one queue (ThreadPool.h)."""

    def __init__(self, size: int, name: str = "pool"):
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            for i in range(size)
        ]
        self._started = False

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        if not self._started:
            return
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=5)
        self._started = False

    def enqueue(self, task: Callable[[], None]) -> None:
        self._queue.put(task)

    def _run(self) -> None:
        while True:
            task = self._queue.get()
            if task is None:
                return
            try:
                task()
            except Exception:
                _log.exception("pool task failed")


class RepeatingTimer:
    """Fixed-interval callback on its own thread, drift-corrected."""

    def __init__(self, interval: float, callback: Callable[[], None], name: str = "timer"):
        self.interval = interval
        self.callback = callback
        self.name = name
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        nxt = time.monotonic() + self.interval
        while not self._stop.wait(max(0.0, nxt - time.monotonic())):
            nxt += self.interval
            try:
                self.callback()
            except Exception:
                _log.exception("timer %s callback failed", self.name)
