"""Token-bucket policing (the port's copy of ``TokenBucketRateLimiter`` from
the JAX package's ``gateway/ratelimit.py``; the admission quotas reuse it).

Reference: bcos-gateway/libratelimit/TokenBucketRateLimiter.cpp.
"""

from __future__ import annotations

import threading
import time


class TokenBucketRateLimiter:
    """Classic token bucket: `rate` tokens/sec, burst up to `burst` tokens.
    `try_acquire(n)` is non-blocking (a caller drops or queues on failure,
    it never stalls a reader thread)."""

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0:
            raise ValueError("rate must be positive")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, tokens: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if tokens <= self._tokens:
                self._tokens -= tokens
                return True
            return False

    def available(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens
