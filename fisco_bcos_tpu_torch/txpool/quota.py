"""Per-group admission quotas + strike-based source demotion (the port's
copy of the JAX package's ``txpool/quota.py``, without the ``/health``
rows: the health registry belongs to the node, which the port does not
carry yet; the ``shedding`` latch that drives them stays in ``snapshot()``).

On a multi-group deployment every group's txpool feeds the SAME DevicePlane and
the same host CPU, so an abusive group flooding invalid-signature spam
taxes every other tenant's admission latency unless the node sheds the
abuse at the door. Two mechanisms, both process-wide so they model the
shared node capacity rather than any single pool:

- **Group token buckets** (reusing
  :class:`..gateway.ratelimit.TokenBucketRateLimiter` — the
  same primitive the gateway polices bandwidth with): each group may admit
  at most ``rate`` txs/sec with bursts up to ``burst``. Overflow is
  rejected *before* the device verify, so a flooding group costs no device
  program — the shed happens at admission, not inside the plane. The
  bucket charges client-facing lanes only (RPC/admission); gossip imports
  on the sync lane are bucket-exempt because the tx already paid at the
  edge node that admitted it — re-charging each replica would multiply
  the cost by the replication factor and shed honest replication.
- **Strike demotion**: a *source* (RPC client tag, gossip peer id) whose
  batches repeatedly contain invalid signatures collects strikes; at
  ``strike_limit`` strikes inside ``strike_window_s`` the source is
  demoted for ``demote_s`` seconds and its submissions are refused
  outright (``SOURCE_DEMOTED``) — invalid signatures are the one reject
  class that is always attributable to the submitter (dup/expired can be
  honest races), so repeated offenders are spam or a broken client.

Observability: every shed tx counts into
``fisco_ratelimit_dropped_total{group=...,scope=...}`` (``scope="admission"``
for quota overflow, ``"demoted"`` for refused sources), strikes into
``fisco_admission_strikes_total{group=...}``.

Knobs (env defaults; per-group overrides via :meth:`AdmissionQuotas.configure`):

- ``FISCO_GROUP_ADMISSION_RATE`` — txs/sec per group (0/unset = unlimited)
- ``FISCO_GROUP_ADMISSION_BURST`` — bucket burst (default = 2x rate)
- ``FISCO_ADMISSION_STRIKE_LIMIT`` — strikes before demotion (default 3)
- ``FISCO_ADMISSION_STRIKE_WINDOW_S`` — strike memory (default 10 s)
- ``FISCO_ADMISSION_DEMOTE_S`` — demotion length (default 30 s)
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..gateway.ratelimit import TokenBucketRateLimiter
from ..utils import env_float as _env_f
from ..utils import metrics as _metrics
from ..utils.log import get_logger

_log = get_logger("admission-quota")


class _GroupState:
    """One group's bucket + per-source strike ledgers (locked by the owner)."""

    __slots__ = ("bucket", "strikes", "demoted_until", "shedding", "quota_drops",
                 "demote_drops")

    def __init__(self, bucket: TokenBucketRateLimiter | None):
        self.bucket = bucket
        # source -> deque of strike monotonic timestamps (window-pruned)
        self.strikes: dict[str, deque] = {}
        # source -> monotonic expiry of its demotion
        self.demoted_until: dict[str, float] = {}
        self.shedding = False  # shedding-edge latch
        self.quota_drops = 0
        self.demote_drops = 0


class AdmissionQuotas:
    """Process-wide per-group admission policer (``get_quotas()`` singleton;
    standalone instances in tests).

    ``try_admit(group, n)`` returns how many of ``n`` statically-admissible
    txs the group's bucket will fund *right now* (partial grants: the
    caller admits the first ``k`` and rejects the rest ``OVER_GROUP_QUOTA``
    — all-or-nothing would let one oversized batch starve itself forever).
    ``demoted(group, source)`` gates a submission up front;
    ``note_invalid(group, source, n)`` files one strike per offending
    batch. With no rate configured and no strikes the hot path is one dict
    lookup + one attribute read per batch.
    """

    def __init__(
        self,
        default_rate: float | None = None,
        default_burst: float | None = None,
        strike_limit: int | None = None,
        strike_window_s: float | None = None,
        demote_s: float | None = None,
    ):
        self.default_rate = (
            _env_f("FISCO_GROUP_ADMISSION_RATE", 0.0)
            if default_rate is None
            else float(default_rate)
        )
        self.default_burst = (
            _env_f("FISCO_GROUP_ADMISSION_BURST", 0.0)
            if default_burst is None
            else float(default_burst)
        )
        self.strike_limit = (
            int(_env_f("FISCO_ADMISSION_STRIKE_LIMIT", 3))
            if strike_limit is None
            else int(strike_limit)
        )
        self.strike_window_s = (
            _env_f("FISCO_ADMISSION_STRIKE_WINDOW_S", 10.0)
            if strike_window_s is None
            else float(strike_window_s)
        )
        self.demote_s = (
            _env_f("FISCO_ADMISSION_DEMOTE_S", 30.0)
            if demote_s is None
            else float(demote_s)
        )
        self._lock = threading.Lock()
        self._groups: dict[str, _GroupState] = {}

    # -- configuration -------------------------------------------------------

    def _make_bucket(
        self, rate: float, burst: float | None
    ) -> TokenBucketRateLimiter | None:
        if rate <= 0:
            return None
        b = burst if burst and burst > 0 else 2.0 * rate
        return TokenBucketRateLimiter(rate, b)

    def configure(
        self, group: str, rate: float, burst: float | None = None
    ) -> None:
        """Set (or clear, rate<=0) the group's admission bucket. Strike
        state survives reconfiguration — a demoted spammer must not be
        amnestied by an operator retuning the rate."""
        with self._lock:
            st = self._group_locked(group)
            st.bucket = self._make_bucket(rate, burst)

    def _group_locked(self, group: str) -> _GroupState:
        st = self._groups.get(group)
        if st is None:
            st = self._groups[group] = _GroupState(
                self._make_bucket(self.default_rate, self.default_burst or None)
            )
        return st

    # -- admission gates -----------------------------------------------------

    def try_admit(self, group: str, n: int) -> int:
        """How many of ``n`` txs the group may admit now (0..n)."""
        if n <= 0:
            return 0
        with self._lock:
            st = self._group_locked(group)
            bucket = st.bucket
        if bucket is None:
            return n
        granted = n
        if not bucket.try_acquire(float(n)):
            # partial grant: fund what the bucket holds, shed the rest
            granted = min(n, int(bucket.available()))
            if granted > 0 and not bucket.try_acquire(float(granted)):
                granted = 0
        shed = n - granted
        if shed:
            self._count_shed(group, st, "admission", shed)
        elif st.shedding:
            self._maybe_recover(group, st)
        return granted

    def any_demoted(self, group: str) -> bool:
        """Lock-free fast path for hot callers (the engine probes every
        QC vote): is ANY source in the penalty box for this group right
        now? A stale read costs one locked :meth:`demoted` probe or one
        extra eager verification tick — never correctness."""
        st = self._groups.get(group)
        return st is not None and bool(st.demoted_until)

    def demoted(self, group: str, source: str) -> bool:
        """Is this source currently demoted for this group? (Gate BEFORE
        static checks: a demoted source's traffic costs nothing.) Sweeps
        EVERY expired penalty in the group, not just the probed source's:
        an offender that goes silent after its penalty lapses must not
        keep :meth:`any_demoted` truthy (and hot callers paying the
        locked probe) forever."""
        now = time.monotonic()
        swept = False
        with self._lock:
            st = self._groups.get(group)
            if st is None or not st.demoted_until:
                return False
            for s, until in list(st.demoted_until.items()):
                if now >= until:
                    del st.demoted_until[s]
                    st.strikes.pop(s, None)  # clean slate after the penalty
                    swept = True
            hit = source in st.demoted_until
        if swept:
            self._maybe_recover(group, st)
        return hit

    def count_demoted_drop(self, group: str, n: int) -> None:
        """Account txs refused because their source is demoted."""
        with self._lock:
            st = self._group_locked(group)
        self._count_shed(group, st, "demoted", n)

    def note_invalid(self, group: str, source: str, n_invalid: int) -> None:
        """One strike per offending batch (not per tx: a single 4096-tx
        garbage batch is one offense; three separate ones are a pattern)."""
        if n_invalid <= 0:
            return
        now = time.monotonic()
        demote = False
        with self._lock:
            st = self._group_locked(group)
            dq = st.strikes.setdefault(source, deque())
            dq.append(now)
            while dq and now - dq[0] > self.strike_window_s:
                dq.popleft()
            if len(dq) >= self.strike_limit and source not in st.demoted_until:
                st.demoted_until[source] = now + self.demote_s
                demote = True
        _metrics.REGISTRY.counter_add(
            f'fisco_admission_strikes_total{{group="{group}"}}',
            help="invalid-signature strikes filed against submitting sources",
        )
        if demote:
            _log.warning(
                "group %s: source %r demoted for %.0fs after %d "
                "invalid-signature strikes",
                group, source, self.demote_s, self.strike_limit,
            )
            _metrics.REGISTRY.counter_add(
                f'fisco_admission_demotions_total{{group="{group}"}}',
                help="sources demoted after repeated invalid-signature strikes",
            )
            self._degrade(group, f"source {source!r} demoted (invalid-sig spam)")

    # -- shedding + metrics edges ----------------------------------------------

    def _count_shed(self, group: str, st: _GroupState, scope: str, n: int) -> None:
        with self._lock:
            if scope == "admission":
                st.quota_drops += n
            else:
                st.demote_drops += n
        _metrics.REGISTRY.counter_add(
            f'fisco_ratelimit_dropped_total{{group="{group}",scope="{scope}"}}',
            float(n),
            help="txs shed at admission by group (quota overflow / demoted "
            "source) — the multi-tenant isolation counter",
        )
        self._degrade(group, f"shedding {scope} load")

    def _degrade(self, group: str, reason: str) -> None:
        with self._lock:
            st = self._group_locked(group)
            first = not st.shedding
            st.shedding = True
        if first:
            _log.info("group %s: admission degraded: %s", group, reason)

    def _maybe_recover(self, group: str, st: _GroupState) -> None:
        """Clear the shedding latch once nothing is being shed and no
        source is still serving a demotion (called on successful admits and
        demotion expiries — the natural recovery edges)."""
        now = time.monotonic()
        with self._lock:
            if not st.shedding:
                return
            if any(u > now for u in st.demoted_until.values()):
                return
            st.shedding = False
        _log.info("group %s: admission quota pressure cleared", group)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """Per-group shed/strike state."""
        now = time.monotonic()
        with self._lock:
            return {
                g: {
                    "limited": st.bucket is not None,
                    "quota_drops": st.quota_drops,
                    "demote_drops": st.demote_drops,
                    "demoted_sources": sorted(
                        s for s, u in st.demoted_until.items() if u > now
                    ),
                    "shedding": st.shedding,
                }
                for g, st in sorted(self._groups.items())
            }

    def reset(self) -> None:
        """Test isolation: drop all group state."""
        with self._lock:
            self._groups.clear()


_QUOTAS: AdmissionQuotas | None = None
_QUOTAS_LOCK = threading.Lock()


def get_quotas() -> AdmissionQuotas:
    """The process-wide policer every group's txpool shares (the quotas
    model the NODE's capacity split across tenants; per-pool instances
    would let N groups each claim the whole node)."""
    global _QUOTAS
    if _QUOTAS is None:
        with _QUOTAS_LOCK:
            if _QUOTAS is None:
                _QUOTAS = AdmissionQuotas()
    return _QUOTAS
