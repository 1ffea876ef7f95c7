"""Admission control for the serving front end (DESIGN.md §15); a copy of
``repro.serve.admission``.

The paper's deployment is a shared cloud service: "millions of users"
funnel into a fixed pool of cells, so the front door must decide — per
tenant, per request, before any compute is spent — whether a query batch
is served exactly, served degraded, or shed. This module is that
decision, and its one hard rule is the repo-wide counting contract:
**shed load is counted and flagged, never silent** (the same
never-silent discipline as ``compaction_overflow`` §3, ``rerank_misses``
§13, and ``drop_cells`` §14).

Mechanics: one :class:`TokenBucket` per tenant (rate ``rate_qps`` tokens
per second, capacity ``burst``), refilled lazily from an injected
monotonic ``now`` so every decision is deterministic under simulated
clocks (the chaos harness's discipline). A request for ``n`` queries
resolves to one of three :class:`Verdict` values:

* ``ADMIT`` — the bucket covers ``n``: queue for exact service.
* ``DEGRADE`` — the bucket would go negative but stays within the
  tenant's ``degrade_overdraft``: queue, but the front end serves the
  request at its most degraded routing level (§10 ``max_cells``) and the
  response carries the flag.
* ``SHED`` — over quota beyond the overdraft, or the global queue is at
  ``max_queue`` (backpressure): the request is rejected *now*, counted
  in :class:`AdmissionStats` and ``dslsh_serve_shed_total``, and the
  verdict is returned to the caller — explicit backpressure, never a
  silent drop.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch import obs as obs_mod


class Verdict:
    """The three admission outcomes (string constants, stable labels)."""

    ADMIT = "admit"
    DEGRADE = "degrade"
    SHED = "shed"


@dataclasses.dataclass
class TokenBucket:
    """A deterministic token bucket: ``rate_qps`` tokens/s, ``burst`` cap.

    Time is always injected (monotonic seconds); the bucket never reads a
    clock itself, so the same call sequence replays bit-for-bit — the
    property the chaos tests assert exact shed counts with.

    >>> b = TokenBucket(rate_qps=2.0, burst=4.0)
    >>> b.take(4, now=0.0), b.take(1, now=0.0)
    (True, False)
    >>> b.take(1, now=0.5)  # 0.5 s refills one token
    True
    """

    rate_qps: float
    burst: float
    tokens: float = None  # type: ignore[assignment]  # defaults to burst
    _t: float = -math.inf

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = float(self.burst)

    def _refill(self, now: float) -> None:
        if now > self._t:
            if math.isfinite(self._t):
                self.tokens = min(
                    self.burst, self.tokens + (now - self._t) * self.rate_qps
                )
            self._t = now

    def level(self, now: float) -> float:
        """Tokens available at ``now`` (refills, takes nothing)."""
        self._refill(now)
        return self.tokens

    def take(self, n: float, now: float) -> bool:
        """Take ``n`` tokens if available; False (and no change) if not."""
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def take_overdraft(self, n: float, now: float, overdraft: float) -> bool:
        """Take ``n`` tokens allowing the level to go down to
        ``-overdraft`` (the DEGRADE band); False (and no change) below."""
        self._refill(now)
        if self.tokens - n >= -overdraft:
            self.tokens -= n
            return True
        return False


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits.

    ``rate_qps`` / ``burst`` parameterize the token bucket (queries per
    second and the burst capacity). ``degrade_overdraft`` is the extra
    band of queries a tenant may go over quota by at *degraded* service —
    the request is admitted but served at the most degraded §10 routing
    level and flagged. 0 (the default) means over-quota goes straight to
    SHED.
    """

    rate_qps: float = math.inf
    burst: float = math.inf
    degrade_overdraft: float = 0.0


@dataclasses.dataclass
class AdmissionStats:
    """Host-side admission ledger (the conservation check reads this).

    ``submitted = admitted + degraded + shed`` always holds — every
    request that reaches :meth:`AdmissionController.admit` lands in
    exactly one counter, which is what makes a silent drop structurally
    impossible at the front door.
    """

    submitted: int = 0
    admitted: int = 0  # queued for exact service
    degraded: int = 0  # queued at degraded service (overdraft band)
    shed: int = 0  # rejected with backpressure
    shed_queue_full: int = 0  # of which: global queue at max_queue

    def check(self) -> None:
        """Assert the admission ledger balances (counted, never silent)."""
        assert self.submitted == self.admitted + self.degraded + self.shed, (
            self,
        )


class AdmissionController:
    """Per-tenant token-bucket admission + global queue backpressure.

    ``quotas`` maps tenant name to :class:`TenantQuota`; tenants not in
    the map get ``default_quota`` (unlimited unless configured). The
    global ``max_queue`` bounds the front end's total queued *queries*
    (not requests): a full queue sheds regardless of quota — that is the
    explicit backpressure signal, and it is counted separately in
    ``shed_queue_full``.
    """

    def __init__(
        self,
        quotas: dict[str, TenantQuota] | None = None,
        *,
        default_quota: TenantQuota = TenantQuota(),
        max_queue: int = 4096,
    ):
        self.max_queue = max_queue
        self._quotas = dict(quotas or {})
        self._default = default_quota
        self._buckets: dict[str, TokenBucket] = {}
        self.stats = AdmissionStats()

    def quota(self, tenant: str) -> TenantQuota:
        """The effective quota for ``tenant``."""
        return self._quotas.get(tenant, self._default)

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            q = self.quota(tenant)
            b = self._buckets[tenant] = TokenBucket(q.rate_qps, q.burst)
        return b

    def admit(
        self, tenant: str, n_queries: int, queue_depth: int, now: float
    ) -> str:
        """Decide one request: ADMIT, DEGRADE, or SHED (see module doc).

        ``queue_depth`` is the front end's current queued-query total;
        ``now`` is monotonic seconds. Every outcome is recorded in
        :attr:`stats` and the ``dslsh_serve_admitted_total{verdict}`` /
        ``dslsh_serve_shed_total{tenant}`` counters.
        """
        self.stats.submitted += 1
        if queue_depth + n_queries > self.max_queue:
            self.stats.shed += 1
            self.stats.shed_queue_full += 1
            self._record(tenant, Verdict.SHED)
            return Verdict.SHED
        bucket = self._bucket(tenant)
        if bucket.take(n_queries, now):
            self.stats.admitted += 1
            self._record(tenant, Verdict.ADMIT)
            return Verdict.ADMIT
        q = self.quota(tenant)
        if q.degrade_overdraft > 0 and bucket.take_overdraft(
            n_queries, now, q.degrade_overdraft
        ):
            self.stats.degraded += 1
            self._record(tenant, Verdict.DEGRADE)
            return Verdict.DEGRADE
        self.stats.shed += 1
        self._record(tenant, Verdict.SHED)
        return Verdict.SHED

    def _record(self, tenant: str, verdict: str) -> None:
        ob = obs_mod.get_active()
        if ob is None or ob.metrics is None:
            return
        m = ob.metrics
        m.counter(
            "dslsh_serve_admitted_total",
            "front-end admission decisions by verdict (DESIGN.md §15)",
        ).labels(verdict=verdict).inc()
        if verdict == Verdict.SHED:
            m.counter(
                "dslsh_serve_shed_total",
                "requests shed with explicit backpressure — counted and"
                " returned to the caller, never silently dropped",
            ).labels(tenant=tenant).inc()
