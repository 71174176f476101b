"""Admission control, multi-tenant fair scheduling, and SLO math for the
CA serve engine.

The port's own copy of ``repro/serve/admission.py`` (it depends on no
array library).  The engine's kernel stack saturates the card
(temporally blocked CUDA launches, halo exchanges); this module is what
makes that throughput *deliverable* under overload.  Three mechanisms:

* **Token-bucket rate limits + bounded queues** per tenant.  ``submit``
  under offered load above a tenant's contract fails *fast and typed*
  (:class:`RateLimited` / :class:`QueueFull`, both carrying
  ``retry_after_s``) instead of queueing unboundedly -- the client can
  back off; nobody else's latency inflates.

* **Deadline-aware admission.**  A :class:`RoundTimeModel` blends the
  roofline model's per-round estimate (``roofline.analysis.
  sharded_fhp_traffic`` -- the seed before any round has run) with an
  EWMA of *measured* round wall-clock.  A job whose ``deadline_s`` is
  provably unmeetable even if it ran immediately
  (``min_rounds * round_s > deadline``) is refused at submit
  (:class:`DeadlineInfeasible`) rather than admitted, starved, and shed
  later -- and a queued job whose best case has drifted past its
  deadline is *shed* by the engine with the same math.

* **Deficit-round-robin fair scheduling** (:class:`FairScheduler`).
  Lane slots are assigned at round boundaries by strict priority class,
  and *within* a class by DRR over tenants: each backlogged tenant
  accrues ``quantum * weight`` deficit per scheduling round and pays the
  job's cost (its round count) on admission, so long-job tenants cannot
  crowd out small ones and weighted shares hold in *work* terms, not job
  counts.  An aging guard promotes any job queued longer than
  ``starvation_rounds`` to the head of the order regardless of class --
  strict priority cannot starve the low class forever.

:func:`jain_index` is the fairness figure of merit the overload bench
gates on: ``(sum x)^2 / (n * sum x^2)`` over per-tenant weighted
throughput, 1.0 = perfectly fair.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "TenantConfig", "TokenBucket", "RoundTimeModel", "FairScheduler",
    "AdmissionError", "RateLimited", "QueueFull", "DeadlineInfeasible",
    "UnknownTenant", "AdmissionController", "jain_index",
]


# ---------------------------------------------------------------------------
# Typed backpressure
# ---------------------------------------------------------------------------

class AdmissionError(RuntimeError):
    """A submission was refused.  ``retry_after_s`` is the client's
    backoff hint (0 = never admissible as posed, e.g. an infeasible
    deadline)."""

    def __init__(self, msg: str, *, tenant: str = "", rid: int = -1,
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.tenant, self.rid = tenant, rid
        self.retry_after_s = float(retry_after_s)

    @property
    def reason(self) -> str:
        return type(self).__name__

    def to_record(self) -> dict:
        return {"reason": self.reason, "tenant": self.tenant,
                "rid": self.rid, "retry_after_s": self.retry_after_s}


class RateLimited(AdmissionError):
    """The tenant's token bucket is empty; retry after the refill."""


class QueueFull(AdmissionError):
    """The tenant's bounded queue is at its limit."""


class DeadlineInfeasible(AdmissionError):
    """``deadline_s`` cannot be met even with zero queueing: the round
    model's best case already exceeds it.  Carries ``needed_s``."""

    def __init__(self, msg: str, *, needed_s: float, deadline_s: float,
                 **kw):
        super().__init__(msg, **kw)
        self.needed_s, self.deadline_s = float(needed_s), float(deadline_s)


class UnknownTenant(AdmissionError):
    """Submission named a tenant the engine was not configured with."""


# ---------------------------------------------------------------------------
# Tenant contracts and rate limiting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantConfig:
    """One tenant's service contract.

    ``priority`` is a strict class (higher preempts/schedules first);
    ``weight`` is the DRR share *within* a class; ``rate``/``burst``
    the token bucket (``rate=None`` = unlimited); ``queue_limit`` the
    bounded backlog (None = unbounded -- kept for the default tenant so
    single-tenant callers see no backpressure).
    """

    name: str
    priority: int = 1
    weight: float = 1.0
    rate: Optional[float] = None        # admissions per second
    burst: int = 8                      # bucket capacity
    queue_limit: Optional[int] = None   # max queued jobs
    frame_slo_s: Optional[float] = None  # default per-job frame SLO


class TokenBucket:
    """Standard token bucket on a caller-supplied monotonic clock."""

    def __init__(self, rate: Optional[float], burst: int,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = rate
        self.burst = max(int(burst), 1)
        self._clock = clock
        self._tokens = float(self.burst)
        self._last = clock()

    def _refill(self, now: float) -> None:
        if self.rate:
            self._tokens = min(float(self.burst),
                               self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate is None:
            return True
        now = self._clock()
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 if now)."""
        if self.rate is None:
            return 0.0
        self._refill(self._clock())
        deficit = n - self._tokens
        return max(deficit, 0.0) / self.rate


# ---------------------------------------------------------------------------
# Round-time model (roofline seed -> measured EWMA)
# ---------------------------------------------------------------------------

class RoundTimeModel:
    """Seconds-per-engine-round estimator.

    Seeded with the roofline model's per-round cost (modeled bytes and
    exchange latency -- see ``CAServeEngine._modeled_round_s``) so
    deadline admission has *some* basis before the first round runs;
    after that an EWMA of measured round wall-clock dominates (the
    roofline prices the card's datasheet rates, and the engine may run
    the plain version on a CPU -- only the measurement is trustworthy
    for wall-clock SLOs).
    """

    def __init__(self, modeled_s: float = 0.0, alpha: float = 0.25):
        self.modeled_s = float(modeled_s)
        self.alpha = float(alpha)
        self.ewma_s: Optional[float] = None
        self.n_observed = 0

    def observe(self, round_s: float) -> None:
        round_s = float(round_s)
        self.ewma_s = (round_s if self.ewma_s is None else
                       self.alpha * round_s + (1 - self.alpha) * self.ewma_s)
        self.n_observed += 1

    def round_s(self) -> float:
        return self.ewma_s if self.ewma_s is not None else self.modeled_s

    def best_case_s(self, rounds: int) -> float:
        """Wall-clock floor for ``rounds`` engine rounds with zero
        queueing -- the 'provably unmeetable' test uses this, so it must
        be optimistic, never padded."""
        return max(int(rounds), 0) * self.round_s()


# ---------------------------------------------------------------------------
# Deficit-round-robin fair scheduler
# ---------------------------------------------------------------------------

class FairScheduler:
    """Per-tenant FIFO queues + DRR ordering across tenants.

    The engine asks for a full candidate *order* each round boundary
    (:meth:`order`), attempts admission greedily in that order, then
    returns the un-admitted tail via :meth:`requeue_front` (FIFO within
    each tenant is preserved; deficit charged at ordering time is
    refunded by :meth:`refund`).  Deficits persist across rounds -- a
    tenant blocked behind a full lane group keeps its accumulated claim
    -- but reset when its backlog empties (standard DRR: no banking
    credit while idle).
    """

    def __init__(self, tenants: Dict[str, TenantConfig]):
        self.tenants: Dict[str, TenantConfig] = dict(tenants)
        self.queues: Dict[str, deque] = {n: deque() for n in self.tenants}
        self.deficit: Dict[str, float] = {n: 0.0 for n in self.tenants}

    # -- tenant registry ----------------------------------------------------
    def ensure(self, name: str) -> TenantConfig:
        """Auto-register an unconfigured tenant with default limits
        (permissive mode -- the engine rejects unknown tenants itself
        when explicit tenant configs were given)."""
        if name not in self.tenants:
            self.tenants[name] = TenantConfig(name=name)
            self.queues[name] = deque()
            self.deficit[name] = 0.0
        return self.tenants[name]

    # -- queue ops ----------------------------------------------------------
    def enqueue(self, tenant: str, rid: int, front: bool = False) -> None:
        q = self.queues[self.ensure(tenant).name]
        q.appendleft(rid) if front else q.append(rid)

    def remove(self, rid: int) -> bool:
        for q in self.queues.values():
            if rid in q:
                q.remove(rid)
                return True
        return False

    def clear(self) -> None:
        for q in self.queues.values():
            q.clear()

    def rids(self) -> List[int]:
        """Every queued rid, grouped by tenant name (deterministic
        order), FIFO within tenant -- the checkpoint-meta encoding."""
        out: List[int] = []
        for n in sorted(self.queues):
            out.extend(self.queues[n])
        return out

    def backlog(self, tenant: str) -> int:
        return len(self.queues.get(tenant, ()))

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def __contains__(self, rid: int) -> bool:
        return any(rid in q for q in self.queues.values())

    # -- DRR ordering -------------------------------------------------------
    def order(self, cost_of: Callable[[int], float],
              aged: Optional[Sequence[int]] = None) -> List[int]:
        """Pop *every* queued rid into one admission-attempt order.

        ``aged`` rids (starvation guard) lead the order regardless of
        class.  The rest: priority classes descending; within a class,
        DRR -- each pass credits every backlogged tenant
        ``quantum * weight`` (quantum = the largest head cost, so every
        pass admits at least one job somewhere) and pops heads while the
        tenant's deficit covers their cost.  Tenants whose backlog
        empties have their deficit reset.
        """
        out: List[int] = []
        aged = [r for r in (aged or []) if self.remove(r)]
        out.extend(aged)

        def prio(n: str) -> int:
            return self.tenants[n].priority

        while any(self.queues.values()):
            top = max(prio(n) for n, q in self.queues.items() if q)
            names = sorted(n for n, q in self.queues.items()
                           if q and prio(n) == top)
            while any(self.queues[n] for n in names):
                quantum = max(cost_of(self.queues[n][0])
                              for n in names if self.queues[n])
                for n in names:
                    q = self.queues[n]
                    if not q:
                        continue
                    self.deficit[n] += quantum * self.tenants[n].weight
                    while q and self.deficit[n] >= cost_of(q[0]):
                        rid = q.popleft()
                        self.deficit[n] -= cost_of(rid)
                        out.append(rid)
        for n, q in self.queues.items():
            if not q:
                self.deficit[n] = 0.0
        return out

    def requeue_front(self, tenant: str, rids: Sequence[int]) -> None:
        """Push un-admitted candidates back, preserving their order at
        the head of the tenant queue."""
        for rid in reversed(list(rids)):
            self.queues[tenant].appendleft(rid)

    def refund(self, tenant: str, cost: float) -> None:
        self.deficit[tenant] += cost


# ---------------------------------------------------------------------------
# The admission controller the engine consults at submit()
# ---------------------------------------------------------------------------

class AdmissionController:
    """Per-tenant token buckets + bounded queues + deadline feasibility.

    ``check`` either returns (admit: enqueue the job) or raises one of
    the typed :class:`AdmissionError`\\ s.  The order is deliberate:
    queue bound first (cheapest, and a full queue means the rate token
    would be wasted), then the rate bucket (consumes a token), then the
    deadline test (consumes nothing -- an infeasible deadline is the
    *client's* error, it must not burn their quota).
    """

    def __init__(self, sched: FairScheduler, model: RoundTimeModel,
                 clock: Callable[[], float] = time.monotonic):
        self.sched = sched
        self.model = model
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}

    def bucket(self, tenant: str) -> TokenBucket:
        if tenant not in self._buckets:
            cfg = self.sched.ensure(tenant)
            self._buckets[tenant] = TokenBucket(cfg.rate, cfg.burst,
                                                self._clock)
        return self._buckets[tenant]

    def check(self, *, tenant: str, rid: int, rounds: int,
              deadline_s: Optional[float]) -> None:
        cfg = self.sched.ensure(tenant)
        backlog = self.sched.backlog(tenant)
        if cfg.queue_limit is not None and backlog >= cfg.queue_limit:
            # Backoff hint: one queue slot frees roughly when the head
            # job's cost drains at the measured round rate.
            raise QueueFull(
                f"tenant {tenant!r} queue at limit "
                f"({backlog}/{cfg.queue_limit})", tenant=tenant, rid=rid,
                retry_after_s=max(self.model.round_s(), 1e-3))
        bucket = self.bucket(tenant)
        if not bucket.try_take():
            raise RateLimited(
                f"tenant {tenant!r} rate limit "
                f"({cfg.rate}/s, burst {cfg.burst})", tenant=tenant,
                rid=rid, retry_after_s=bucket.retry_after_s())
        if deadline_s is not None:
            needed = self.model.best_case_s(rounds)
            if needed > deadline_s:
                raise DeadlineInfeasible(
                    f"job {rid} needs >= {needed:.3g}s "
                    f"({rounds} rounds) but deadline_s={deadline_s:.3g}",
                    needed_s=needed, deadline_s=deadline_s,
                    tenant=tenant, rid=rid, retry_after_s=0.0)


# ---------------------------------------------------------------------------
# Fairness figure of merit
# ---------------------------------------------------------------------------

def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant (weight-normalised)
    throughput: 1.0 = perfectly fair, 1/n = one tenant took everything.
    Empty or all-zero input returns 1.0 (nothing was shared unfairly).
    """
    xs = [float(v) for v in values]
    if not xs or not any(xs):
        return 1.0
    s, sq = sum(xs), sum(x * x for x in xs)
    return (s * s) / (len(xs) * sq)
