"""Fault-tolerant CA simulation service: slot-based continuous batching
of simulation jobs into the ensemble lane axis, with invariant-audited
checkpoints, rollback-replay, and SLO-driven admission control.

The counterpart of ``repro/serve/engine.py``, with the same logic.  A
lane group's state is a ``(B, n_planes, H, Wd)`` ``torch.int32`` bit-view
of the reference's uint32 words -- one tensor on the engine's ``device``
(a CUDA device runs the fused kernel, the CPU its plain version), or
``ShardedPlanes`` on a :class:`~repro_torch.core.distributed.Mesh` --
updated lane by lane in place at admission, parking, quarantine and
retirement.  ``job.result`` and ``parked_state`` are host uint32 arrays,
and checkpoints hold the lattices as uint32 leaves, as in the
reference, so either package resumes the other's checkpoints.

Clients submit :class:`SimJob`\\ s -- ``(scenario, rule, params, steps)``
from the scenario registry.  The engine packs live jobs into the ``B``
axis of the batched ``(B, n_planes, H, Wd)`` lane stack (one *lane
group* per ``(rule, p_force)``, since the collision circuit and the
forcing constant are launch-wide), advances every group ``depth`` global
steps per *round* through the temporal-blocked sharded kernel
(``core.distributed.make_ensemble_run``), streams observable frames back
per job cadence, and admits/retires jobs at round boundaries
(continuous batching, as in LM serving -- but the "KV cache" is a
lattice and the "tokens" are CA steps).

Robustness layer (why this is a *service* and not a batch script):

* **Invariant audits.**  Every registered rule carries exact
  conservation laws (``core.rulespec.invariants``): mass, per-species
  counts, solid-plane popcount, momentum on free tori, and structural
  exclusivity.  Each audit cadence the engine compares every live
  lane against the values recorded at admission -- any mismatch is
  corruption, detected *for free* (popcount reductions, no reference
  run).
* **Audited checkpoints.**  Checkpoints are only written on rounds whose
  audit passed, so the rollback anchor is always a known-good state;
  ``checkpoint.store`` adds per-leaf checksums and
  ``latest_valid_step``, so torn/corrupt checkpoints on disk are skipped
  at restore time.
* **Rollback-and-replay.**  On detection the engine restores the last
  audited checkpoint and replays.  The RNG is counter-based on global
  ``(t, row, word)``, so the replay is *bit-exact*: a recovered run is
  indistinguishable from one that never faulted.  Retries are bounded
  per job; a job that keeps triggering detections (a persistent fault)
  is **quarantined** -- its lane zeroed and freed -- so one poisoned job
  degrades gracefully instead of sinking the whole batch.
* **Crash resume.**  :meth:`CAServeEngine.resume` reconstructs the whole
  engine (lane states, job bookkeeping, admission queue, *lifetime
  stats*) from the last valid checkpoint after a process death.

Overload-robustness layer (what makes it *operable*):

* **Typed admission control** (``serve.admission``).  Per-tenant
  token-bucket rate limits and bounded queues: ``submit`` raises
  :class:`~repro_torch.serve.admission.RateLimited` /
  :class:`~repro_torch.serve.admission.QueueFull` (each with a
  ``retry_after_s`` backoff hint) instead of queueing unboundedly.
  Deadline-aware admission consults a round-time model (roofline seed,
  measured EWMA): a ``deadline_s`` that is provably unmeetable even
  with zero queueing is refused at submit
  (:class:`~repro_torch.serve.admission.DeadlineInfeasible`).
* **Multi-tenant fairness.**  Lane slots are assigned at round
  boundaries by strict priority class and deficit-round-robin within a
  class (work-proportional costs, aging guard against cross-class
  starvation).  A higher-class job blocked behind a full lane group may
  **preempt** a lower-class lane: the victim is *parked* -- its lattice
  checkpointed bit-exactly at an audited round boundary -- and resumed
  later in a fresh segment.  An RNG-free rule (e.g. BML, with
  parity-preserving ``depth``) resumes bit-identical to an unpreempted
  run; RNG rules resume bit-identical to their segmented solo replay
  (the same contract rollback-replay already provides).
* **Graceful degradation.**  Queued jobs whose deadline has become
  unmeetable are **shed** (typed, logged); when round wall-clock
  exceeds ``round_budget_s`` the engine sheds lowest-priority backlog
  and *stretches* the frame/checkpoint cadence for a few rounds;
  straggler rounds (wall >> rolling median, e.g. a ``slow_exchange``
  hop) are detected and counted so one slow link is visible instead of
  silently poisoning every co-batched lane's p99.
* **SLO accounting.**  ``metrics()["slo"]`` reports per-tenant
  throughput, frame-gap percentiles, deadline misses, sheds/rejects,
  and the Jain fairness index over weighted per-tenant work.

A :class:`repro_torch.serve.faults.FaultInjector` can be attached to drive
the deterministic fault schedule (bit flips, garbaged shards, torn
checkpoints, kills, stragglers, burst storms, poison pills) that the
tests exercise recovery and overload behaviour with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry as _telemetry
from repro_torch.checkpoint import store
from repro_torch.core import carry, distributed, rulespec
from repro_torch.core.distributed import ShardedPlanes
from repro_torch.serve import admission as _adm

QUEUED, RUNNING, DONE, QUARANTINED = \
    "queued", "running", "done", "quarantined"
PARKED, SHED = "parked", "shed"


class DrainTimeout(RuntimeError):
    """``drain`` hit its round cap with live work still in flight.
    Carries the stuck ``rids`` (running + queued + parked) and the
    queue depth at timeout -- the caller can inspect, shed, or resume
    instead of silently treating a wedged engine as drained."""

    def __init__(self, rids: List[int], queue_depth: int, rounds: int):
        self.rids = list(rids)
        self.queue_depth = int(queue_depth)
        self.rounds = int(rounds)
        super().__init__(
            f"drain exceeded {rounds} rounds with {len(self.rids)} live "
            f"job(s) {self.rids} (queue depth {queue_depth})")


# Runtime fields mirrored into checkpoint meta (everything a restart or
# rollback needs to replay bit-exactly; ``parked_state`` lattices are
# checkpoint *leaves*, not meta).
_JOB_META_FIELDS = (
    "status", "lane", "admitted_t", "steps_done", "expected",
    "with_momentum", "tenant", "deadline_s", "frame_slo_s", "segments",
    "preemptions", "submitted_wall", "enqueued_round")


@dataclasses.dataclass
class SimJob:
    """One simulation job: a registry scenario advanced ``steps`` CA
    steps, with an observable frame streamed every ``frame_every``
    steps (0 = final state only).  ``overrides`` pass through to
    ``scenarios.get`` (density, seed, ... -- height/width are pinned by
    the engine's lattice).  ``tenant`` names the admission contract
    (default tenant = unlimited, the pre-SLO behaviour); ``deadline_s``
    / ``frame_slo_s`` are wall-clock SLOs measured from submission.
    Runtime fields are engine-managed."""

    rid: int
    scenario: str
    steps: int
    frame_every: int = 0
    overrides: dict = dataclasses.field(default_factory=dict)
    tenant: str = "default"
    deadline_s: Optional[float] = None
    frame_slo_s: Optional[float] = None
    # --- runtime (engine-managed) ---
    status: str = QUEUED
    lane: int = -1
    admitted_t: int = -1
    steps_done: int = 0
    expected: dict = dataclasses.field(default_factory=dict)
    with_momentum: bool = False
    segments: list = dataclasses.field(default_factory=list)  # [[t0, n]..]
    preemptions: int = 0
    submitted_wall: float = 0.0
    enqueued_round: int = 0
    finished_wall: Optional[float] = None
    deadline_met: Optional[bool] = None
    frame_slo_violations: int = 0
    shed_reason: Optional[str] = None
    parked_state: Optional[np.ndarray] = None               # host lattice
    frames: dict = dataclasses.field(default_factory=dict)   # t -> frame
    result: Optional[np.ndarray] = None                      # final planes

    def to_meta(self) -> dict:
        m = {k: getattr(self, k) for k in
             ("rid", "scenario", "steps", "frame_every", "overrides")}
        m.update({k: getattr(self, k) for k in _JOB_META_FIELDS})
        return m

    @classmethod
    def from_meta(cls, m: dict) -> "SimJob":
        job = cls(rid=m["rid"], scenario=m["scenario"], steps=m["steps"],
                  frame_every=m["frame_every"], overrides=m["overrides"])
        for k in _JOB_META_FIELDS:
            if k in m:
                setattr(job, k, m[k])
        return job


def _read_lane(state, lane: int) -> torch.Tensor:
    """Lane ``lane`` of a lane stack, whole (a view of a tensor stack)."""
    if isinstance(state, ShardedPlanes):
        return state.read_lane(lane)
    return state[lane]


def _write_lane(state, lane: int, planes) -> None:
    """Overwrite lane ``lane`` in place with ``planes`` (or a number)."""
    if isinstance(state, ShardedPlanes):
        state.write_lane(lane, planes)
    else:
        state[lane] = planes


def _host_words(planes) -> np.ndarray:
    """A host uint32 copy of int32 bit-view planes, never a view of them
    (the lane it came from is zeroed or overwritten later)."""
    if isinstance(planes, ShardedPlanes):
        planes = planes.gather(torch.device("cpu"))
    elif planes.device.type == "cpu":
        planes = planes.clone()
    return carry.planes_to_reference(planes)


def _tiles(state) -> List[torch.Tensor]:
    if isinstance(state, ShardedPlanes):
        return [t for row in state.tiles for t in row]
    return [state]


def _synchronize(state) -> None:
    """Wait for the card(s) holding ``state``."""
    for dev in {t.device for t in _tiles(state)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _state_invariants(spec, state):
    """``(invariants, structural-ok)`` of every lane as host arrays,
    recomputed from a lane stack (popcounts add up over shards)."""
    inv: Dict[str, np.ndarray] = {}
    ok = None
    for t in _tiles(state):
        for k, v in rulespec.invariants(
                spec, t, with_momentum=spec.conserves_momentum).items():
            inv[k] = inv.get(k, 0) + v.cpu().numpy()
        o = rulespec.integrity_ok(spec, t).cpu().numpy()
        ok = o if ok is None else ok & o
    return inv, ok


class _LaneGroup:
    """One batched lane stack: every live job of one ``(rule, p_force)``
    shares the runner and the ``(B, n_planes, H, Wd)`` state."""

    def __init__(self, engine: "CAServeEngine", variant: str,
                 p_force: float):
        self.variant, self.p_force = variant, p_force
        self.spec = rulespec.get_rule(variant)
        self.slots: List[Optional[SimJob]] = [None] * engine.slots
        self.run, self.sharding = distributed.make_ensemble_run(
            engine.mesh, engine.round_steps, variant=variant,
            p_force=p_force, depth=engine.depth,
            steps_per_launch=engine.steps_per_launch,
            y_axes=engine.y_axes, x_axis=engine.x_axis,
            moments_every=engine.round_steps)
        self.mspec = rulespec.moment_spec(self.spec)
        # End-of-round fused moments, (slots, n_moments) int32 on host.
        # ``moments_dirty`` flags moments that predate an injected state
        # corruption -- the audit must recompute from the state then.
        self.last_moments: Optional[np.ndarray] = None
        self.moments_dirty = False
        shape = (engine.slots, self.spec.n_planes, engine.height,
                 engine.width // 32)
        zeros = torch.zeros(shape, dtype=torch.int32, device=engine.device)
        self.state = (zeros if self.sharding is None
                      else self.sharding.place(zeros))

    def live_jobs(self) -> List[SimJob]:
        return [j for j in self.slots if j is not None]

    def key(self) -> str:
        return f"{self.variant}|{self.p_force}"


class CAServeEngine:
    """The continuous-batching CA job engine (see module docstring).

    ``depth`` CA steps advance per round (one halo exchange on a mesh);
    ``audit_every`` / ``ckpt_every`` are in rounds, and checkpoints are
    only taken on audited-clean rounds (``ckpt_every`` must be a
    multiple of ``audit_every``).  ``mesh=None`` runs single-device, on
    ``device``; with a :class:`~repro_torch.core.distributed.Mesh` the
    lanes lie on its slots (and lattices are built on its first slot's
    device).

    Overload knobs: ``tenants`` maps name ->
    :class:`~repro_torch.serve.admission.TenantConfig` (omit for the
    unlimited single-tenant legacy behaviour); ``round_budget_s`` arms
    the degradation path (overload shedding + cadence stretch);
    ``max_preemptions`` bounds how often one job may be parked (so
    preemption cannot starve the low class it protects against);
    ``starvation_rounds`` is the aging guard's promotion threshold.
    """

    def __init__(self, *, height: int, width: int, slots: int = 4,
                 mesh=None, y_axes=("data",), x_axis: str = "model",
                 depth: int = 2, steps_per_launch: Optional[int] = None,
                 device="cuda", audit_every: int = 1,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 keep: int = 4, max_retries: int = 2, injector=None,
                 telemetry=None, tenants=None,
                 round_budget_s: Optional[float] = None,
                 max_preemptions: int = 2, max_preempt_per_round: int = 1,
                 starvation_rounds: int = 8, stretch_rounds: int = 4):
        if height % 2 or width % 32:
            raise ValueError(f"lattice {height} x {width}: the height must "
                             f"be even and the width a multiple of 32")
        if audit_every < 1 or ckpt_every % audit_every:
            raise ValueError(f"ckpt_every={ckpt_every} must be a multiple "
                             f"of audit_every={audit_every} >= 1: "
                             f"checkpoints land on audit rounds (audited "
                             f"anchors only)")
        self.height, self.width, self.slots = height, width, slots
        self.mesh, self.y_axes, self.x_axis = mesh, y_axes, x_axis
        self.depth = depth
        self.round_steps = depth        # CA steps per engine round
        self.steps_per_launch = steps_per_launch
        self.device = (torch.device(device) if mesh is None
                       else mesh.devices.flat[0])
        self.audit_every, self.ckpt_every = audit_every, ckpt_every
        self.ckpt_dir, self.keep = ckpt_dir, keep
        self.max_retries = max_retries
        self.injector = injector
        self.tel = telemetry if telemetry is not None \
            else _telemetry.default()
        self.round = 0                  # completed rounds
        self.jobs: Dict[int, SimJob] = {}
        self.groups: Dict[str, _LaneGroup] = {}
        self._retries: Dict[int, int] = {}   # survives rollback on purpose
        self._round_inv: Dict[str, tuple] = {}   # per-round audit cache
        self.detections: List[dict] = []
        self.frame_log: List[dict] = []
        self.rejections: List[dict] = []     # typed admission refusals
        self.shed_log: List[dict] = []       # typed load sheds
        self.stats = {"rounds": 0, "audits": 0, "audit_failures": 0,
                      "rollbacks": 0, "quarantined": 0, "jobs_done": 0,
                      "steps_replayed": 0, "recovery": [],
                      "rejected": 0, "shed": 0, "preemptions": 0,
                      "resumed": 0, "deadline_miss": 0,
                      "frame_slo_violations": 0, "stragglers_detected": 0,
                      "overloaded_rounds": 0, "frames_deferred": 0,
                      "ckpts_stretched": 0, "storm_submitted": 0,
                      "storm_rejected": 0}
        # --- admission / fairness / degradation ---
        cfgs: Dict[str, _adm.TenantConfig] = {}
        if tenants:
            for cfg in (tenants.values() if isinstance(tenants, dict)
                        else tenants):
                cfgs[cfg.name] = cfg
        self._strict_tenants = bool(cfgs)
        if not cfgs:
            cfgs = {"default": _adm.TenantConfig("default")}
        self.sched = _adm.FairScheduler(cfgs)
        self.model = _adm.RoundTimeModel(modeled_s=self._modeled_round_s())
        self.admission = _adm.AdmissionController(self.sched, self.model)
        self.round_budget_s = round_budget_s
        self.max_preemptions = int(max_preemptions)
        self.max_preempt_per_round = int(max_preempt_per_round)
        self.starvation_rounds = int(starvation_rounds)
        self.stretch_rounds = int(stretch_rounds)
        self._overloaded_until = -1
        self._round_walls: List[float] = []
        self._last_frame_wall: Dict[int, float] = {}

    # ------------------------------------------------------------------
    # Submission / admission
    # ------------------------------------------------------------------

    @property
    def queue(self) -> List[int]:
        """Ordered queued rids (read-only snapshot across the per-tenant
        fair-scheduler queues)."""
        return self.sched.rids()

    def _modeled_round_s(self) -> float:
        """Roofline seed for the round-time model: the sharded-traffic
        model's total cost over this engine's lattice for one ``depth``
        round, on the H100's datasheet rates.  A lower bound of a round
        on the card (and far below one on the CPU) -- exactly what a
        *provable* infeasibility test wants before the first measured
        round replaces it."""
        from repro_torch.roofline import analysis
        t = max(int(self.steps_per_launch or 1), 1)
        terms = analysis.sharded_fhp_traffic(
            self.height, self.width // 32, depth=self.depth,
            T=min(t, self.height), block_rows=self.height)
        return (terms["total_s_per_site"] * self.height * self.width
                * self.depth)

    def _job_rounds(self, job: SimJob) -> int:
        return -(-max(job.steps - job.steps_done, 0) // self.round_steps)

    def _log_reject(self, job: SimJob, err: _adm.AdmissionError) -> None:
        self.stats["rejected"] += 1
        rec = dict(err.to_record(), round=self.round, wall=time.time())
        self.rejections.append(rec)
        self.tel.event("serve.reject", **rec)

    def submit(self, job: SimJob) -> SimJob:
        """Admit ``job`` to its tenant's queue, or refuse with a typed
        :class:`~repro.serve.admission.AdmissionError` (rate limit,
        queue bound, or provably-unmeetable deadline).  Refused jobs are
        never entered in the engine's bookkeeping."""
        if job.rid in self.jobs:
            raise ValueError(f"duplicate rid {job.rid}")
        tenant = job.tenant or "default"
        if self._strict_tenants and tenant not in self.sched.tenants:
            err = _adm.UnknownTenant(f"unknown tenant {tenant!r}",
                                     tenant=tenant, rid=job.rid)
            self._log_reject(job, err)
            raise err
        cfg = self.sched.ensure(tenant)
        if job.frame_slo_s is None:
            job.frame_slo_s = cfg.frame_slo_s
        try:
            self.admission.check(tenant=tenant, rid=job.rid,
                                 rounds=self._job_rounds(job),
                                 deadline_s=job.deadline_s)
        except _adm.AdmissionError as err:
            self._log_reject(job, err)
            raise
        job.submitted_wall = time.monotonic()
        job.enqueued_round = self.round
        self.jobs[job.rid] = job
        self.sched.enqueue(tenant, job.rid)
        return job

    def _alloc_rid(self) -> int:
        return max(self.jobs, default=-1) + 1

    def _scenario(self, job: SimJob):
        from repro_torch import scenarios
        return scenarios.get(job.scenario, height=self.height,
                             width=self.width, **job.overrides)

    def _group_for(self, sc) -> _LaneGroup:
        key = f"{sc.variant}|{sc.p_force}"
        if key not in self.groups:
            self.groups[key] = _LaneGroup(self, sc.variant, sc.p_force)
        return self.groups[key]

    # ------------------------------------------------------------------
    # Shedding and degradation
    # ------------------------------------------------------------------

    def _shed(self, job: SimJob, reason: str) -> None:
        self.sched.remove(job.rid)
        job.status, job.shed_reason = SHED, reason
        self.stats["shed"] += 1
        rec = {"rid": job.rid, "tenant": job.tenant, "reason": reason,
               "round": self.round}
        self.shed_log.append(rec)
        self.tel.event("serve.shed", **rec)

    def _shed_unmeetable(self, now: float) -> None:
        """Shed queued jobs whose deadline is provably lost: elapsed
        wait plus the model's zero-queue best case already exceeds it.
        Parked jobs are exempt -- they hold completed (audited) work."""
        for rid in list(self.sched.rids()):
            job = self.jobs[rid]
            if job.deadline_s is None or job.status == PARKED:
                continue
            best = ((now - job.submitted_wall)
                    + self.model.best_case_s(self._job_rounds(job)))
            if best > job.deadline_s:
                self._shed(job, "deadline_unmeetable")

    def _stretching(self) -> bool:
        return (self.round_budget_s is not None
                and self.round <= self._overloaded_until)

    def _shed_overload(self) -> None:
        """Under a breached round budget with backlog beyond one wave of
        lanes, drop the *newest* queued job of the lowest backlogged
        priority class (one per round: bounded churn; oldest work and
        parked jobs survive, and with multiple priority classes the top
        class is never overload-shed -- it is who the shedding
        protects)."""
        cands = [rid for rid in self.sched.rids()
                 if self.jobs[rid].status == QUEUED]
        if not cands or len(self.sched) <= self.slots:
            return
        prio = lambda rid: self.sched.tenants[self.jobs[rid].tenant].priority
        prios = {cfg.priority for cfg in self.sched.tenants.values()}
        if len(prios) > 1:
            cands = [r for r in cands if prio(r) < max(prios)]
            if not cands:
                return
        low = min(prio(r) for r in cands)
        victim = max((r for r in cands if prio(r) == low),
                     key=lambda r: (self.jobs[r].enqueued_round, r))
        self._shed(self.jobs[victim], "overload")

    def _observe_round(self, dt: float) -> None:
        """Feed the round-time model; flag stragglers (wall >> rolling
        median); arm the degradation window on a budget breach."""
        self.model.observe(dt)
        prev = self._round_walls[-16:]
        self._round_walls.append(dt)
        del self._round_walls[:-64]
        if len(prev) >= 4:
            med = sorted(prev)[len(prev) // 2]
            if dt > max(3.0 * med, med + 1e-3):
                self.stats["stragglers_detected"] += 1
                self.tel.event("serve.straggler", round=self.round,
                               round_s=dt, median_s=med)
        if self.round_budget_s is not None and dt > self.round_budget_s:
            self.stats["overloaded_rounds"] += 1
            self._overloaded_until = max(self._overloaded_until,
                                         self.round + self.stretch_rounds)
            self.tel.event("serve.overload", round=self.round, round_s=dt,
                           budget_s=self.round_budget_s)

    # ------------------------------------------------------------------
    # Fair admission at round boundaries
    # ------------------------------------------------------------------

    def _admit(self):
        """Fill free lanes from the tenant queues at this round
        boundary: shed unmeetable work, then attempt admission in
        priority + deficit-round-robin order (aged jobs first).  A job
        whose lane group is full may preempt a strictly-lower-priority
        lane (audited boundaries only); otherwise it keeps its queue
        position without blocking jobs bound for other groups."""
        self._shed_unmeetable(time.monotonic())
        if self._stretching():
            self._shed_overload()
        if not len(self.sched):
            return
        cost = lambda rid: float(max(self._job_rounds(self.jobs[rid]), 1))
        aged = sorted(
            (rid for rid in self.sched.rids()
             if (self.round - self.jobs[rid].enqueued_round)
             >= self.starvation_rounds),
            key=lambda rid: (self.jobs[rid].enqueued_round, rid))
        order = self.sched.order(cost, aged=aged)
        preempted = 0
        leftover: List[Tuple[str, int]] = []
        for rid in order:
            job = self.jobs[rid]
            sc = self._scenario(job)
            g = self._group_for(sc)
            free = [i for i, s in enumerate(g.slots) if s is None]
            if not free and preempted < self.max_preempt_per_round:
                victim = self._pick_victim(job, g)
                if victim is not None:
                    free = [self._preempt(victim, g)]
                    preempted += 1
            if not free:
                leftover.append((job.tenant, rid))
                self.sched.refund(job.tenant, cost(rid))
                continue
            self._place_job(job, g, free[0], sc)
        for tenant in {t for t, _ in leftover}:
            self.sched.requeue_front(
                tenant, [r for t, r in leftover if t == tenant])

    def _pick_victim(self, job: SimJob,
                     g: _LaneGroup) -> Optional[SimJob]:
        """A running lane ``job`` may displace: strictly lower priority
        class, preemption budget left, and only at a boundary the audit
        has certified (the parked lattice must be known-good -- it is
        the job's resume anchor)."""
        if self.round % self.audit_every != 0:
            return None
        p = self.sched.tenants[job.tenant].priority
        prio = lambda j: self.sched.tenants[j.tenant].priority
        cands = [j for j in g.live_jobs()
                 if prio(j) < p and j.preemptions < self.max_preemptions]
        if not cands:
            return None
        return min(cands, key=lambda j: (prio(j), -self._job_rounds(j),
                                         -j.rid))

    def _preempt(self, victim: SimJob, g: _LaneGroup) -> int:
        """Park ``victim``: host-checkpoint its lattice (audited-clean
        by construction of the call site), zero and free the lane, and
        requeue it at the head of its tenant queue for prompt resume."""
        lane = victim.lane
        victim.parked_state = _host_words(_read_lane(g.state, lane))
        _write_lane(g.state, lane, 0)
        g.slots[lane] = None
        g.last_moments = None
        self._round_inv.pop(g.key(), None)
        victim.status, victim.lane = PARKED, -1
        victim.preemptions += 1
        victim.enqueued_round = self.round
        self.stats["preemptions"] += 1
        self.sched.enqueue(victim.tenant, victim.rid, front=True)
        self.tel.event("serve.preempt", rid=victim.rid, round=self.round,
                       steps_done=victim.steps_done, tenant=victim.tenant)
        return lane

    def _place_job(self, job: SimJob, g: _LaneGroup, lane: int, sc):
        """Admit into ``lane``: fresh jobs record their invariants;
        parked jobs resume from their bit-exact parked lattice in a new
        ``(t0, steps)`` segment."""
        t = self.round * self.round_steps
        if job.status == PARKED and job.parked_state is not None:
            planes = carry.planes_from_reference(job.parked_state,
                                                 self.device)
            job.parked_state = None
            self.stats["resumed"] += 1
            self.tel.event("serve.resume", rid=job.rid, round=self.round,
                           steps_done=job.steps_done)
        else:
            planes = sc.initial_planes(device=self.device)
            job.admitted_t = t
            job.steps_done = 0
            job.segments = []
            spec = g.spec
            # Momentum is only conserved on a free torus without forcing.
            job.with_momentum = bool(
                spec.conserves_momentum and sc.p_force == 0.0
                and not sc.solid_mask().any())
            inv = rulespec.invariants(spec, planes,
                                      with_momentum=job.with_momentum)
            job.expected = {k: v.cpu().tolist() for k, v in inv.items()}
        _write_lane(g.state, lane, planes)
        job.status, job.lane = RUNNING, lane
        job.segments.append([t, 0])
        g.slots[lane] = job

    # ------------------------------------------------------------------
    # The round loop
    # ------------------------------------------------------------------

    def tick(self):
        """One engine round: (maybe) crash/straggle/storm, admit (with
        shedding and preemption), advance every live group ``depth``
        steps (collecting the end-of-round fused moments), inject state
        faults, audit, recover or stream/retire/checkpoint."""
        rnd = self.round
        tel = self.tel
        t_wall = time.monotonic()
        try:
            with tel.span("serve.round", round=rnd):
                self._tick_body(rnd, tel)
        finally:
            self._observe_round(time.monotonic() - t_wall)

    def _tick_body(self, rnd: int, tel):
        if self.injector is not None:
            self.injector.before_round(rnd)  # may raise SimulatedCrash
            self._storm(rnd)
        with tel.span("serve.admit"):
            self._admit()
        t = rnd * self.round_steps
        for g in self.groups.values():
            if not g.live_jobs():
                continue
            with tel.span("serve.kernel", group=g.key(),
                          steps=self.round_steps):
                state, mom = g.run(g.state, t)
                if tel.enabled:     # so the span times the device
                    _synchronize(state)
            g.state = state
            g.last_moments = carry.moments_to_reference(mom[..., -1, :])
            g.moments_dirty = False
            if self.injector is not None and self.injector.corrupt(
                    g.state, g.variant, rnd,
                    lanes_by_rid={j.rid: j.lane for j in g.live_jobs()}):
                # The fused moments predate this corruption: the audit
                # must recompute from the state this round.
                g.moments_dirty = True
        self.round = rnd + 1
        self.stats["rounds"] += 1
        for g in self.groups.values():
            for job in g.live_jobs():
                job.steps_done += self.round_steps
                job.segments[-1][1] += self.round_steps

        self._round_inv = {}
        if self.round % self.audit_every == 0:
            with tel.span("serve.audit"):
                violations = self._audit()
            self.stats["audits"] += 1
            if violations:
                self.stats["audit_failures"] += 1
                with tel.span("serve.rollback"):
                    self._recover(violations)
                return
        with tel.span("serve.frames"):
            self._stream_frames()
        with tel.span("serve.retire"):
            self._retire()
        if self.ckpt_dir and self.ckpt_every:
            every = self.ckpt_every * (2 if self._stretching() else 1)
            if self.round % every == 0:
                with tel.span("serve.checkpoint", round=self.round):
                    self._checkpoint()
            elif (self._stretching()
                  and self.round % self.ckpt_every == 0):
                self.stats["ckpts_stretched"] += 1

    def _storm(self, rnd: int) -> None:
        """Submit this round's burst-storm jobs through the *public*
        admission path: typed rejections are the expected outcome under
        a storm -- that is the backpressure the fault exercises."""
        storm = getattr(self.injector, "storm", None)
        if storm is None:
            return
        for spec in storm(rnd):
            job = SimJob(rid=self._alloc_rid(),
                         scenario=spec.get("scenario", "cylinder"),
                         steps=int(spec.get("steps", 8)),
                         frame_every=int(spec.get("frame_every", 0)),
                         overrides={"seed": int(spec.get("seed", 0))},
                         tenant=spec.get("tenant") or "default",
                         deadline_s=spec.get("deadline_s"))
            try:
                self.submit(job)
                self.stats["storm_submitted"] += 1
            except _adm.AdmissionError:
                self.stats["storm_rejected"] += 1  # logged by submit

    def drain(self, max_rounds: int = 10_000) -> List[SimJob]:
        """Run rounds until every submitted job is done, shed, or
        quarantined; raise :class:`DrainTimeout` (carrying the stuck
        rids and queue depth) if the cap is hit with work in flight."""
        rounds = 0
        while (len(self.sched) or any(g.live_jobs()
                                      for g in self.groups.values())):
            if rounds >= max_rounds:
                stuck = sorted(j.rid for j in self.jobs.values()
                               if j.status in (QUEUED, RUNNING, PARKED))
                raise DrainTimeout(stuck, len(self.sched), rounds)
            self.tick()
            rounds += 1
        return [j for j in self.jobs.values() if j.status == DONE]

    def metrics(self) -> dict:
        """Operational counters plus the SLO block and the telemetry
        span rollup -- the ``metrics`` block the serve benchmarks record
        and a scrape endpoint would export."""
        out = {k: v for k, v in self.stats.items() if k != "recovery"}
        out["round"] = self.round
        out["detections"] = len(self.detections)
        out["frames"] = len(self.frame_log)
        out["queue_depth"] = len(self.sched)
        out["slo"] = self.slo_report()
        if self.tel.enabled:
            out["telemetry"] = self.tel.summary()
        return out

    def slo_report(self) -> dict:
        """Per-tenant SLO accounting: throughput (done / shed / rejected
        / work steps), deadline misses, frame-gap percentiles, and the
        Jain fairness index over weight-normalised completed work."""
        per: Dict[str, dict] = {}

        def bucket(t: str) -> dict:
            return per.setdefault(t, {
                "submitted": 0, "done": 0, "shed": 0, "quarantined": 0,
                "live": 0, "rejected": 0, "work_done_steps": 0,
                "deadline_miss": 0, "frame_slo_violations": 0,
                "preemptions": 0, "frame_gap_p50_s": None,
                "frame_gap_p99_s": None})

        for job in self.jobs.values():
            d = bucket(job.tenant)
            d["submitted"] += 1
            d["preemptions"] += job.preemptions
            d["frame_slo_violations"] += job.frame_slo_violations
            if job.status == DONE:
                d["done"] += 1
                d["work_done_steps"] += job.steps
                if job.deadline_met is False:
                    d["deadline_miss"] += 1
            elif job.status == SHED:
                d["shed"] += 1
            elif job.status == QUARANTINED:
                d["quarantined"] += 1
            else:
                d["live"] += 1
                d["work_done_steps"] += job.steps_done
        for rec in self.rejections:
            bucket(rec.get("tenant") or "default")["rejected"] += 1
        gaps: Dict[str, List[float]] = {}
        last: Dict[int, float] = {}
        for e in self.frame_log:
            rid = e["rid"]
            job = self.jobs.get(rid)
            if job is None:
                continue
            if rid in last:
                gaps.setdefault(job.tenant, []).append(
                    e["wall"] - last[rid])
            last[rid] = e["wall"]
        for t, gs in gaps.items():
            gs = sorted(gs)
            n = len(gs)
            per[t]["frame_gap_p50_s"] = gs[(n - 1) // 2]
            per[t]["frame_gap_p99_s"] = gs[min(n - 1, (99 * n) // 100)]
        active = [t for t, d in per.items() if d["submitted"]]
        fair = _adm.jain_index(
            [per[t]["work_done_steps"]
             / max(self.sched.tenants[t].weight, 1e-9)
             if t in self.sched.tenants else per[t]["work_done_steps"]
             for t in active])
        return {"tenants": per, "jain_fairness": fair,
                "round_s_model": self.model.round_s(),
                "round_s_measured_n": self.model.n_observed}

    # ------------------------------------------------------------------
    # Audits and recovery
    # ------------------------------------------------------------------

    def _group_inv(self, g: _LaneGroup):
        """``(invariants dict of per-lane np arrays, structural-ok bool
        array)`` for one group, cached per round so the audit and the
        frame stream share a single computation.

        When the end-of-round fused moments are current, they *are* the
        invariants (mass / per-plane / solid / momentum rows) and the
        exclusivity rows double as the structural integrity check -- no
        state is touched.  When injected corruption postdates them (or
        no round has advanced this group yet), fall back to the post-hoc
        popcount path on the live state."""
        key = g.key()
        cached = self._round_inv.get(key)
        if cached is not None:
            return cached
        if g.last_moments is not None and not g.moments_dirty:
            mom = g.last_moments
            inv = {n: mom[..., r] for r, n in enumerate(g.mspec.names)}
            ok_struct = np.ones(mom.shape[:-1], bool)
            for name in [n for n in inv if n.startswith("excl")]:
                ok_struct = ok_struct & (inv.pop(name) == 0)
            self.tel.count("serve.audit.fused")
        else:
            inv, ok_struct = _state_invariants(g.spec, g.state)
            self.tel.count("serve.audit.recomputed")
        self._round_inv[key] = (inv, ok_struct)
        return inv, ok_struct

    def _audit(self) -> List[dict]:
        """Per-lane invariant audit of every live job; returns the
        violation records (empty == clean)."""
        out = []
        for g in self.groups.values():
            jobs = g.live_jobs()
            if not jobs:
                continue
            inv, ok_struct = self._group_inv(g)
            for job in jobs:
                bad = {}
                for name, want in job.expected.items():
                    if name in ("px2", "py") and not job.with_momentum:
                        continue
                    got = inv[name][job.lane]
                    if not np.array_equal(np.asarray(want), got):
                        bad[name] = (want, np.asarray(got).tolist())
                if not bool(ok_struct[job.lane]):
                    bad["integrity"] = (True, False)
                if bad:
                    out.append({"round": self.round, "rule": g.variant,
                                "lane": job.lane, "rid": job.rid,
                                "violations": bad})
        return out

    def _recover(self, violations: List[dict]):
        """Bounded-retry rollback; quarantine jobs that keep faulting."""
        t0 = time.perf_counter()
        self.detections.extend(violations)
        flagged = {v["rid"] for v in violations}
        self.tel.event("serve.detection", critical=True,
                       round=self.round, rids=sorted(flagged))
        quarantine = set()
        for rid in flagged:
            self._retries[rid] = self._retries.get(rid, 0) + 1
            if self._retries[rid] > self.max_retries:
                quarantine.add(rid)
        retry = flagged - quarantine
        if retry:
            anchor = (store.latest_valid_step(self.ckpt_dir)
                      if self.ckpt_dir else None)
            if anchor is None:
                # No audited checkpoint to roll back to: restart the
                # offending jobs from their initial state (counts as the
                # retry; healthy lanes are untouched).
                for rid in retry:
                    self._restart_job(self.jobs[rid])
            else:
                detected_at = self.round
                self._restore_from(anchor)
                lost = (detected_at - self.round) * self.round_steps
                self.stats["rollbacks"] += 1
                self.stats["steps_replayed"] += lost
                self.stats["recovery"].append(
                    {"detected_round": detected_at,
                     "restored_round": self.round, "steps_lost": lost,
                     "restore_s": time.perf_counter() - t0})
                self.tel.event("serve.rollback", critical=True,
                               detected_round=detected_at,
                               restored_round=self.round, steps_lost=lost)
        # Quarantine *after* any rollback, so the restored bookkeeping
        # cannot resurrect a job retired for repeated faults.
        for rid in quarantine:
            job = self.jobs[rid]
            if job.status == RUNNING:
                self._quarantine(job)
            else:
                self.sched.remove(rid)
                job.status = QUARANTINED
                self.stats["quarantined"] += 1
                self.tel.event("serve.quarantine", critical=True, rid=rid,
                               round=self.round)

    def _quarantine(self, job: SimJob):
        g = self._group_for(self._scenario(job))
        _write_lane(g.state, job.lane, 0)
        g.slots[job.lane] = None
        g.last_moments = None
        self._round_inv.pop(g.key(), None)
        job.status, job.lane = QUARANTINED, -1
        self.stats["quarantined"] += 1
        self.tel.event("serve.quarantine", critical=True, rid=job.rid,
                       round=self.round)

    def _restart_job(self, job: SimJob):
        sc = self._scenario(job)
        g = self._group_for(sc)
        _write_lane(g.state, job.lane, sc.initial_planes(device=self.device))
        g.last_moments = None
        self._round_inv.pop(g.key(), None)
        job.admitted_t = self.round * self.round_steps
        job.steps_done = 0
        job.segments = [[job.admitted_t, 0]]
        job.frames.clear()

    # ------------------------------------------------------------------
    # Frames and retirement
    # ------------------------------------------------------------------

    def _stream_frames(self):
        from repro_torch.scenarios import observables
        if self._stretching() and self.round % 2 == 1:
            # Degradation: halve the observable cadence while the round
            # budget is breached -- deferred frames are counted, not
            # silently dropped.
            deferred = sum(
                1 for g in self.groups.values() for j in g.live_jobs()
                if j.frame_every and not j.steps_done % j.frame_every)
            if deferred:
                self.stats["frames_deferred"] += deferred
                self.tel.count("serve.frames_deferred", deferred)
            return
        t = self.round * self.round_steps
        for g in self.groups.values():
            due = [j for j in g.live_jobs() if j.frame_every
                   and not j.steps_done % j.frame_every]
            if not due:
                continue
            # The fused end-of-round moments (shared with the audit via
            # the per-round cache) replace the per-frame invariants
            # recomputation the engine used to do here.
            inv, _ = self._group_inv(g)
            for job in due:
                lane_inv = {k: v[job.lane] for k, v in inv.items()}
                frame = observables.frame_summary(
                    _read_lane(g.state, job.lane), g.spec, t, inv=lane_inv)
                frame["step"] = job.steps_done
                job.frames[job.steps_done] = frame
                self.tel.count("serve.frames")
                wall = time.perf_counter()
                prev = self._last_frame_wall.get(job.rid)
                self._last_frame_wall[job.rid] = wall
                if (prev is not None and job.frame_slo_s is not None
                        and wall - prev > job.frame_slo_s):
                    job.frame_slo_violations += 1
                    self.stats["frame_slo_violations"] += 1
                self.frame_log.append(
                    {"rid": job.rid, "round": self.round,
                     "wall": wall, "frame": frame,
                     "metrics": {"rollbacks": self.stats["rollbacks"],
                                 "quarantined": self.stats["quarantined"],
                                 "audits": self.stats["audits"]}})

    def _retire(self):
        for g in self.groups.values():
            for lane, job in enumerate(g.slots):
                if job is None or job.steps_done < job.steps:
                    continue
                first_finish = job.result is None
                job.result = _host_words(_read_lane(g.state, lane))
                job.status = DONE
                g.slots[lane] = None
                job.lane = -1
                _write_lane(g.state, lane, 0)
                if first_finish:    # replays re-retire; count jobs once
                    self.stats["jobs_done"] += 1
                    job.finished_wall = time.monotonic()
                    if job.deadline_s is not None:
                        job.deadline_met = (
                            job.finished_wall - job.submitted_wall
                            <= job.deadline_s)
                        if not job.deadline_met:
                            self.stats["deadline_miss"] += 1
                            self.tel.event("serve.deadline_miss",
                                           rid=job.rid, tenant=job.tenant)

    # ------------------------------------------------------------------
    # Checkpoint / restore
    # ------------------------------------------------------------------

    def _parked_jobs(self) -> List[SimJob]:
        return [j for j in self.jobs.values()
                if j.status == PARKED and j.parked_state is not None]

    def _meta(self) -> dict:
        return {"round": self.round,
                "engine": {"height": self.height, "width": self.width,
                           "slots": self.slots, "depth": self.depth,
                           "tenants": {n: dataclasses.asdict(c)
                                       for n, c in
                                       self.sched.tenants.items()}},
                "groups": {k: {"variant": g.variant, "p_force": g.p_force}
                           for k, g in self.groups.items()},
                "jobs": [j.to_meta() for j in self.jobs.values()],
                "queue": self.sched.rids(),
                # Lifetime counters survive process death: ``resume``
                # seeds from here, so rollbacks/quarantines/jobs_done
                # report true totals, not since-restart ones.
                "stats": {k: v for k, v in self.stats.items()
                          if not isinstance(v, list)}}

    def _checkpoint(self):
        tree = {"groups": {k: _host_words(g.state)
                           for k, g in self.groups.items()}}
        parked = self._parked_jobs()
        if parked:
            # Parked lattices are checkpoint *leaves* (crc32-verified),
            # so a preempted job survives process death too.
            tree["parked"] = {str(j.rid): j.parked_state for j in parked}
        path = store.save(self.ckpt_dir, self.round, tree,
                          meta=self._meta(), overwrite=True)
        if self.injector is not None:
            self.injector.after_checkpoint(path, self.round)
        self._gc_checkpoints()

    def _gc_checkpoints(self):
        steps = store._steps(self.ckpt_dir)
        import shutil
        for s in steps[:-self.keep]:
            shutil.rmtree(store.step_dir(self.ckpt_dir, s),
                          ignore_errors=True)

    def _restore_from(self, step: int):
        """Reset lattice states and job bookkeeping to checkpoint
        ``step``; retry counters and detection logs survive on purpose
        (they drive quarantine)."""
        meta = store.load_meta(self.ckpt_dir, step)
        target = {"groups": {k: g.state for k, g in self.groups.items()}}
        shardings = None
        if self.mesh is not None:
            shardings = {"groups": {k: g.sharding
                                    for k, g in self.groups.items()}}
        # strict=False: the checkpoint may carry parked-lattice leaves
        # beyond the groups tree; they are loaded individually below.
        restored = store.restore(self.ckpt_dir, step, target, shardings,
                                 strict=False)
        for k, g in self.groups.items():
            g.state = restored["groups"][k]
            g.slots = [None] * self.slots
            g.last_moments = None
        self._round_inv = {}
        self.round = meta["round"]
        by_rid = {m["rid"]: m for m in meta["jobs"]}
        self.sched.clear()
        for rid in meta["queue"]:
            m = by_rid.get(rid)
            tenant = m["tenant"] if m else self.jobs[rid].tenant
            self.sched.enqueue(tenant, rid)
        for rid, job in sorted(self.jobs.items()):
            m = by_rid.get(rid)
            if m is None:
                # Submitted after the checkpoint: back to the queue.
                job.status, job.lane = QUEUED, -1
                job.steps_done = 0
                job.segments = []
                job.parked_state = None
                job.enqueued_round = self.round
                job.frames.clear()
                self.sched.enqueue(job.tenant, rid)
                continue
            for k in _JOB_META_FIELDS:
                if k in m:
                    setattr(job, k, m[k])
            job.parked_state = (
                store.load_leaf(self.ckpt_dir, step, f"parked/{rid}")
                if job.status == PARKED else None)
            if job.status == RUNNING:
                g = self.groups[self._job_group_key(rid)]
                g.slots[job.lane] = job
                # Replay re-streams frames past the anchor bit-exactly;
                # stale ones (t beyond the anchor) are dropped.
                job.frames = {s: f for s, f in job.frames.items()
                              if s <= job.steps_done}

    def _job_group_key(self, rid: int) -> str:
        sc = self._scenario(self.jobs[rid])
        return f"{sc.variant}|{sc.p_force}"

    @classmethod
    def resume(cls, ckpt_dir: str, *, mesh=None, injector=None,
               **kw) -> "CAServeEngine":
        """Rebuild a crashed engine from the last *valid* checkpoint in
        ``ckpt_dir`` (torn/corrupt ones are skipped).  Jobs that were
        queued resume queued, parked jobs resume parked (their lattices
        are checkpoint leaves), running jobs replay from the audited
        anchor bit-exactly, and the lifetime ``stats`` counters carry
        over.  Deadline clocks restart at resume (the monotonic epoch
        does not survive the process)."""
        step = store.latest_valid_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
        meta = store.load_meta(ckpt_dir, step)
        e = meta["engine"]
        if "tenants" not in kw and e.get("tenants"):
            kw["tenants"] = {n: _adm.TenantConfig(**c)
                             for n, c in e["tenants"].items()}
        eng = cls(height=e["height"], width=e["width"], slots=e["slots"],
                  depth=e["depth"], mesh=mesh, ckpt_dir=ckpt_dir,
                  injector=injector, **kw)
        for k, v in meta.get("stats", {}).items():
            if k in eng.stats and not isinstance(eng.stats[k], list):
                eng.stats[k] = v
        now = time.monotonic()
        for m in meta["jobs"]:
            job = SimJob.from_meta(m)
            job.submitted_wall = now
            eng.jobs[job.rid] = job
        for k, ginfo in meta["groups"].items():
            eng.groups[k] = _LaneGroup(eng, ginfo["variant"],
                                       ginfo["p_force"])
        target = {"groups": {k: g.state for k, g in eng.groups.items()}}
        shardings = ({"groups": {k: g.sharding
                                 for k, g in eng.groups.items()}}
                     if mesh is not None else None)
        restored = store.restore(ckpt_dir, step, target, shardings,
                                 strict=False)
        for k, g in eng.groups.items():
            g.state = restored["groups"][k]
        eng.round = meta["round"]
        for rid in meta["queue"]:
            eng.sched.enqueue(eng.jobs[rid].tenant, rid)
        for job in eng.jobs.values():
            if job.status == RUNNING:
                eng.groups[eng._job_group_key(job.rid)].slots[job.lane] = job
            elif job.status == PARKED:
                job.parked_state = store.load_leaf(
                    ckpt_dir, step, f"parked/{job.rid}")
        return eng
