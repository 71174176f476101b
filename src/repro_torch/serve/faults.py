"""Deterministic fault injection for the CA serve engine.

The counterpart of ``repro/serve/faults.py``: the same faults, schedule
and counter-keyed draws, so the same schedule corrupts the same bits and
records the same ``events`` in both packages.  State faults write into the
lane stack where it lies (the port holds lattices as int32 bit-views of
the reference's uint32 words) instead of corrupting a host copy.

Long SIMD/GPU runs hit silent corruption -- flipped bits in a resident
lattice, a shard garbaged by a bad DMA, a checkpoint torn mid-write, a
killed worker, a slow interconnect hop.  This module makes those failure
modes *reproducible*: a :class:`Fault` names a kind, a firing round, and
a seed; a :class:`FaultInjector` holds a schedule and fires each fault
deterministically from its own counter-based RNG, so two runs with the
same schedule corrupt the same bits in the same round -- which is what
lets tests assert "every injected corruption was detected and the
recovered run is bit-identical to a fault-free one".

Kinds:

* ``bitflip``         -- XOR ``bits`` random bits into one plane of one
                         lane (mass changes by ±1 per bit: the minimal
                         detectable corruption; an *odd* count is
                         guaranteed to trip a popcount invariant, an
                         even count can compensate -- schedules default
                         to odd);
* ``nan_shard``       -- fill a band of rows of one lane with the
                         float32-NaN bit pattern ``0x7FC00000`` (a
                         garbaged shard / bad DMA: gross corruption);
* ``torn_checkpoint`` -- truncate one leaf ``.npy`` of the checkpoint
                         just published (a crash mid-write; detected by
                         ``latest_valid_step``'s checksum walk, never by
                         the lattice audits);
* ``killed_step``     -- raise :class:`SimulatedCrash` before the round
                         runs (process death; recovery = resume from the
                         last valid checkpoint);
* ``slow_exchange``   -- sleep ``delay_s`` before the round (a straggler
                         hop: hurts p99 frame latency, corrupts
                         nothing);
* ``burst_storm``     -- a client-side overload fault: submit ``jobs``
                         adversarial jobs through the engine's *public*
                         admission path at the firing round (typed
                         rejections are the expected -- and asserted --
                         outcome: this fault exercises backpressure, not
                         corruption);
* ``poison_pill``     -- a *persistent* per-job fault: flip bits in the
                         lane of one ``rid`` on **every** round it is
                         live, rollback-replays included.  No amount of
                         replay runs clean, which is exactly what drives
                         the bounded-retry / quarantine path without
                         collateral damage to co-batched lanes.

State-corrupting faults (``bitflip``, ``nan_shard``) fire **once** by
default and are consumed: the rollback-replay of the same rounds then
runs clean, exactly like a transient hardware fault.  ``sticky=True``
re-fires on every replay -- a *persistent* fault -- which is what drives
the engine's bounded-retry / quarantine path.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.distributed import ShardedPlanes

NAN_WORD = 0x7FC00000  # float32 quiet-NaN bit pattern, as a uint32 word

STATE_KINDS = ("bitflip", "nan_shard")
KINDS = STATE_KINDS + ("torn_checkpoint", "killed_step", "slow_exchange",
                       "burst_storm", "poison_pill")
# Kinds the lattice audits are expected to detect.
CORRUPT_KINDS = STATE_KINDS + ("poison_pill",)


def _word(w: int) -> int:
    """The int32 bit-view of the uint32 word ``w`` (bit 31 is the sign)."""
    return w - (1 << 32) if w >= 1 << 31 else w


class SimulatedCrash(RuntimeError):
    """Raised by a ``killed_step`` fault: the engine process 'dies' here."""


@dataclasses.dataclass
class Fault:
    """One scheduled fault.  ``round`` is the engine round index it fires
    at (state faults fire after the round's compute, before the audit);
    ``rule`` targets a lane group ("" = every live group is eligible,
    the injector picks deterministically); ``lane`` the ensemble lane.
    """

    kind: str
    round: int
    rule: str = ""
    lane: int = 0
    plane: int = 0
    bits: int = 1            # bitflip/poison_pill: how many bits to flip
    rows: int = 2            # nan_shard: height of the garbaged band
    delay_s: float = 0.0     # slow_exchange
    sticky: bool = False     # re-fire on replay (persistent fault)
    jobs: int = 0            # burst_storm: storm size
    tenant: str = ""         # burst_storm: tenant the storm submits as
    rid: int = -1            # poison_pill: the poisoned job
    seed: int = 0
    fired: int = 0           # times this fault has fired (bookkeeping)

    def __post_init__(self):
        assert self.kind in KINDS, self.kind

    def _rng(self) -> np.random.Generator:
        # Counter-based: the n-th firing of this fault draws the same
        # positions every run (seed x kind x round x firing count).
        return np.random.default_rng(
            (self.seed, KINDS.index(self.kind), self.round, self.fired))


@dataclasses.dataclass
class FaultEvent:
    """One firing, for post-hoc matching against engine detections."""
    kind: str
    round: int
    rule: str
    lane: int
    detail: dict


class FaultInjector:
    """Drives a fault schedule against the serve engine's hook points.

    The engine calls ``before_round`` at the top of each round (crash /
    straggler faults), ``corrupt`` on each group's post-step state
    (state faults, in place), and ``after_checkpoint`` on each published
    checkpoint path (torn-write faults).  ``events`` records every
    firing; ``consumed`` one-shot faults never re-fire, so replayed
    rounds run clean."""

    def __init__(self, schedule: Sequence[Fault]):
        self.schedule: List[Fault] = list(schedule)
        self.events: List[FaultEvent] = []

    def _due(self, kinds: Tuple[str, ...], rnd: int,
             rule: Optional[str] = None) -> List[Fault]:
        out = []
        for f in self.schedule:
            if f.kind not in kinds or f.round != rnd:
                continue
            if f.fired and not f.sticky:
                continue
            if rule is not None and f.rule and f.rule != rule:
                continue
            out.append(f)
        return out

    def before_round(self, rnd: int) -> None:
        for f in self._due(("slow_exchange",), rnd):
            f.fired += 1
            self.events.append(FaultEvent(f.kind, rnd, f.rule, f.lane,
                                          {"delay_s": f.delay_s}))
            time.sleep(f.delay_s)
        for f in self._due(("killed_step",), rnd):
            f.fired += 1
            self.events.append(FaultEvent(f.kind, rnd, f.rule, f.lane, {}))
            raise SimulatedCrash(f"killed_step fault at round {rnd}")

    def storm(self, rnd: int) -> List[dict]:
        """This round's ``burst_storm`` job specs: the engine submits
        them through its public admission path (so every one is rate-
        limited / queue-bounded / deadline-checked like a real client's).
        Each spec is seeded from the fault's counter RNG -- the same
        storm hits the same engine identically every run."""
        specs: List[dict] = []
        for f in self._due(("burst_storm",), rnd):
            rng = f._rng()
            f.fired += 1
            n = max(int(f.jobs), 1)
            self.events.append(FaultEvent(f.kind, rnd, f.rule, f.lane,
                                          {"jobs": n, "tenant": f.tenant}))
            for _ in range(n):
                specs.append({"scenario": "cylinder",
                              "steps": int(4 + 2 * rng.integers(4)),
                              "tenant": f.tenant or None,
                              "seed": int(rng.integers(2 ** 31))})
        return specs

    def _due_poison(self, rnd: int, lanes_by_rid) -> List[Fault]:
        if not lanes_by_rid:
            return []
        return [f for f in self.schedule
                if f.kind == "poison_pill" and rnd >= f.round
                and f.rid in lanes_by_rid]

    def corrupt(self, state, rule: str, rnd: int,
                lanes_by_rid: Optional[dict] = None) -> bool:
        """Apply this round's state faults for ``rule`` to the group's
        ``(B, n_planes, H, Wd)`` int32 lane stack, in place on its own
        device (a tensor, or ``ShardedPlanes`` on a mesh: the lanes hit
        are read whole, corrupted and written back); returns whether any
        fault fired.  ``lanes_by_rid`` (rid -> lane of the group's live
        jobs) lets ``poison_pill`` faults track their target across
        re-slotting; without it they are inert."""
        faults = self._due(STATE_KINDS, rnd, rule=rule)
        poison = [f for f in self._due_poison(rnd, lanes_by_rid)
                  if not f.rule or f.rule == rule]
        if not faults and not poison:
            return False
        b, n_planes, h, wd = state.shape[-4:]
        sharded = isinstance(state, ShardedPlanes)
        edited = {}

        def lane_planes(lane: int):
            if not sharded:
                return state[lane]
            if lane not in edited:
                edited[lane] = state.read_lane(lane)
            return edited[lane]

        for f in poison:
            # Re-key the RNG on the firing count: every live round (and
            # every replay of it) flips fresh deterministic positions.
            rng = np.random.default_rng(
                (f.seed, KINDS.index(f.kind), rnd, f.fired))
            lane = lanes_by_rid[f.rid] % b
            plane = f.plane % n_planes
            detail = {"rid": f.rid, "plane": plane, "positions": []}
            for _ in range(f.bits):
                y, xw, bit = (int(rng.integers(h)), int(rng.integers(wd)),
                              int(rng.integers(32)))
                lane_planes(lane)[plane, y, xw] ^= _word(1 << bit)
                detail["positions"].append([y, xw, bit])
            f.fired += 1
            self.events.append(FaultEvent(f.kind, rnd, rule, lane, detail))
        for f in faults:
            rng = f._rng()
            lane = f.lane % b
            plane = f.plane % n_planes
            if f.kind == "bitflip":
                detail = {"plane": plane, "positions": []}
                for _ in range(f.bits):
                    y = int(rng.integers(h))
                    xw = int(rng.integers(wd))
                    bit = int(rng.integers(32))
                    lane_planes(lane)[plane, y, xw] ^= _word(1 << bit)
                    detail["positions"].append([y, xw, bit])
            else:  # nan_shard
                r0 = int(rng.integers(max(h - f.rows, 1)))
                lane_planes(lane)[plane, r0:r0 + f.rows, :] = \
                    _word(NAN_WORD)
                detail = {"plane": plane, "rows": [r0, r0 + f.rows]}
            f.fired += 1
            self.events.append(FaultEvent(f.kind, rnd, rule, lane, detail))
        for lane, planes in edited.items():
            state.write_lane(lane, planes)
        return True

    def after_checkpoint(self, path: str, rnd: int) -> None:
        """Tear the checkpoint just published at ``path``: truncate one
        leaf file to half its bytes (the crash-mid-write failure mode --
        the manifest is already on disk, so only the per-leaf checksum
        walk can tell)."""
        for f in self._due(("torn_checkpoint",), rnd):
            leaves = sorted(fn for fn in os.listdir(path)
                            if fn.endswith(".npy"))
            if not leaves:
                continue
            victim = leaves[int(f._rng().integers(len(leaves)))]
            fp = os.path.join(path, victim)
            size = os.path.getsize(fp)
            with open(fp, "r+b") as fh:
                fh.truncate(max(size // 2, 1))
            f.fired += 1
            self.events.append(FaultEvent(f.kind, rnd, f.rule, f.lane,
                                          {"file": victim,
                                           "truncated_to": size // 2}))

    def corruption_events(self) -> List[FaultEvent]:
        """Firings the lattice audits are expected to detect (state
        faults and poison pills -- torn checkpoints surface at rollback;
        crashes, stragglers, and storms are not corruption)."""
        return [e for e in self.events if e.kind in CORRUPT_KINDS]


def make_schedule(seed: int, rounds: int, *, rules: Sequence[str] = ("",),
                  n_bitflip: int = 1, n_nan: int = 1, n_torn: int = 0,
                  n_kill: int = 0, n_slow: int = 0,
                  delay_s: float = 0.002, lanes: int = 1,
                  first_round: int = 1, n_storm: int = 0,
                  storm_jobs: int = 6, storm_tenant: str = "",
                  poison_rids: Sequence[int] = ()) -> List[Fault]:
    """A reproducible random schedule over ``rounds`` engine rounds:
    the bench's synthetic fault load.  Faults land in
    ``[first_round, rounds)`` at seeded positions; one-shot (transient)
    by construction, except ``poison_pill``\\ s (one per rid in
    ``poison_rids``), which are persistent by definition."""
    rng = np.random.default_rng(seed)
    out: List[Fault] = []
    span = max(rounds - first_round, 1)

    def rounds_for(n):
        return sorted(first_round + int(r)
                      for r in rng.choice(span, size=n, replace=False)) \
            if n <= span else [first_round + int(rng.integers(span))
                               for _ in range(n)]

    for kind, n in (("bitflip", n_bitflip), ("nan_shard", n_nan),
                    ("torn_checkpoint", n_torn), ("killed_step", n_kill),
                    ("slow_exchange", n_slow), ("burst_storm", n_storm)):
        for r in rounds_for(n):
            rule = rules[int(rng.integers(len(rules)))]
            out.append(Fault(kind=kind, round=r, rule=rule,
                             lane=int(rng.integers(lanes)),
                             plane=int(rng.integers(8)),
                             bits=1 + 2 * int(rng.integers(2)),
                             delay_s=delay_s, jobs=storm_jobs,
                             tenant=storm_tenant,
                             seed=int(rng.integers(2**31))))
    for rid in poison_rids:
        out.append(Fault(kind="poison_pill", round=first_round, rid=rid,
                         plane=int(rng.integers(8)),
                         bits=1 + 2 * int(rng.integers(2)), sticky=True,
                         seed=int(rng.integers(2**31))))
    return sorted(out, key=lambda f: (f.round, f.kind))
