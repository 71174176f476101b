"""The port's admission control, fair scheduling, preemption and overload
handling against the reference's: the wall-clock-free scenarios of
``tests/test_slo.py`` through both engines (typed refusals, fairness
under a seeded storm, bit-exact parking and resumption, provably
infeasible deadlines, degradation under an impossible round budget, the
drain cap, lifetime stats across a crash), and the admission layer's
units side by side."""
import numpy as np
import pytest

import _torch_serve as ts
from repro.serve import CAServeEngine as JEngine
from repro.serve import SimulatedCrash as JSimulatedCrash
from repro.serve import admission as jadm
from repro_torch.serve import (PARKED, QUARANTINED, CAServeEngine,
                               DrainTimeout, SimulatedCrash)
from repro_torch.serve import admission as adm

pytestmark = pytest.mark.slo

TIERS = {"gold": dict(priority=2), "bronze": dict(priority=1)}


@pytest.fixture(scope="module", autouse=True)
def _runner_cache():
    with ts.reference_runner_cache():
        yield


# ---------------------------------------------------------------------------
# Admission-layer units, both packages side by side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [adm, jadm], ids=["port", "reference"])
def test_token_bucket_and_round_model(mod):
    now = [0.0]
    b = mod.TokenBucket(rate=2.0, burst=2, clock=lambda: now[0])
    assert b.try_take() and b.try_take() and not b.try_take()
    assert b.retry_after_s() == pytest.approx(0.5)
    now[0] += 0.5
    assert b.try_take() and not b.try_take()
    assert mod.TokenBucket(rate=None, burst=1).try_take()
    m = mod.RoundTimeModel(modeled_s=1.0, alpha=0.5)
    assert m.round_s() == 1.0 and m.best_case_s(3) == 3.0
    m.observe(0.1)
    m.observe(0.3)
    assert m.round_s() == pytest.approx(0.2) and m.n_observed == 2


def test_scheduler_and_fairness_match_reference():
    rng = np.random.default_rng(3)
    names = ["a", "b", "c"]
    cfg = dict(a=dict(priority=1, weight=1.0), b=dict(priority=1, weight=2.0),
               c=dict(priority=2, weight=1.0))
    cost = {rid: float(1 + rng.integers(4)) for rid in range(24)}
    orders = []
    for mod in (adm, jadm):
        sched = mod.FairScheduler({n: mod.TenantConfig(n, **cfg[n])
                                   for n in names})
        for rid in range(24):
            sched.enqueue(names[rid % 3], rid)
        first = sched.order(lambda r: cost[r], aged=[4, 7])
        sched.requeue_front("a", first[-3:])
        sched.refund("a", 2.0)
        orders.append((first, sched.order(lambda r: cost[r]),
                       dict(sched.deficit)))
    assert orders[0] == orders[1]
    for xs in ([], [0, 0], [5, 5, 5], [1, 0, 0, 0], [3.5, 1.0, 2.25]):
        assert adm.jain_index(xs) == jadm.jain_index(xs)


# ---------------------------------------------------------------------------
# Typed backpressure through both engines
# ---------------------------------------------------------------------------

def test_rate_limit_and_queue_bound_typed():
    for tenants, refusal in (({"b": dict(rate=0.001, burst=2)},
                              "RateLimited"),
                             ({"b": dict(queue_limit=2)}, "QueueFull")):
        pair = ts.Pair(tenants=tenants, slots=1, depth=2)
        for rid in range(2):
            assert pair.submit(rid=rid, scenario="cylinder", steps=4,
                               tenant="b", overrides={"seed": rid}) is None
        assert pair.submit(rid=2, scenario="cylinder", steps=4,
                           tenant="b") == refusal
        assert pair.port.rejections[0]["reason"] == refusal
        assert pair.port.rejections[0]["retry_after_s"] > 0
        assert 2 not in pair.port.jobs
        pair.check()


def test_infeasible_deadline_and_unknown_tenant():
    pair = ts.Pair(slots=1, depth=2)
    assert pair.submit(rid=0, scenario="cylinder", steps=4,
                       deadline_s=0.0) == "DeadlineInfeasible"
    assert pair.port.rejections[0]["retry_after_s"] == 0.0
    assert pair.submit(rid=1, scenario="cylinder", steps=4,
                       tenant="walk-in") is None      # permissive mode
    pair.check()
    strict = ts.Pair(tenants={"a": {}}, slots=1, depth=2)
    assert strict.submit(rid=0, scenario="cylinder", steps=4,
                         tenant="nobody") == "UnknownTenant"
    strict.check()


# ---------------------------------------------------------------------------
# Preemption: bit-exact park/resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["bml_city", "cylinder"])
def test_preempted_job(scenario):
    """gold preempts the bronze lane at an audited boundary; bronze is
    parked (a host lattice), resumed in a new segment and finishes
    exactly as in the reference."""
    pair = ts.Pair(tenants=TIERS, slots=1, depth=2)
    pair.submit(rid=0, scenario=scenario, steps=12, tenant="bronze",
                overrides={"seed": 0})
    pair.tick()
    pair.submit(rid=1, scenario=scenario, steps=4, tenant="gold",
                overrides={"seed": 1})
    pair.tick()
    assert pair.port.jobs[0].status == PARKED
    pair.check()                      # parked lattices equal, word for word
    assert pair.drain() == [[0, 1]] * 2
    assert len(pair.port.jobs[0].segments) == 2
    assert pair.port.stats["resumed"] == 1
    pair.check()


def test_preemption_bounded_and_audited():
    pair = ts.Pair(tenants=TIERS, slots=1, depth=2, audit_every=2,
                   max_preemptions=1)
    pair.submit(rid=0, scenario="cylinder", steps=16, tenant="bronze",
                overrides={"seed": 0})
    pair.tick()
    pair.submit(rid=1, scenario="cylinder", steps=4, tenant="gold",
                overrides={"seed": 1})
    pair.tick()
    assert pair.port.jobs[0].status == "running"    # unaudited boundary
    pair.tick()
    assert pair.port.jobs[0].status == PARKED
    pair.submit(rid=2, scenario="cylinder", steps=4, tenant="gold",
                overrides={"seed": 2})
    assert pair.drain() == [[0, 1, 2]] * 2
    assert pair.port.jobs[0].preemptions == 1
    pair.check()


# ---------------------------------------------------------------------------
# Fairness and faulty clients
# ---------------------------------------------------------------------------

def test_no_tenant_starves_under_adversarial_storm():
    rng = np.random.default_rng(42)
    tenants = {"gold": dict(priority=2, weight=2.0),
               "silver": dict(priority=1, weight=2.0),
               "bronze": dict(priority=1, weight=1.0, queue_limit=4)}
    pair = ts.Pair(tenants=tenants, slots=2, depth=2, starvation_rounds=4)
    names = list(tenants)
    for rid in range(15):
        pair.submit(rid=rid, scenario="cylinder",
                    steps=int(2 * (1 + rng.integers(4))),
                    tenant=names[int(rng.integers(3))],
                    overrides={"seed": rid})
    pair.drain(max_rounds=400)
    slo = pair.port.slo_report()
    for name, d in slo["tenants"].items():
        assert d["done"] == d["submitted"], name
    assert slo["jain_fairness"] == pair.ref.slo_report()["jain_fairness"]
    pair.check()


def test_burst_storm_and_poison_pill():
    storm = ts.Pair(faults=[dict(kind="burst_storm", round=1, jobs=6,
                                 tenant="storm", seed=7)],
                    tenants={"storm": dict(queue_limit=2), "default": {}},
                    slots=2, depth=2)
    storm.submit(rid=0, scenario="cylinder", steps=8, overrides={"seed": 0})
    storm.drain(max_rounds=200)
    assert storm.port.stats["storm_rejected"] >= 1
    storm.check()
    poison = ts.Pair(faults=[dict(kind="poison_pill", round=1, rid=0,
                                  sticky=True, seed=9)],
                     slots=2, depth=2, max_retries=1)
    for rid in range(2):
        poison.submit(rid=rid, scenario="cylinder", steps=8,
                      overrides={"seed": rid})
    assert poison.drain(max_rounds=200) == [[1]] * 2
    assert poison.port.jobs[0].status == QUARANTINED
    poison.check()


# ---------------------------------------------------------------------------
# Degradation and accounting
# ---------------------------------------------------------------------------

def test_overload_stretches_frames_and_checkpoints(tmp_path):
    """A 1 ns round budget is breached by every round on any machine:
    frames deferred and checkpoints stretched alike in both engines."""
    pair = ts.Pair(slots=2, depth=2, ckpt_every=2, round_budget_s=1e-9,
                   ckpt_dirs=(str(tmp_path / "r"), str(tmp_path / "p")))
    pair.submit(rid=0, scenario="cylinder", steps=12, frame_every=2,
                overrides={"seed": 0})
    assert pair.drain() == [[0]] * 2
    for k in ("overloaded_rounds", "frames_deferred", "ckpts_stretched"):
        assert pair.port.stats[k] >= 1, k
    assert pair.port.stats["overloaded_rounds"] == \
        pair.ref.stats["overloaded_rounds"]
    pair.check()


def test_drain_timeout_typed_with_stuck_rids():
    eng = CAServeEngine(height=ts.H, width=ts.W, slots=1, depth=2,
                        device=ts.CPU)
    from repro_torch.serve import SimJob
    for rid in range(2):
        eng.submit(SimJob(rid=rid, scenario="cylinder", steps=8,
                          overrides={"seed": rid}))
    with pytest.raises(DrainTimeout) as ei:
        eng.drain(max_rounds=2)
    assert ei.value.rids == [0, 1] and ei.value.queue_depth == 1
    assert {j.rid for j in eng.drain()} == {0, 1}


def test_lifetime_stats_survive_crash_resume(tmp_path):
    d = (str(tmp_path / "r"), str(tmp_path / "p"))
    pair = ts.Pair(faults=[dict(kind="bitflip", round=2, rule="fhp2",
                                lane=0, plane=1, bits=1, seed=5),
                           dict(kind="killed_step", round=5, seed=6)],
                   slots=2, depth=2, ckpt_every=2, ckpt_dirs=d)
    for rid in range(2):
        pair.submit(rid=rid, scenario="cylinder", steps=12,
                    overrides={"seed": rid})
    with pytest.raises(JSimulatedCrash):
        pair.ref.drain()
    with pytest.raises(SimulatedCrash):
        pair.port.drain()
    ref = JEngine.resume(d[0], ckpt_every=2)
    port = CAServeEngine.resume(d[1], ckpt_every=2, device=ts.CPU)
    assert port.stats["rollbacks"] == port.stats["audit_failures"] == 1
    for eng in (ref, port):
        eng.drain()
    assert port.stats["jobs_done"] == 2
    ts.assert_same_outcome(ref, port)


def test_metrics_slo_block():
    tenants = {"gold": dict(priority=2, weight=2.0), "bronze": {}}
    pair = ts.Pair(tenants=tenants, slots=2, depth=2)
    pair.submit(rid=0, scenario="cylinder", steps=4, frame_every=2,
                tenant="gold", overrides={"seed": 0})
    pair.submit(rid=1, scenario="cylinder", steps=4, tenant="bronze",
                overrides={"seed": 1})
    pair.drain()
    pair.check()
    got, want = pair.port.metrics(), pair.ref.metrics()
    wall = ("frame_gap_p50_s", "frame_gap_p99_s")
    for m in (got, want):
        for d in m["slo"]["tenants"].values():
            for k in wall:
                d.pop(k)
    assert got["slo"]["tenants"] == want["slo"]["tenants"]
    assert got["slo"]["jain_fairness"] == want["slo"]["jain_fairness"]
    assert got["slo"]["round_s_measured_n"] == got["rounds"]
    skip = ("slo", "stragglers_detected", "overloaded_rounds")
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
