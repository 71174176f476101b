"""The port's fault injector against the reference's: the same schedule
draws the same positions from the same counter-keyed RNG, so ``corrupt``
on the same lane stack gives the same words (the port's int32 bit-view,
in place; on a tensor or on a mesh) and the same ``events``; schedules,
storms, crashes and torn checkpoints match too."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.serve import faults as jfaults
from repro_torch.core import carry, distributed
from repro_torch.serve import faults

pytestmark = pytest.mark.faults

CPU = torch.device("cpu")
SCHEDULE = [
    dict(kind="bitflip", round=2, lane=1, plane=3, bits=64, seed=11),
    dict(kind="bitflip", round=2, rule="bml", lane=0, bits=3, seed=4),
    dict(kind="nan_shard", round=2, lane=2, plane=5, rows=3, seed=5),
    dict(kind="nan_shard", round=3, rule="fhp2", lane=0, plane=0, rows=2,
         seed=6),
    dict(kind="bitflip", round=3, lane=0, plane=1, bits=1, seed=3,
         sticky=True),
    dict(kind="poison_pill", round=1, rid=7, plane=2, bits=3, seed=9,
         sticky=True),
]


def _state(seed=0, shape=(3, 8, 16, 4)):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


def _injectors(schedule=SCHEDULE):
    return (jfaults.FaultInjector([jfaults.Fault(**f) for f in schedule]),
            faults.FaultInjector([faults.Fault(**f) for f in schedule]))


def _events(inj):
    return [dataclasses.astuple(e) for e in inj.events]


@pytest.mark.parametrize("sharded", [False, True], ids=["tensor", "mesh"])
def test_corrupt_matches_reference(sharded):
    """Every round's faults for each rule, replays included (sticky faults
    re-fire with fresh draws; one-shot ones do not)."""
    ref, port = _injectors()
    host = _state()
    lanes = carry.planes_from_reference(host, CPU)
    if sharded:
        mesh = distributed.make_mesh((2, 2), ("data", "model"), CPU)
        lanes = distributed.lattice_spec(mesh).place(lanes)
    for rnd, rule in [(1, "fhp2"), (2, "fhp2"), (2, "bml"), (3, "fhp2"),
                      (3, "fhp2"), (4, "fhp2")]:
        by_rid = {7: 2, 8: 0}
        out = ref.corrupt(host, rule, rnd, lanes_by_rid=by_rid)
        fired = port.corrupt(lanes, rule, rnd, lanes_by_rid=by_rid)
        assert fired == (out is not host), (rnd, rule)
        host = out
        got = lanes.gather() if sharded else lanes
        assert np.array_equal(carry.planes_to_reference(got), host), \
            (rnd, rule)
    assert _events(port) == _events(ref)
    # bit 31 (the int32 sign bit) was among the flipped bits
    assert any(p[2] == 31 for e in port.events if e.kind == "bitflip"
               for p in e.detail["positions"])
    assert len(port.corruption_events()) == len(ref.corruption_events())


def test_nothing_due_leaves_the_state_alone():
    _, port = _injectors()
    lanes = carry.planes_from_reference(_state(), CPU)
    before = lanes.clone()
    assert not port.corrupt(lanes, "bml", 5)
    assert not port.corrupt(lanes, "fhp2", 9, lanes_by_rid={})
    assert torch.equal(lanes, before) and not port.events


def test_schedules_storms_and_crashes_match_reference(tmp_path):
    kw = dict(rules=("fhp3", "bml"), n_bitflip=3, n_nan=2, n_torn=1,
              n_kill=1, n_slow=1, n_storm=2, storm_jobs=3,
              storm_tenant="s", lanes=4, poison_rids=(1, 5))
    a = faults.make_schedule(7, 20, **kw)
    b = jfaults.make_schedule(7, 20, **kw)
    assert [dataclasses.astuple(f) for f in a] == \
        [dataclasses.astuple(f) for f in b]
    schedule = [dataclasses.asdict(f) for f in a
                if f.kind in ("burst_storm", "slow_exchange",
                              "killed_step", "torn_checkpoint")]
    for f in schedule:
        f["delay_s"] = 0.0
    ref, port = _injectors(schedule)
    for rnd in range(20):
        assert port.storm(rnd) == ref.storm(rnd)
        outcomes = []
        for inj, crash in ((ref, jfaults.SimulatedCrash),
                           (port, faults.SimulatedCrash)):
            try:
                inj.before_round(rnd)
                outcomes.append(None)
            except crash:
                outcomes.append(rnd)
        assert outcomes[0] == outcomes[1]
        for inj, name in ((ref, "r"), (port, "p")):
            d = tmp_path / f"{name}{rnd}"
            d.mkdir()
            for i in range(3):
                np.save(d / f"leaf{i}.npy", np.zeros((8, 8), np.uint32))
            inj.after_checkpoint(str(d), rnd)
        assert sorted(os.path.getsize(tmp_path / f"r{rnd}" / f)
                      for f in os.listdir(tmp_path / f"r{rnd}")) == \
            sorted(os.path.getsize(tmp_path / f"p{rnd}" / f)
                   for f in os.listdir(tmp_path / f"p{rnd}"))
    assert _events(port) == _events(ref)
    assert port.events and all(e.kind != "bitflip" for e in port.events)
