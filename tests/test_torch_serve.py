"""The port's serve engine (``repro_torch.serve``) against the reference's
(``repro.serve``), scenario by scenario of ``tests/test_serve.py``: the
same jobs and fault schedule through both engines give equal job results
(uint32 words, exactly), frames, fault events, detections and wall-free
stats.  Then the port's engine on a 2 x 2 mesh of CPU slots against the
reference's single-device engine, and the two launchers."""
import numpy as np
import pytest
import torch

import _torch_serve as ts
from repro.launch import serve as jcli
from repro_torch.core import distributed
from repro_torch.launch import serve as cli
from repro_torch.serve import QUARANTINED, CAServeEngine, SimulatedCrash
from repro.serve import CAServeEngine as JEngine
from repro.serve import SimulatedCrash as JSimulatedCrash

pytestmark = pytest.mark.serve

CORRUPTIONS = [
    # The round-4 checkpoint is torn on publish; the round-4 state faults
    # are detected at round 5 and anchor on the intact round-2 one.
    dict(kind="torn_checkpoint", round=4, seed=3),
    dict(kind="bitflip", round=4, rule="fhp2", lane=0, plane=2, bits=1,
         seed=4),
    dict(kind="nan_shard", round=4, rule="bml", lane=0, plane=0, rows=2,
         seed=5),
]


@pytest.fixture(scope="module", autouse=True)
def _runner_cache():
    with ts.reference_runner_cache():
        yield


def _dirs(tmp_path, name):
    return (str(tmp_path / f"ref_{name}"), str(tmp_path / f"port_{name}"))


def test_continuous_batching():
    pair = ts.Pair(slots=1, depth=2)
    for rid in range(3):
        pair.submit(rid=rid, scenario="cylinder", steps=6,
                    overrides={"seed": rid})
    assert pair.drain() == [[0, 1, 2]] * 2
    assert sorted(j.admitted_t for j in pair.port.jobs.values()) == \
        [0, 6, 12]
    pair.check()


def test_two_rule_groups_one_engine():
    pair = ts.Pair(slots=2, depth=2)
    ts.submit_mixed(pair, n=4, steps=8)
    assert pair.drain() == [[0, 1, 2, 3]] * 2
    assert {g.variant for g in pair.port.groups.values()} == {"fhp2", "bml"}
    pair.check()


def test_fault_detected_rolled_back(tmp_path):
    clean = ts.Pair(slots=2, depth=2, ckpt_every=2,
                    ckpt_dirs=_dirs(tmp_path, "clean"))
    ts.submit_mixed(clean, n=3, steps=12)
    clean.drain()
    pair = ts.Pair(faults=CORRUPTIONS, slots=2, depth=2, ckpt_every=2,
                   ckpt_dirs=_dirs(tmp_path, "faulty"))
    ts.submit_mixed(pair, n=3, steps=12)
    assert pair.drain() == [[0, 1, 2]] * 2
    pair.check()
    rec = pair.port.stats["recovery"][0]
    assert (rec["detected_round"], rec["restored_round"]) == (5, 2)
    assert len(pair.port.detections) == 2
    for rid, job in pair.port.jobs.items():
        assert np.array_equal(job.result, clean.ref.jobs[rid].result), rid


def test_frames_across_rollback(tmp_path):
    pair = ts.Pair(faults=[dict(kind="bitflip", round=4, rule="fhp2",
                                lane=0, plane=1, bits=3, seed=9)],
                   slots=2, depth=2, ckpt_every=2,
                   ckpt_dirs=_dirs(tmp_path, "f"))
    ts.submit_mixed(pair, n=2, steps=12, frame_every=4)
    pair.drain()
    assert pair.port.stats["rollbacks"] == 1
    assert all(len(j.frames) == 3 for j in pair.port.jobs.values())
    pair.check()


def test_persistent_fault_quarantined(tmp_path):
    pair = ts.Pair(faults=[dict(kind="bitflip", round=4, rule="fhp2",
                                lane=0, plane=2, bits=1, seed=6,
                                sticky=True)],
                   slots=3, depth=2, ckpt_every=2, max_retries=2,
                   ckpt_dirs=_dirs(tmp_path, "q"))
    ts.submit_mixed(pair, n=3, steps=12)
    pair.drain()
    victim = pair.port.detections[0]["rid"]
    assert pair.port.jobs[victim].status == QUARANTINED
    assert pair.port.stats["rollbacks"] == 2
    pair.check()


def test_restart_without_checkpoint():
    pair = ts.Pair(faults=[dict(kind="bitflip", round=1, rule="fhp2",
                                lane=0, plane=0, bits=1, seed=2)],
                   slots=1, depth=2)
    pair.submit(rid=0, scenario="cylinder", steps=6)
    pair.drain()
    assert pair.port.jobs[0].admitted_t > 0
    assert pair.port.stats["rollbacks"] == 0
    pair.check()


def test_crash_resume(tmp_path):
    """killed_step at round 5: each engine dies; each package's ``resume``
    rebuilds its engine from its last valid checkpoint, and both finish
    alike."""
    d = _dirs(tmp_path, "svc")
    pair = ts.Pair(faults=[dict(kind="killed_step", round=5)], slots=2,
                   depth=2, ckpt_every=2, ckpt_dirs=d)
    ts.submit_mixed(pair, n=3, steps=12)
    with pytest.raises(JSimulatedCrash):
        pair.ref.drain()
    with pytest.raises(SimulatedCrash):
        pair.port.drain()
    pair.check()
    ref = JEngine.resume(d[0], ckpt_every=2)
    port = CAServeEngine.resume(d[1], ckpt_every=2, device=ts.CPU)
    assert ref.round == port.round == 4
    for eng in (ref, port):
        assert sorted(j.rid for j in eng.drain()) == [0, 1, 2]
    ts.assert_same_outcome(ref, port)


def test_submit_after_checkpoint_requeued_on_rollback(tmp_path):
    pair = ts.Pair(faults=[dict(kind="bitflip", round=3, rule="fhp2",
                                lane=0, plane=1, bits=1, seed=8)],
                   slots=2, depth=2, ckpt_every=2,
                   ckpt_dirs=_dirs(tmp_path, "r"))
    pair.submit(rid=0, scenario="cylinder", steps=10)
    pair.tick()
    pair.tick()
    pair.submit(rid=1, scenario="cylinder", steps=6, overrides={"seed": 1})
    assert pair.drain() == [[0, 1]] * 2
    assert pair.port.stats["rollbacks"] == 1
    pair.check()


def test_mesh_engine_matches_reference(tmp_path):
    """fhp3 + bml on a 2 x 2 mesh of CPU slots (depth 2, T = 2) with a
    torn checkpoint, a bitflip and a NaN'd shard: the same outcome as the
    reference's single-device engine, rollback onto the mesh included."""
    mesh = distributed.make_mesh((2, 2), ("data", "model"), ts.CPU)
    faults = [dict(CORRUPTIONS[0], seed=1),
              dict(CORRUPTIONS[1], rule="fhp3", plane=3, seed=2),
              dict(CORRUPTIONS[2], seed=3)]
    pair = ts.Pair(faults=faults, mesh=mesh, slots=2, depth=2,
                   steps_per_launch=2, ckpt_every=2,
                   ckpt_dirs=_dirs(tmp_path, "m"))
    for rid in range(3):
        sc = "bml_city" if rid == 1 else "cylinder"
        ov = {"seed": rid}
        if sc == "cylinder":
            ov["variant"] = "fhp3"
        pair.submit(rid=rid, scenario=sc, steps=12, frame_every=4,
                    overrides=ov)
    assert pair.drain() == [[0, 1, 2]] * 2
    g = pair.port.groups["fhp3|0.03"]
    assert isinstance(g.state, distributed.ShardedPlanes)
    assert {v["rule"] for v in pair.port.detections} == {"fhp3", "bml"}
    assert pair.port.stats["recovery"][0]["restored_round"] == 2
    pair.check()


def _cli_lines(out: str):
    """The launcher's report without its wall-clock figures."""
    return [line.split(" in ")[0] + line.split(")")[-1]
            if line.startswith("served") else line
            for line in out.splitlines()]


def test_cli_matches_reference(tmp_path, capsys):
    args = ["--height", "32", "--width", "128", "--slots", "2", "--jobs",
            "4", "--steps", "12", "--ckpt-every", "2", "--faults", "17",
            "--tenants"]
    assert jcli.main(args + ["--ckpt-dir", str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out
    assert cli.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "served 4/4 jobs" in got and "detections: 0" not in got
    assert _cli_lines(got) == _cli_lines(want)


def test_cli_mesh_on_cpu_slots(tmp_path, capsys):
    assert cli.main(["--height", "32", "--width", "256", "--slots", "2",
                     "--jobs", "2", "--steps", "4", "--depth", "2",
                     "--mesh", "2", "2", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)]) == 0
    assert "served 2/2 jobs" in capsys.readouterr().out

