"""The harness driven on the CPU at a tiny size, through the program's
plain CPU path: each cell's result line, ``correct`` falling for the
control and for each fault of the timed path, files found by name, and
the command refusing to run without a card or without the program.

    python -m pytest cabench/checks -o python_files='check_*.py'
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from cabench import control, harness

SRC = str(harness.ROOT / "src")
sys.path.insert(0, SRC)
SEED = 2 ** 31 + 12345
SERVE = "ca-serve-1024x4096.short-jobs"
ENSEMBLES = ("fhp2-cylinder-4x4096x32768.ensemble",
             "bml-city-4x4096x32768.ensemble")
TINY = {
    ENSEMBLES[0]: ({"config": {"lanes": 2, "height": 32, "width": 256}}, 0.5),
    ENSEMBLES[1]: ({"config": {"lanes": 2, "height": 32, "width": 256}}, 0.5),
    SERVE: ({"config": {"height": 32, "width": 256, "ckpt_every": 4},
             "traffic": {"check_jobs": 4}}, 1.0),
}
CELLS = sorted(TINY)
# The serve engine's cell is out of BENCHMARK.json: its host-bound rate
# spreads from run to run past the largest bound (PERF.md).  Its driver,
# configuration and mix stay, and are checked from these entries.
PARKED = {
    "configs": [{"name": "ca-serve-1024x4096",
                 "file": "cabench/configs/ca-serve-1024x4096.json",
                 "reduced": ["height", "width", "ckpt_every"]}],
    "workloads": [{"name": SERVE, "config": "ca-serve-1024x4096",
                   "traffic": "short-jobs", "chips": 1}],
    "end_to_end": [{"name": "jobs_per_s", "unit": "jobs/s",
                    "better": "higher", "source": "host_clock",
                    "workloads": [SERVE]}],
    "per_layer": [{"name": "serve.admit_s", "unit": "s", "better": "lower",
                   "source": "host_clock", "layer": "serve admission",
                   "moves": "jobs_per_s", "workloads": [SERVE]},
                  {"name": "device_idle_share.jobs", "unit": "%",
                   "better": "lower", "source": "device_trace",
                   "layer": "device", "moves": "jobs_per_s",
                   "workloads": [SERVE]}],
}


def with_parked(bench: dict) -> dict:
    """``bench`` with the parked serve cell's entries added."""
    return {k: v + PARKED[k] if k in PARKED else v for k, v in bench.items()}


BENCH = with_parked(harness.load_benchmark())


def _run(cell, trace=False, hooks=None, seed=SEED):
    overrides, seconds = TINY[cell]
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            bench=BENCH, overrides=overrides, hooks=hooks)


def test_benchmark_names_the_ensembles_and_not_the_serve_cell():
    cells = {w["name"] for w in harness.load_benchmark()["workloads"]}
    assert cells == set(ENSEMBLES)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    res = _run(cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e, per = harness.metrics_for(BENCH, cell)
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["metrics"]) <= {m["name"] for m in per}
    else:
        assert set(res["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", control.FAULTS)
def test_fault_is_not_correct(cell, kind):
    res = _run(cell, hooks={"make_run": control.faulty(kind)})
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = _run(cell, hooks={"make_run": control.control_make_run()})
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ENSEMBLES)
def test_reference_in_place_is_correct(cell):
    """The reference at the stated 16 bits and with BML's exclusion in the
    program's place passes: the control fails for what it breaks, not for
    standing in."""
    make = control.control_make_run(16, bml_exclusion=True)
    res = _run(cell, hooks={"make_run": make})
    assert res["correct"] is True, res["checks"]


def test_scenario_parameters_reach_both_sides():
    """The configuration's densities and forcing are what both sides run:
    the reference builds from them alone, so a program that kept its own
    defaults would differ from it here."""
    overrides, seconds = TINY[SERVE]
    dense = {"cylinder": {"rule": "fhp2", "density": 0.4, "p_force": 0.05},
             "bml_city": {"rule": "bml", "density": 0.45}}
    res = harness.run_cell(SERVE, SEED, seconds, False, device="cpu",
                           bench=BENCH,
                           overrides={"config": dict(overrides["config"],
                                                     scenarios=dense),
                                      "traffic": overrides["traffic"]})
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("bad", [
    {"config": {"loop": "open"}},
    {"traffic": {"callers": 4}},
    {"config": {"scenarios": {"cylinder": {"rule": "fhp3", "density": 0.22,
                                           "p_force": 0.03},
                              "bml_city": {"rule": "bml", "density": 0.3}}}},
    {"config": {"scenarios": {"cylinder": {"rule": "fhp2", "density": 0.22,
                                           "p_force": 0.03}}}},
    {"config": {"scenarios": {"cylinder": {"rule": "fhp2", "density": 0.22,
                                           "p_force": 0.03},
                              "bml_city": {"rule": "bml", "density": 0.3,
                                           "p_force": 0.01}}}},
])
def test_unread_or_unrunnable_settings_are_refused(bad):
    overrides, seconds = TINY[SERVE]
    merged = {k: dict(overrides.get(k, {}), **bad.get(k, {}))
              for k in ("config", "traffic")}
    with pytest.raises(harness.BenchError):
        harness.run_cell(SERVE, SEED, seconds, False, device="cpu",
                         bench=BENCH, overrides=merged)


def test_one_reader_serves_a_split_metric():
    assert harness.reader_path("device_idle_share.jobs") == \
        harness.reader_path("device_idle_share.sites") == \
        harness.HERE / "metrics" / "device_idle_share.py"
    assert harness.reader_path("serve.admit_s").name == "serve.admit_s.py"
    with pytest.raises(harness.BenchError):
        harness.reader_path("no_such_metric")


def _copy(tmp_path):
    """The benchmark alone: BENCHMARK.json and ``cabench/``."""
    dst = tmp_path / "checkout"
    shutil.copytree(harness.HERE, dst / "cabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", dst)
    return dst


# A new kind of traffic: a driver file of its own beside the others, here
# the serve driver with its clients' scenarios reversed, read from a key
# of its own.
NEW_DRIVER = """from cabench.drivers.serve import *  # noqa: F401,F403
from cabench.drivers import serve as _serve

TRAFFIC_KEYS = _serve.TRAFFIC_KEYS + ("reverse",)


def setup(run):
    if run.traffic.pop("reverse"):
        run.traffic["scenarios"] = run.traffic["scenarios"][::-1]
    return _serve.setup(run)
"""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix with a driver of its own and a
    per-layer metric added as new files, and entries in BENCHMARK.json, run
    with no other edit."""
    dst = _copy(tmp_path)
    cab = dst / "cabench"
    cfg = json.loads((cab / "configs" / "ca-serve-1024x4096.json").read_text())
    cfg.update(name="ca-serve-32x256", height=32, width=256, ckpt_every=4)
    (cab / "configs" / "ca-serve-32x256.json").write_text(json.dumps(cfg))
    tr = json.loads((cab / "traffic" / "short-jobs.json").read_text())
    tr.update(driver="serve_reversed", reverse=True, clients=4, prime_jobs=4,
              check_jobs=2)
    (cab / "traffic" / "few-jobs.json").write_text(json.dumps(tr))
    (cab / "drivers" / "serve_reversed.py").write_text(NEW_DRIVER)
    (cab / "metrics" / "serve.rounds.py").write_text(
        "def read(run):\n    return run.counters.get('rounds')\n")
    bench = with_parked(json.loads((dst / "BENCHMARK.json").read_text()))
    bench["configs"].append(dict(PARKED["configs"][0], name=cfg["name"],
                                 file="cabench/configs/ca-serve-32x256.json"))
    cell = "ca-serve-32x256.few-jobs"
    bench["workloads"].append({"name": cell, "config": cfg["name"],
                               "traffic": "few-jobs", "chips": 1,
                               "why": "a check"})
    for m in bench["end_to_end"]:
        if m["name"] == "jobs_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "serve.rounds", "unit": "rounds",
                               "better": "higher", "source":
                               "program_counter", "layer": "serve round loop",
                               "moves": "jobs_per_s", "workloads": [cell]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from cabench import harness; "
            "print(json.dumps(harness.run_cell(sys.argv[3], 7, 1.0, True, "
            "device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(dst), SRC, cell],
                         capture_output=True, text=True, timeout=300,
                         cwd=dst)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["serve.rounds"]["value"] > 0
    assert "serve.admit_s" not in res["metrics"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "cabench/run.py", "--workload",
         "fhp2-cylinder-4x4096x32768.ensemble", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(harness.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_command_fails_without_the_program(tmp_path):
    out = _command(_copy(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "program is missing" in out.stderr


def test_no_forbidden_module_in_a_run():
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from cabench import harness; "
            "harness.run_cell('ca-serve-1024x4096.short-jobs', 3, 0.5, True, "
            "device='cpu', bench=json.loads(sys.argv[3]), "
            "overrides={'config': {'height': 32, "
            "'width': 256}, 'traffic': {'check_jobs': 2}}); "
            "print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT),
                          SRC, json.dumps(BENCH)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
