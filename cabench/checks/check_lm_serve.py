"""The LM cell driven on the CPU at the internlm2 smoke widths, through the
program's plain CPU path: its result line, ``correct`` falling under each
control and each fault of the timed path, the traffic's strata, and no
forbidden module loaded.

    python -m pytest cabench/checks -o python_files='check_*.py'
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from cabench import control_lm, harness
from cabench.drivers import lm_serve

SRC = str(harness.ROOT / "src")
sys.path.insert(0, SRC)
CELL = "internlm2-20b-bf16-32x2560.chat"
SEED = 2 ** 31 + 77
# Float32 at the smoke widths: sound runs read ~4e-7 (check_lm_reference),
# every control and fault reads 1e-2 or more, so these limits part them.
SMOKE = {"config": {"n_layers": 4, "d_model": 128, "n_heads": 8,
                    "n_kv_heads": 2, "head_dim": 16, "d_ff": 256,
                    "vocab": 512, "slots": 2, "max_len": 48,
                    "dtype": "float32", "cache_dtype": "float32",
                    "limits": {"served_gap": 1e-3,
                               "prefill_logits_err": 1e-4,
                               "decode_logits_err": 1e-4}},
         "traffic": {"clients": 2, "prompt_len": [4, 24],
                     "new_tokens": [4, 12], "stratum": 4,
                     "warmup_steps": 2}}


def _run(trace=False, hooks=None, overrides=SMOKE, seconds=2.0):
    return harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                            overrides=overrides, hooks=hooks)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    res = _run(trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e, per = harness.metrics_for(harness.load_benchmark(), CELL)
    assert {m["name"] for m in e2e} == {"tokens_per_s", "mfu", "setup_s"}
    if trace:
        # No device on the CPU: the readers of the device trace give
        # nothing, that of the benchmark's spans reads.
        assert set(res["metrics"]) == {"lm.prefill_share"}
        assert 0 < res["metrics"]["lm.prefill_share"]["value"] < 100
    else:
        assert set(res["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == {"requests_short", "requests_unchecked",
                                  "served_gap", "prefill_logits_err",
                                  "decode_logits_err"}
    json.dumps(res)


def test_decode_byte_roofline_reads_device_time_of_decode_steps():
    """The reader's time is the union of the device operations that start
    inside a decode-only step: overlaps counted once, operations of a
    prefill step or between steps left out, an operation that outlasts
    its step taken whole."""
    from types import SimpleNamespace
    from cabench.roofline import lm
    mod = harness._load_file_module(
        harness.reader_path("lm.decode_byte_roofline"))
    spans = [("lm.step", 10.0, 11.0), ("lm.step.prefill", 11.0, 12.0),
             ("lm.step", 12.0, 13.0)]
    ops = [(9.5, 10.2, "a"),            # starts before any step
           (10.1, 10.3, "b"), (10.2, 10.4, "c"),    # overlap: 0.3
           (10.9, 11.2, "d"),           # outlasts its step: 0.3
           (11.1, 11.5, "e"),           # in the prefill step
           (12.0, 12.1, "f"),           # at a step's start: 0.1
           (13.0, 13.1, "g")]           # at a step's end
    assert mod.busy_in(ops, [(s, t) for n, s, t in spans
                             if n == "lm.step"]) == pytest.approx(0.7)
    cfg = SMOKE["config"]
    counts = {"decode_only_steps": 2, "decode_only_rows": 3,
              "decode_only_keys": 40}
    run = SimpleNamespace(counters=counts, config=cfg,
                          spans=SimpleNamespace(records=spans),
                          trace=SimpleNamespace(ops=ops))
    least = lm.decode_seconds(cfg, steps=2, rows=3, keys=40)
    assert mod.read(run) == pytest.approx(100 * least / 0.7)
    assert mod.read(SimpleNamespace(**dict(vars(run), trace=None))) is None
    run.trace.ops = ops[4:5]
    assert mod.read(run) is None


@pytest.mark.parametrize("kind", control_lm.CONTROLS)
def test_control_is_not_correct(kind):
    res = _run(hooks=control_lm.control(kind))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("kind", control_lm.FAULTS)
def test_fault_is_not_correct(kind):
    res = _run(hooks=control_lm.fault(kind))
    assert res["correct"] is False, res["checks"]


def test_control_at_the_stated_theta_is_correct():
    """Rotary at the configuration's own theta through the control's hook
    passes: the control fails for what it breaks."""
    res = _run(hooks=control_lm.rope_theta(1e6))
    assert res["correct"] is True, res["checks"]


def test_bf16_run_compares_every_number():
    """The card's types at the smoke widths: the check runs on bf16 rows
    and reads a bf16 floor well above float32's."""
    cfg = dict(SMOKE["config"], dtype="bfloat16", cache_dtype="bfloat16")
    res = _run(overrides={"config": cfg, "traffic": SMOKE["traffic"]},
               seconds=6.0)
    checks = res["checks"]
    assert checks["requests_unchecked"]["value"] == 0
    assert checks["requests_short"]["value"] == 0
    assert 1e-3 < checks["decode_logits_err"]["value"] < 0.1


def test_traffic_strata_are_the_same_lengths_in_another_order():
    """Every seed's strata: the same lengths, each run of 4 one of each
    quarter."""
    tr = {"prompt_len": [128, 2048], "new_tokens": [64, 512], "stratum": 32,
          "eos": -1}

    def lengths(seed):
        t = lm_serve.Traffic(tr, 92544, seed)
        reqs = [t.next() for _ in range(64)]
        return [(len(r.prompt), r.max_new) for r in reqs]

    a, b = lengths(2 ** 31 + 1), lengths(2 ** 31 + 2)
    assert a != b
    for k in (0, 32):
        assert sorted(x for x, _ in a[k:k + 32]) == \
            sorted(x for x, _ in b[k:k + 32])
        assert sorted(y for _, y in a[k:k + 32]) == \
            sorted(y for _, y in b[k:k + 32])
    for x in (a[:32], b[32:]):
        # Every aligned run of 4 takes one length of each quarter.
        for k in range(0, 32, 4):
            quarters = {sorted(p for p, _ in x).index(p) // 8
                        for p, _ in x[k:k + 4]}
            assert quarters == {0, 1, 2, 3}
    plen = sorted(x for x, _ in a[:32])
    assert plen[0] == 134 and plen[-1] == 1961
    assert sum(plen) / 32 == pytest.approx(692.3, abs=0.1)
    assert sum(y for _, y in a[:32]) / 32 == pytest.approx(288, abs=0.5)
    assert lengths(2 ** 31 + 1) == a


@pytest.mark.parametrize("bad", [
    {"config": {"d_model": 256}},
    {"config": {"limits": {"served_gap": 1.0}}},
    {"traffic": {"new_tokens": [2, 12]}},
    {"traffic": {"prompt_len": [4, 40]}},
    {"traffic": {"arrivals": "poisson"}},
    {"traffic": {"stratum": 6}},
])
def test_unrunnable_settings_are_refused(bad):
    merged = {k: dict(SMOKE[k], **bad.get(k, {})) for k in SMOKE}
    with pytest.raises(harness.BenchError):
        _run(overrides=merged)


def test_no_forbidden_module_in_a_run():
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from cabench import harness; "
            "harness.run_cell(sys.argv[3], 3, 0.5, True, device='cpu', "
            "overrides=json.loads(sys.argv[4])); "
            "print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT),
                          SRC, CELL, json.dumps(SMOKE)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
