"""The DeepSeek-V3 cell driven on the CPU at the smoke twin's widths,
through the program's plain CPU path, and its plain reference against the
program: the reference's logits are the program's ``forward``'s and its
prefill's and decode steps' through the cache, to a relative L2 error of
1e-5 (float32; the weights' spread of 0.2 makes attention, the gate and
every layer move the logits); the drawn weights are the program's tree;
the cell's result line; ``correct`` falling under each control and each
fault of the timed path; the recorder's buffers; both per-layer readers.

    python -m pytest cabench/checks -o python_files='check_*.py'
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cabench import control_lm_mla_moe as control, harness, program_spans
from cabench.drivers import lm_serve_mla_moe as driver
from cabench.reference import lm_mla_moe as reference

SRC = str(harness.ROOT / "src")
sys.path.insert(0, SRC)
CELL = "deepseek-v3-ep32-bf16-256x2560.chat-256"
SEED = 2 ** 31 + 77
TOL = 1e-5
# The smoke twin's widths (64 experts in 8 groups, 2 a share of 32); the
# weights' spread of 0.2 at float32.  Sound runs read ~1e-6, every control
# and fault 1e-2 or more, so these limits part them.
WIDTHS = {"hidden_size": 64, "num_attention_heads": 4,
          "num_key_value_heads": 4, "q_lora_rank": 32, "kv_lora_rank": 16,
          "qk_rope_head_dim": 8, "qk_nope_head_dim": 8, "v_head_dim": 8,
          "intermediate_size": 128, "moe_intermediate_size": 32,
          "n_routed_experts": 2, "first_k_dense_replace": 1,
          "num_hidden_layers": 4, "vocab_size": 512}
SMOKE = {"config": dict(WIDTHS, slots=2, max_len=48, dtype="float32",
                        cache_dtype="float32", init_std=0.2,
                        limits={"served_gap": 1e-3,
                                "prefill_logits_err": 1e-4,
                                "decode_logits_err": 1e-4}),
         "traffic": {"clients": 2, "prompt_len": [4, 24],
                     "new_tokens": [4, 12], "stratum": 4,
                     "warmup_steps": 2, "check_steps": 4}}


def smoke_config(**change) -> dict:
    """The cell's configuration at the smoke widths."""
    bench = harness.load_benchmark()
    found = harness.resolve(bench, CELL)
    return {**found["config"], **SMOKE["config"], **change}


def _run(trace=False, hooks=None, overrides=SMOKE, seconds=4.0):
    return harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                            overrides=overrides, hooks=hooks)


def _weights(seed, **change):
    cfg = smoke_config(**change)
    wt = driver.draw_weights(cfg, seed, torch.device("cpu"))
    return cfg, wt, driver.program_tree(wt, cfg), driver.model_cfg(cfg)


def _close(got, ref):
    err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert float(err.max()) <= TOL, err


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, WIDTHS["vocab_size"], n)


@pytest.mark.parametrize("seed,rank", [(1, 0), (2 ** 31 + 5, 3),
                                       (2 ** 40 + 3, 31)])
def test_reference_is_the_programs_forward(seed, rank):
    from repro_torch.models import lm
    cfg, wt, tree, mcfg = _weights(seed, ep_rank=rank)
    toks = _tokens(seed, 37)
    got, _ = lm.forward(tree, mcfg, {"tokens": torch.as_tensor(toks)[None]})
    (ref,) = reference.logits(wt, cfg, [toks], [0])
    assert ref.std() > 1.0
    _close(got[0], ref)


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_reference_is_the_programs_prefill_and_decode(seed):
    from repro_torch.models import decode_step, prefill
    cfg, wt, tree, mcfg = _weights(seed, ep_rank=seed % 32)
    toks = _tokens(seed, 30)
    s = 21
    last, cache = prefill(tree, mcfg,
                          {"tokens": torch.as_tensor(toks[:s])[None]},
                          max_len=32, cache_dtype=torch.float32)
    got = [last[0]]
    for p in range(s, len(toks)):
        logits, cache = decode_step(tree, mcfg, cache,
                                    torch.as_tensor(toks[p:p + 1]), p)
        got.append(logits[0])
    (ref,) = reference.logits(wt, cfg, [toks], [s - 1])
    _close(torch.stack(got), ref)


def test_reference_yarn_is_the_programs():
    from repro_torch.models import attention, common
    cfg = smoke_config()
    full = harness.resolve(harness.load_benchmark(), CELL)["config"]
    for w in (cfg, full):
        mcfg = driver.model_cfg(w)
        np.testing.assert_allclose(
            reference.yarn_inv_freq(w),
            common.yarn_frequencies(mcfg.mla.rope_dim, mcfg.rope_theta,
                                    mcfg.mla.yarn), rtol=1e-15)
        assert reference.softmax_scale(w) == pytest.approx(
            attention.mla_scale(mcfg), rel=1e-12)


def test_drawn_weights_depend_on_the_seed_alone():
    cfg = smoke_config()
    a = driver.draw_weights(cfg, 2 ** 31 + 9, torch.device("cpu"))
    b = driver.draw_weights(cfg, 2 ** 31 + 9, torch.device("cpu"))
    c = driver.draw_weights(cfg, 2 ** 31 + 10, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ewg"], c["ewg"])
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        reference.shapes(cfg)


@pytest.mark.parametrize("change", [
    {"hidden_size": 128}, {"rope_theta": 1e6}, {"n_group": 4},
    {"scoring_func": "softmax"}, {"n_routed_experts": 4},
    {"ep_rank": 32}, {"num_hidden_layers": 1},
    {"num_nextn_predict_layers": 1}, {"arch": "deepseek-v3-671b"},
    {"arch": "no-such-model"}])
def test_other_widths_or_parts_are_refused(change):
    with pytest.raises(harness.BenchError):
        driver.model_cfg(smoke_config(**change))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    res = _run(trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e, per = harness.metrics_for(harness.load_benchmark(), CELL)
    assert {m["name"] for m in e2e} == {"tokens_per_s", "mfu", "setup_s"}
    assert {m["name"] for m in per} == {"moe.expert_byte_roofline",
                                        "mla.decode_roofline"}
    if trace:
        # No device on the CPU: the readers of the device trace give
        # nothing.
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == {"requests_short", "requests_unchecked",
                                  "served_gap", "prefill_logits_err",
                                  "decode_logits_err"}
    assert res["checks"]["decode_logits_err"]["value"] > 0
    json.dumps(res)


@pytest.mark.parametrize("kind", control.CONTROLS)
def test_control_is_not_correct(kind):
    res = _run(hooks=control.control(kind))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("kind", control.FAULTS)
def test_fault_is_not_correct(kind):
    res = _run(hooks=control.fault(kind))
    assert res["correct"] is False, res["checks"]


def test_unchecked_requests_are_counted():
    """A run with no request due to finish in the check's steps has none
    to check, and fails."""
    res = _run(overrides={"traffic": dict(SMOKE["traffic"], check_steps=1,
                                          new_tokens=[8, 12])})
    assert res["checks"]["requests_unchecked"]["value"] > 0
    assert res["correct"] is False


def test_requests_due_past_the_window_are_checked():
    """A window too short to finish the chosen requests: the check steps
    the engine on after it, and they are checked."""
    res = _run(overrides={"config": dict(SMOKE["config"], max_len=120),
                          "traffic": dict(SMOKE["traffic"], check_steps=400,
                                          new_tokens=[60, 100],
                                          prompt_len=[4, 8])}, seconds=0.5)
    assert res["checks"]["requests_unchecked"]["value"] == 0
    assert res["correct"] is True, res["checks"]


def _request(rid, plen, new):
    from repro_torch.serve import Request
    return Request(rid=rid, prompt=np.zeros(plen, np.int32), max_new=new)


def test_recorder_holds_at_most_four_buffers():
    """Requests that each take a role from the last: the roles end on the
    drawn candidate, the longest and the one with the most new tokens,
    and no more than three buffers are ever taken of the four."""
    tr = dict(SMOKE["traffic"], new_tokens=[4, 40], check_steps=100)
    eng = SimpleNamespace(bs=2, slots=[None, None])
    rec = driver.Recorder(eng, tr, 16, torch.float32, torch.device("cpu"),
                          pick=5, first_step=10)
    assert rec.bufs.shape[0] == driver.BUFFERS == 4
    reqs = [_request(i, 4 + i % 7, 4 + (i * 7) % 30) for i in range(40)]
    # Admitted in step 10, each finishes in the window's first 100 steps;
    # then the longest of all, finishing before the window, and one
    # finishing after its first 100 steps.
    at = [10] * 40 + [0, 90]
    reqs += [_request(40, 30, 9), _request(41, 30, 39)]
    seen = 0
    for r, step in zip(reqs, at):
        rec.steps = step
        rec._admit(r)
        seen = max(seen, len(rec.buf_of))
        assert len(set(rec.buf_of.values())) == len(rec.buf_of)
    assert seen <= 3
    cands = reqs[:40]
    assert rec.candidates == 40
    assert rec.role["drawn"] is cands[5]
    assert rec.role["longest"] is max(
        cands, key=lambda r: (len(r.prompt) + r.max_new, -r.rid))
    assert rec.role["most_new"] is max(cands,
                                       key=lambda r: (r.max_new, -r.rid))
    assert set(rec.buf_of) == {id(r) for r in rec.chosen()}


@pytest.mark.parametrize("metric", ["moe.expert_byte_roofline",
                                    "mla.decode_roofline"])
def test_readers_read_device_time_launched_in_spans(metric, monkeypatch):
    """A reader's time is the union of the device operations launched
    inside the program's spans that begin in a decode-only step: an
    operation launched in a prefill step's span, or outside the spans,
    is left out; overlaps count once; an operation counts whole though it
    runs past its span."""
    from cabench.roofline import lm_mla_moe
    mod = harness._load_file_module(harness.reader_path(metric))
    names = (("moe.route", "moe.experts") if metric.startswith("moe")
             else ("mla.decode", "mla.decode"))
    steps = [("lm.step", 10.0, 11.0), ("lm.step.prefill", 11.0, 12.0),
             ("lm.step", 12.0, 13.0)]
    prog = [SimpleNamespace(name=names[0], start=10.1, end=10.2),
            SimpleNamespace(name=names[1], start=10.3, end=10.5),
            SimpleNamespace(name=names[0], start=11.1, end=11.3),
            SimpleNamespace(name=names[1], start=12.1, end=12.2),
            SimpleNamespace(name="other", start=12.4, end=12.6)]
    ops = [(10.15, 10.4, 10.12),       # launched in a span: 0.25
           (10.3, 10.45, 10.35),       # overlaps it: +0.05
           (10.6, 10.7, 10.25),        # launched between spans
           (11.2, 11.4, 11.15),        # in the prefill step's span
           (12.15, 12.9, 12.19),       # runs past its span: 0.75
           (12.5, 12.55, 12.45),       # another span's
           (12.95, 13.0, None)]        # launch unknown
    monkeypatch.setattr(program_spans, "window", lambda run: prog)
    monkeypatch.setattr(program_spans, "device_ops", lambda run: ops)
    cfg = harness.resolve(harness.load_benchmark(), CELL)["config"]
    counts = {"decode_only_steps": 2, "decode_only_rows": 300,
              "decode_only_keys": 40000}
    run = SimpleNamespace(counters=counts, config=cfg,
                          spans=SimpleNamespace(records=steps),
                          trace=SimpleNamespace())
    if metric.startswith("moe"):
        least = lm_mla_moe.expert_seconds(cfg, 2)
    else:
        least = lm_mla_moe.mla_decode_seconds(cfg, steps=2, rows=300,
                                              keys=40000)
    assert mod.read(run) == pytest.approx(100 * least / 1.05)
    assert mod.read(SimpleNamespace(**dict(vars(run), trace=None))) is None
    monkeypatch.setattr(program_spans, "window", lambda run: None)
    assert mod.read(run) is None


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


def test_yarn_off_at_the_stated_rotary_is_the_program():
    """The ``yarn_off`` control's configuration is the program's but for
    YaRN: its MLA widths are the cell's."""
    mcfg = driver.model_cfg(smoke_config())
    off = control.yarn_off(mcfg)
    assert dataclasses.asdict(off.mla) == {
        k: v for k, v in dataclasses.asdict(mcfg.mla).items()
        if k != "yarn"}
    assert off.moe == mcfg.moe
