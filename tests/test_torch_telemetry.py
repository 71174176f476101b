"""The port's telemetry layer against the reference's: the same span,
count and event sequence gives the same wall-free summary and the same
JSONL records; the disabled path is a no-op; a disabled instance records
spans on the wall clock, in memory only, while a profiler records, and
names none in the profiler; the ensemble path and the serve engine open
their spans where the work happens; critical events reach the sink
through the port's serve engine without a flush."""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro.telemetry.core import Telemetry as JTelemetry
from repro_torch import telemetry
from repro_torch.telemetry import core
from repro_torch.telemetry.core import _NULL, Telemetry


def _drive(tel):
    with tel.span("outer", depth=2):
        with tel.span("inner"):
            tel.count("hits", 3)
        with tel.span("inner", k=1):
            tel.count("hits")
    tel.event("note", round=1)
    tel.event("fault", critical=True, round=3, rids=[1, 2])
    for _ in range(5):
        with tel.span("leaf"):
            pass


def _wall_free(summary):
    spans = {n: {k: v for k, v in s.items() if not k.endswith("_s")}
             for n, s in summary["spans"].items()}
    return dict(summary, spans=spans)


def _records(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("wall")
        rec.pop("dur_s", None)
        out.append(rec)
    return out


def test_summary_and_sink_match_reference(tmp_path):
    port = Telemetry(enabled=True, jsonl_path=str(tmp_path / "port.jsonl"))
    ref = JTelemetry(enabled=True, jsonl_path=str(tmp_path / "ref.jsonl"))
    _drive(port)
    _drive(ref)
    want = _wall_free(ref.summary())
    assert want.pop("gauges") == {}
    assert _wall_free(port.summary()) == want
    assert [e["name"] for e in port.events()] == \
        [e["name"] for e in ref.events()]
    spans = port.summary()["spans"]
    assert spans["leaf"]["count"] == 5
    assert "missing" not in spans
    port.close()
    ref.close()
    assert _records(tmp_path / "port.jsonl") == \
        _records(tmp_path / "ref.jsonl")


def test_disabled_is_true_noop(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tel = Telemetry(enabled=False, jsonl_path=path)
    s1 = tel.span("a", attr=1)
    assert s1 is tel.span("b") is _NULL
    with s1:
        pass
    tel.count("c")
    tel.event("e", critical=True)
    summ = tel.summary()
    assert summ["spans"] == {} and summ["counters"] == {}
    assert summ["events"] == 0
    assert tel.spans() == [] and tel.dropped_spans == 0
    tel.close()
    assert open(path).read() == ""


def test_module_default_configure():
    tel = telemetry.default()
    was = tel.enabled
    try:
        telemetry.configure(enabled=True)
        with telemetry.span("mod.span"):
            telemetry.count("mod.count")
        assert telemetry.summary()["counters"]["mod.count"] == 1
        assert telemetry.summary()["spans"]["mod.span"]["count"] == 1
    finally:
        telemetry.configure(enabled=was)
        tel.reset()
        tel.close()


@pytest.mark.faults
def test_fault_trace_survives_unflushed(tmp_path):
    """The port's engine emits detection and rollback as critical events:
    they are on disk without a flush or close."""
    import torch

    from repro_torch.serve import CAServeEngine, Fault, FaultInjector, SimJob

    path = str(tmp_path / "serve.jsonl")
    tel = Telemetry(enabled=True, jsonl_path=path)
    inj = FaultInjector([Fault(kind="bitflip", round=2, rule="fhp2",
                               lane=0, bits=1, seed=7)])
    eng = CAServeEngine(height=16, width=64, slots=2, depth=2,
                        device=torch.device("cpu"),
                        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1,
                        injector=inj, telemetry=tel)
    eng.submit(SimJob(rid=0, scenario="cylinder", steps=12))
    assert len(eng.drain()) == 1 and eng.stats["rollbacks"] == 1
    crit = [r for r in map(json.loads, open(path)) if r.get("critical")]
    assert {"serve.detection", "serve.rollback"} <= {r["name"] for r in crit}
    c = tel.summary()["counters"]
    assert c["serve.audit.recomputed"] >= 1 and c["serve.audit.fused"] >= 1
    tel.close()


def test_disabled_span_reads_no_clock(monkeypatch):
    """With telemetry off and no profiler recording, ``span`` is the
    shared null object and reads no clock."""
    def clock():
        raise AssertionError("a disabled span read the clock")

    tel = Telemetry(enabled=False)
    monkeypatch.setattr(core.time, "time", clock)
    monkeypatch.setattr(core.time, "perf_counter", clock)
    with tel.span("a", k=1) as s:
        pass
    assert s is _NULL
    assert tel.spans() == []


def _profiled(body):
    """Run ``body`` under a CPU profiler, with a clock marker recorded at
    a known wall time as the benchmark's device trace records one; return
    the profiler's events and the offset from its timeline to the wall
    clock, in seconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time()
        with record_function("test.clock"):
            pass
        mark_wall = (t0 + time.time()) / 2
        body()
    events = list(prof.profiler.kineto_results.events())
    mark = next(e for e in events if e.name() == "test.clock")
    offset = mark_wall - (mark.start_ns() + mark.duration_ns() / 2) * 1e-9
    return events, offset


def test_profiler_records_spans_of_a_disabled_instance(tmp_path):
    """Under a profiler a disabled instance records each span with its
    parent and wall-clock start and end, in memory only: no rollup, no
    sink."""
    tel = Telemetry(enabled=False, jsonl_path=str(tmp_path / "t.jsonl"))
    seen = {}

    def body():
        with tel.span("outer"):
            with tel.span("inner"):
                seen["inner"] = time.time()
            with tel.span("inner"):
                pass
        seen["after"] = time.time()

    _profiled(body)
    recs = tel.spans()
    assert [(r.name, r.parent) for r in recs] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", None)]
    inner, outer = recs[0], recs[2]
    assert inner.start <= seen["inner"] <= inner.end
    assert outer.start <= inner.start <= inner.end <= recs[1].start
    assert recs[1].end <= outer.end <= seen["after"]
    assert tel.summary()["spans"] == {}
    tel.close()
    assert open(tmp_path / "t.jsonl").read() == ""
    with tel.span("after.profile"):
        pass
    assert len(tel.spans()) == 3


def test_span_ends_agree_with_the_wall_clock():
    """A span's start is the wall clock as it opens and its end the start
    plus a monotonic duration: both agree with ``time.time()`` read beside
    them."""
    tel = Telemetry(enabled=True)
    before = time.time()
    with tel.span("s"):
        time.sleep(0.01)
    after = time.time()
    (rec,) = tel.spans()
    assert before <= rec.start and rec.end <= after + 1e-5
    assert rec.end - rec.start >= 0.01
    assert after - rec.end < 1e-3


def test_torch_op_in_a_span_lies_in_it_on_the_profiler_clock():
    """A torch op run inside a span lies within the span to 1 ms, once
    its time on the profiler's timeline is mapped to the wall clock
    through a marker."""
    tel = Telemetry(enabled=False)
    x = torch.arange(1 << 16, dtype=torch.float32)

    def body():
        with tel.span("op.span"):
            (x * 3).sum()

    events, offset = _profiled(body)
    (rec,) = tel.spans()
    ops = [e for e in events if e.name() == "aten::mul"]
    assert len(ops) == 1
    s = ops[0].start_ns() * 1e-9 + offset
    t = s + ops[0].duration_ns() * 1e-9
    assert rec.start - 1e-3 <= s <= t <= rec.end + 1e-3


def test_no_program_span_among_profiler_events():
    """Spans stay in memory: none is emitted into the profiler, where a
    range around launches would read as device work."""
    tel = Telemetry(enabled=True)

    def body():
        with tel.span("program.outer"):
            with tel.span("program.inner"):
                torch.ones(8) * 2

    events, _ = _profiled(body)
    names = {e.name() for e in events}
    assert "aten::mul" in names
    assert not {r.name for r in tel.spans()} & names


def test_span_record_is_bounded_and_counts_drops():
    tel = Telemetry(enabled=True, max_spans=4)
    for i in range(6):
        with tel.span(f"s{i}"):
            pass
    assert [r.name for r in tel.spans()] == ["s2", "s3", "s4", "s5"]
    assert tel.dropped_spans == 2
    assert tel.summary()["spans"]["s0"]["count"] == 1
    tel.reset()
    assert tel.spans() == [] and tel.dropped_spans == 0


def test_ensemble_run_is_one_span_a_call():
    """On the CPU path, ``make_ensemble_run``'s ``run`` under a profiler
    records one ``ensemble.run`` a call, its moment records' concatenation
    beneath it."""
    from repro_torch.core import distributed

    run, _ = distributed.make_ensemble_run(None, 4, variant="fhp2",
                                           steps_per_launch=2,
                                           moments_every=1)
    planes = torch.zeros((2, 8, 16, 2), dtype=torch.int32)
    tel = telemetry.default()
    tel.reset()
    try:
        def body():
            x = planes
            for t in range(3):
                x, _m = run(x, 4 * t)

        _profiled(body)
        recs = tel.spans()
    finally:
        tel.reset()
    assert [r.name for r in recs if r.parent is None] == ["ensemble.run"] * 3
    assert [r.parent for r in recs if r.name == "fhp_step.moments"] == \
        ["ensemble.run"] * 3
    assert run(planes, 0)[0].shape == planes.shape


def test_serve_round_spans_and_no_wait_in_the_kernel_span(tmp_path,
                                                          monkeypatch):
    """With telemetry on, the CPU engine records admission's and the
    checkpoint's children under their parents (the store's spans in the
    engine's own instance), never synchronises from ``serve.kernel``, and
    copies the fused moments to the host only inside ``serve.audit.wait``."""
    from repro_torch.core import carry
    from repro_torch.serve import CAServeEngine, SimJob
    from repro_torch.serve import engine as serve_engine

    tel = Telemetry(enabled=True)
    syncs = []
    monkeypatch.setattr(serve_engine, "_synchronize",
                        lambda state: syncs.append(state), raising=False)
    copies = []
    to_host = carry.moments_to_reference

    def moments_to_reference(m):
        copies.append(tel._stack()[-1])
        return to_host(m)

    monkeypatch.setattr(carry, "moments_to_reference", moments_to_reference)
    eng = CAServeEngine(height=16, width=64, slots=2, depth=2,
                        device=torch.device("cpu"),
                        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1,
                        telemetry=tel)
    eng.submit(SimJob(rid=0, scenario="cylinder", steps=6))
    eng.submit(SimJob(rid=1, scenario="bml_city", steps=4))
    assert len(eng.drain()) == 2
    parents = {}
    for r in tel.spans():
        parents.setdefault(r.name, set()).add(r.parent)
    for child in ("draw", "solid", "copy", "invariants"):
        assert parents[f"serve.admit.{child}"] == {"serve.admit"}
    assert parents["serve.checkpoint.copy"] == {"serve.checkpoint"}
    assert parents["checkpoint.save"] == {"serve.checkpoint"}
    assert parents["checkpoint.crc"] == parents["checkpoint.write"] == \
        {"checkpoint.save"}
    assert parents["serve.audit.wait"] == {"serve.audit"}
    assert "serve.kernel" in parents
    assert syncs == []
    assert copies and set(copies) == {"serve.audit.wait"}
    assert "checkpoint.save" not in telemetry.default().summary()["spans"]


def test_span_records_leave_the_garbage_collector_alone():
    """Kept records are plain tuples of strings and floats, which the
    collector stops tracking: tens of thousands kept in a window must not
    set off full collections of the whole heap."""
    import gc
    tel = Telemetry(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tel.span("s"):
                pass
    gc.collect()
    assert not any(gc.is_tracked(r) for r in tel._spans)
    assert [r.name for r in tel.spans()] == ["s"] * 3
