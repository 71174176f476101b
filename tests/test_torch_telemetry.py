"""The port's telemetry layer against the reference's: the same span,
count, gauge and event sequence gives the same wall-free summary and the
same JSONL records; the disabled path is a no-op; a span opened while
``torch.compile`` traces is recorded as traced; critical events reach the
sink through the port's serve engine without a flush."""
import json

import pytest

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
    tel.gauge("depth", 7)
    tel.gauge("depth", 2.5)
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
    assert _wall_free(port.summary()) == _wall_free(ref.summary())
    assert [e["name"] for e in port.events()] == \
        [e["name"] for e in ref.events()]
    assert port.span_stats("leaf")["count"] == 5
    assert port.span_stats("missing") is None
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
    tel.gauge("g", 1)
    tel.event("e", critical=True)
    summ = tel.summary()
    assert summ["spans"] == {} and summ["counters"] == {}
    assert summ["events"] == 0
    tel.close()
    assert open(path).read() == ""


def test_span_while_compiling_is_traced(monkeypatch):
    """While ``torch.compile`` traces, a span names the region with
    ``record_function`` and rolls up as a traced count, not a wall
    time."""
    tel = Telemetry(enabled=True)
    monkeypatch.setattr(core.torch.compiler, "is_compiling", lambda: True)
    with tel.span("traced.region"):
        pass
    monkeypatch.undo()
    with tel.span("wall.region"):
        pass
    spans = tel.summary()["spans"]
    assert spans["traced.region"] == {"traced_count": 1}
    assert spans["wall.region"]["count"] == 1
    assert not core._tracing()


def test_module_default_configure():
    tel = telemetry.default()
    was = tel.enabled
    try:
        telemetry.configure(enabled=True)
        with telemetry.span("mod.span"):
            telemetry.count("mod.count")
        assert telemetry.summary()["counters"]["mod.count"] == 1
        assert telemetry.span_stats("mod.span")["count"] == 1
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
