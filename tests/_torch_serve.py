"""Shared helpers of the serve-engine parity tests (``test_torch_serve``,
``test_torch_slo``, ``test_torch_checkpoint``): build the reference's and
the port's engines with the same arguments, and hold everything they
report that does not depend on the wall clock equal."""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.serve import AdmissionError as JAdmissionError
from repro.serve import CAServeEngine as JEngine
from repro.serve import Fault as JFault
from repro.serve import FaultInjector as JInjector
from repro.serve import SimJob as JSimJob
from repro.serve import TenantConfig as JTenantConfig
from repro_torch.serve import (AdmissionError, CAServeEngine, Fault,
                               FaultInjector, SimJob, TenantConfig)

CPU = torch.device("cpu")
H, W = 32, 128

# Stats that count wall-clock events (stragglers, budget breaches).
_WALL_STATS = ("stragglers_detected", "overloaded_rounds")


@contextlib.contextmanager
def reference_runner_cache():
    """Reuse the reference engine's lane-group runners across the engines
    of a test module.  Each new reference engine jit-compiles its runners
    again, and at test sizes that compilation is nearly all of its time;
    the runner is a pure function of ``make_ensemble_run``'s arguments,
    so sharing it changes no result."""
    from repro.core import distributed
    orig = distributed.make_ensemble_run
    cached = functools.lru_cache(maxsize=None)(
        lambda mesh, steps, **kw: orig(mesh, steps, **kw))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distributed, "make_ensemble_run",
                   lambda mesh, steps, **kw: cached(mesh, steps, **kw))
        yield


class Pair:
    """The same engine arguments, jobs and fault schedule through both
    packages: ``ref`` (``repro``) and ``port`` (``repro_torch``, on CPU
    slots).  ``faults`` are ``Fault`` keyword dicts; ``tenants``
    ``TenantConfig`` keyword dicts by name."""

    def __init__(self, faults=None, tenants=None, ckpt_dirs=(None, None),
                 mesh=None, **kw):
        kw = dict(dict(height=H, width=W), **kw)
        self.ref_inj = self.port_inj = None
        if faults is not None:
            self.ref_inj = JInjector([JFault(**f) for f in faults])
            self.port_inj = FaultInjector([Fault(**f) for f in faults])
        jt = pt = None
        if tenants is not None:
            jt = {n: JTenantConfig(n, **c) for n, c in tenants.items()}
            pt = {n: TenantConfig(n, **c) for n, c in tenants.items()}
        self.ref = JEngine(injector=self.ref_inj, tenants=jt,
                           ckpt_dir=ckpt_dirs[0], **kw)
        self.port = CAServeEngine(injector=self.port_inj, tenants=pt,
                                  ckpt_dir=ckpt_dirs[1], mesh=mesh,
                                  device=CPU, **kw)

    def engines(self):
        return self.ref, self.port

    def submit(self, **job):
        """Submit one job to both; return the two outcomes (None or the
        typed refusal's class name)."""
        out = []
        for eng, cls in ((self.ref, JSimJob), (self.port, SimJob)):
            try:
                eng.submit(cls(**job))
                out.append(None)
            except (JAdmissionError, AdmissionError) as e:
                out.append(type(e).__name__)
        assert out[0] == out[1], out
        return out[0]

    def tick(self):
        for eng in self.engines():
            eng.tick()

    def drain(self, **kw):
        return [sorted(j.rid for j in eng.drain(**kw))
                for eng in self.engines()]

    def check(self):
        assert_same_outcome(self.ref, self.port, self.ref_inj,
                            self.port_inj)


def submit_mixed(pair, n=3, steps=8, frame_every=0):
    """cylinder (fhp2) + bml_city jobs: two lane groups."""
    for rid in range(n):
        sc = "bml_city" if rid % 3 == 1 else "cylinder"
        pair.submit(rid=rid, scenario=sc, steps=steps,
                    frame_every=frame_every, overrides={"seed": rid})


def wall_free_stats(eng) -> dict:
    out = {k: v for k, v in eng.stats.items() if k not in _WALL_STATS}
    out["recovery"] = [{k: v for k, v in r.items() if k != "restore_s"}
                       for r in eng.stats["recovery"]]
    return out


def _job_view(job) -> dict:
    return {k: getattr(job, k) for k in (
        "status", "lane", "admitted_t", "steps_done", "expected",
        "with_momentum", "segments", "preemptions", "frames",
        "shed_reason", "frame_slo_violations", "tenant")}


def assert_same_outcome(ref, port, ref_inj=None, port_inj=None):
    """Every wall-free thing the two engines report is equal, and every
    lattice they hold on the host is equal word for word."""
    assert ref.round == port.round
    assert sorted(ref.jobs) == sorted(port.jobs)
    for rid, rj in ref.jobs.items():
        pj = port.jobs[rid]
        assert _job_view(pj) == _job_view(rj), rid
        for name in ("result", "parked_state"):
            a, b = getattr(rj, name), getattr(pj, name)
            assert (a is None) == (b is None), (rid, name)
            if a is not None:
                assert b.dtype == np.uint32 and np.array_equal(a, b), \
                    (rid, name)
    assert port.detections == ref.detections
    assert wall_free_stats(port) == wall_free_stats(ref)
    assert port.queue == ref.queue
    strip = lambda log: [{k: v for k, v in e.items()
                          if k not in ("wall", "retry_after_s")}
                         for e in log]
    assert strip(port.frame_log) == strip(ref.frame_log)
    # A refusal's backoff hint reads the bucket's clock or the measured
    # round time: compared without it.
    assert strip(port.rejections) == strip(ref.rejections)
    assert port.shed_log == ref.shed_log
    assert sorted(port.groups) == sorted(ref.groups)
    if ref_inj is not None:
        assert [dataclasses.astuple(e) for e in port_inj.events] == \
            [dataclasses.astuple(e) for e in ref_inj.events]
