"""Closed loop of clients of the CA serve engine (``CAServeEngine``).

Each of ``clients`` clients submits a job of ``job_steps`` steps (frames
every ``frame_every``), the scenarios of ``scenarios`` in turn (client c's
k-th job is ``scenarios[(c + k) % n]``, seeded ``seed * 4096 + its number``),
and submits its next job when the result is on the host; the driver loops
``tick()``.  Set-up runs one job of each scenario through, then primes the
loop until ``prime_jobs`` results have come back.

Each scenario's parameters (``rule``, ``density``, ``p_force``) are the
configuration's ``scenarios``, and both sides get them: the program as the
job's overrides, once set-up has checked that its scenario then states
them (a value it cannot take is refused), and the reference directly.

The program's telemetry is off in every run, so that a traced run takes
the path an untraced one times (with telemetry on, the engine waits for
the card after each group's launches).  The benchmark times the engine on
the host clock with spans of its own: each round (``serve.tick``), the
engine's admission step within it (``serve.admit``, around
``CAServeEngine._admit``), and the clients' collection (``serve.collect``).

``correct``: ``check_jobs`` jobs drawn from the seed among those finished
in the window; each job's initial lattice is rebuilt from its spec by the
reference and stepped from the job's start step, and its result and every
frame are compared.

Hooks: ``make_run`` replaces ``make_ensemble_run`` inside the engine
(faults, the control).

No cell of ``BENCHMARK.json`` runs this driver at present: the engine's
host-bound rate spread from run to run past the largest bound (PERF.md).
``checks/check_harness.py`` keeps it, its configuration and its mix
working, so that a serve cell can come back as data files.
"""
from __future__ import annotations

import contextlib
import random
import shutil
import tempfile
import time

import numpy as np
import torch

from cabench.reference import lattice, scenarios as ref_scenarios

CONFIG_KEYS = ("height", "width", "slots", "depth", "steps_per_launch",
               "audit_every", "ckpt_every", "keep", "scenarios")
TRAFFIC_KEYS = ("clients", "job_steps", "frame_every", "scenarios",
                "prime_jobs", "check_jobs")
PROGRAM_PARAMS = ("density", "p_force")


class _Client:
    def __init__(self, cid: int):
        self.cid, self.k = cid, 0
        self.job = None
        self.submitted = 0.0


@contextlib.contextmanager
def _replaced_make_run(run):
    make = run.hooks.get("make_run")
    if make is None:
        yield
        return
    from repro_torch.core import distributed
    orig = distributed.make_ensemble_run
    distributed.make_ensemble_run = make
    try:
        yield
    finally:
        distributed.make_ensemble_run = orig


def _params(run, name: str) -> dict:
    params = run.config["scenarios"].get(name)
    if params is None:
        from cabench.harness import BenchError
        raise BenchError(f"the traffic's scenario {name!r} is not among the "
                         f"configuration's {sorted(run.config['scenarios'])}")
    return params


def _refuse_unstated(run) -> None:
    """Refuse a scenario whose program build does not state the
    configuration's rule, density and forcing."""
    from repro_torch import scenarios
    from cabench.harness import BenchError
    cfg = run.config
    for name in run.traffic["scenarios"]:
        params = _params(run, name)
        want = (params["rule"], params["density"], params.get("p_force", 0.0))
        try:
            sc = scenarios.get(name, height=cfg["height"], width=cfg["width"],
                               **_overrides(params))
            got = (sc.variant, sc.density, sc.p_force)
        except TypeError as err:
            got = err
        if got != want:
            raise BenchError(f"scenario {name!r}: the program builds {got}, "
                             f"the configuration states {want}")


def _overrides(params: dict) -> dict:
    """The program's scenario builder's arguments of ``params``: its
    density, and its forcing where one is stated (BML's builder takes
    none, and a scenario that states none has no forcing)."""
    return {k: params[k] for k in PROGRAM_PARAMS if k in params}


def _timed_admission(run, admit):
    def timed():
        with run.spans("serve.admit"):
            return admit()
    return timed


def setup(run):
    from repro_torch.serve.engine import CAServeEngine
    from repro_torch.telemetry import Telemetry
    cfg, tr = run.config, run.traffic
    _refuse_unstated(run)
    tmp = tempfile.mkdtemp(prefix="cabench-serve-")
    with _replaced_make_run(run):
        eng = CAServeEngine(
            height=cfg["height"], width=cfg["width"], slots=cfg["slots"],
            depth=cfg["depth"], steps_per_launch=cfg["steps_per_launch"],
            device=run.device, audit_every=cfg["audit_every"],
            ckpt_dir=f"{tmp}/ckpt", ckpt_every=cfg["ckpt_every"],
            keep=cfg["keep"], telemetry=Telemetry(enabled=False))
        eng._admit = _timed_admission(run, eng._admit)
        st = {"eng": eng, "tmp": tmp,
              "clients": [_Client(c) for c in range(tr["clients"])],
              "rid": 0, "finished": [], "lat": [], "failed": 0}
        try:
            _warm(run, st)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    return st


def _job(run, st, scenario: str, steps: int):
    from repro_torch.serve.engine import SimJob
    rid = st["rid"]
    st["rid"] += 1
    return SimJob(rid=rid, scenario=scenario, steps=steps,
                  frame_every=run.traffic["frame_every"],
                  overrides={"seed": (run.seed % 2 ** 62) * 4096 + rid,
                             **_overrides(_params(run, scenario))})


def _submit(run, st, c: _Client):
    tr = run.traffic
    names = tr["scenarios"]
    c.job = _job(run, st, names[(c.cid + c.k) % len(names)],
                 tr["job_steps"])
    c.k += 1
    c.submitted = time.perf_counter()
    st["eng"].submit(c.job)


def _collect(run, st, record: bool) -> int:
    """Clients whose job ended take its result and submit their next;
    returns how many results came back."""
    from repro_torch.serve.engine import DONE, QUARANTINED, SHED
    got = 0
    now = time.perf_counter()
    for c in st["clients"]:
        if c.job is None or c.job.status not in (DONE, QUARANTINED, SHED):
            continue
        if c.job.status == DONE:
            got += 1
            if record:
                st["finished"].append(c.job)
                st["lat"].append(now - c.submitted)
        elif record:
            st["failed"] += 1
        _submit(run, st, c)
    return got


def _warm(run, st):
    eng, tr = st["eng"], run.traffic
    for name in tr["scenarios"]:
        eng.submit(_job(run, st, name, tr["job_steps"]))
    eng.drain()
    for c in st["clients"]:
        _submit(run, st, c)
    got = 0
    while got < tr["prime_jobs"]:
        eng.tick()
        got += _collect(run, st, record=False)


def window(run, st):
    try:
        _window(run, st)
    except BaseException:
        shutil.rmtree(st["tmp"], ignore_errors=True)
        raise


def _window(run, st):
    eng = st["eng"]
    rounds = 0
    w0 = time.time()
    p0 = time.perf_counter()
    deadline = p0 + run.seconds
    while time.perf_counter() < deadline:
        with run.spans("serve.tick"):
            eng.tick()
        rounds += 1
        with run.spans("serve.collect"):
            _collect(run, st, record=True)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    p1 = time.perf_counter()
    run.window_wall = (w0, w0 + (p1 - p0))
    run.window_s = p1 - p0
    lat = sorted(st["lat"])
    run.e2e["jobs_per_s"] = len(lat) / run.window_s
    if lat:
        run.e2e["job_latency_p95_s"] = lat[-(-95 * len(lat) // 100) - 1]
    run.counters.update(rounds=rounds, jobs=len(lat))
    run.counters["jobs_admitted"] = sum(
        1 for j in eng.jobs.values()
        if j.admitted_t >= (eng.round - rounds) * eng.round_steps)
    run.attempted = len(lat) + st["failed"] + len(st["clients"])
    run.failed = st["failed"]


def check(run, st):
    try:
        _check_jobs(run, st)
    finally:
        shutil.rmtree(st["tmp"], ignore_errors=True)


def _frames_differing(got: dict, want: dict) -> int:
    """Frames, by step, missing from one side or unequal."""
    return sum(1 for s in set(want) | set(got) if got.get(s) != want.get(s))


def _check_jobs(run, st):
    cfg, tr = run.config, run.traffic
    jobs = sorted(st["finished"], key=lambda j: j.rid)
    sample = random.Random(run.seed).sample(jobs,
                                            min(tr["check_jobs"], len(jobs)))
    run.check("jobs_failed", run.failed, 0)
    sites = frames = 0
    for job in sample:
        params = _params(run, job.scenario)
        rule = params["rule"]
        s = ref_scenarios.initial_state(job.scenario, cfg["height"],
                                        cfg["width"], job.overrides["seed"],
                                        params["density"], run.device)
        step = lattice.stepper(rule, run.device, params.get("p_force", 0.0))
        want = {}
        for k in range(job.steps):
            s = step.step(s, job.admitted_t + k)
            if job.frame_every and (k + 1) % job.frame_every == 0:
                want[k + 1] = lattice.frame(s, rule, job.admitted_t + k + 1,
                                            k + 1)
        got = lattice.to_bytes(torch.from_numpy(job.result.view(np.int32))
                               .to(run.device))
        sites += lattice.sites_differing(got, s)
        frames += _frames_differing(job.frames, want)
    run.check("jobs_checked_short", tr["check_jobs"] - len(sample), 0)
    run.check("sites_differing", sites, 0)
    run.check("frames_differing", frames, 0)
