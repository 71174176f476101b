"""One run of one benchmark cell: load, warm up, measure, check, report.

``run_cell`` is the whole run as a function, so the CPU checks can drive
every traffic mix at a tiny size through the program's plain CPU path
(``device="cpu"`` and ``overrides``); ``run.py`` is its command line, which
always runs on the card.

Everything belonging to one configuration, traffic mix or per-layer
metric is found by name from ``BENCHMARK.json``: the configuration's file
(``configs[].file``), the traffic mix ``traffic/<traffic>.json``, the
driver ``drivers/<mix["driver"]>.py`` that generates that kind of traffic
(a new kind is a new driver file), and the metric reader
``metrics/<metric name>.py``, or, where there is none,
``metrics/<the name up to its last dot>.py``, so that one reader serves a
quantity split by the end-to-end metric it moves
(``device_idle_share.jobs`` and ``.sites``).  A driver names the keys it
reads (``CONFIG_KEYS``, ``TRAFFIC_KEYS``); a configuration or mix with any
other key is refused, so no setting is silently ignored.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in a run: JAX, and the JAX
# package the program was ported from with its benchmarks.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# Keys of a configuration that describe it and that no driver reads.
DOC_KEYS = ("name", "source", "reduced", "source_values", "assumed",
            "guarantees", "memory")


class BenchError(RuntimeError):
    """The run cannot produce a result (no card, no program, a bad cell)."""


def process_start_wall() -> Optional[float]:
    """Wall-clock time at which this process was started, from
    ``/proc/self/stat`` (10 ms ticks), or None where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None
    return time.time() - age if 0 <= age < 3600 else None


def written_bytes() -> Dict[str, int]:
    """What this process has written so far (``/proc/self/io``): ``wchar``
    bytes passed to write calls, ``write_bytes`` bytes sent to storage."""
    try:
        with open("/proc/self/io") as f:
            rows = dict(line.split(":") for line in f if ":" in line)
    except OSError:
        return {}
    return {k: int(rows[k]) for k in ("wchar", "write_bytes") if k in rows}


def forbidden_loaded() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name, compared whole, is
    one of ``FORBIDDEN_MODULES``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_benchmark(path: pathlib.Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _load_file_module(path: pathlib.Path):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(
        "cabench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """The cell ``workload`` with its configuration and traffic loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return {"cell": cell, "config": config, "traffic": traffic}


def load_driver(traffic: dict):
    """The traffic driver ``drivers/<traffic["driver"]>.py``."""
    name = traffic.get("driver", "")
    if not name.isidentifier():
        raise BenchError(f"traffic names no driver module: {name!r}")
    return importlib.import_module(f"cabench.drivers.{name}")


def refuse_unread_keys(driver, config: dict, traffic: dict) -> None:
    """Refuse a configuration or mix key that ``driver`` does not read."""
    for what, got, keys in (
            ("configuration", config, DOC_KEYS + driver.CONFIG_KEYS),
            ("traffic mix", traffic, ("driver",) + driver.TRAFFIC_KEYS)):
        extra = sorted(set(got) - set(keys))
        if extra:
            raise BenchError(f"the {what} has keys that driver "
                             f"{traffic['driver']!r} does not read: {extra}")


def reader_path(name: str) -> pathlib.Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    the file of the longest prefix of ``name`` up to a dot."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise BenchError(f"no reader for metric {name!r} under metrics/")


def metrics_for(bench: dict, workload: str):
    """``(end_to_end, per_layer)`` metric entries this cell reports."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


class Spans:
    """The benchmark's own host-side spans, on the wall clock."""

    def __init__(self):
        self.records: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.records.append((name, t0, time.time()))


class Run:
    """What a driver fills in during a run, and metric readers read.

    ``e2e``: end-to-end values by metric name; ``checks``: ``(name, value,
    limit)`` of every number compared (a run is correct when each value is
    at most its limit);
    ``counters``: counts over the window (calls, rounds, jobs, and the
    program's own counters); ``spans``: the benchmark's host-side spans;
    ``trace``: the ``trace.DeviceTrace`` of the window."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device,
                 hooks=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.traced = int(seed), seconds, trace
        self.device = device
        self.hooks = dict(hooks or {})
        self.spans = Spans()
        self.e2e: Dict[str, float] = {}
        self.checks: List[tuple] = []
        self.counters: Dict[str, float] = {}
        self.trace = None
        self.attempted = 0
        self.failed = 0
        self.window_s = 0.0
        self.window_wall = (0.0, 0.0)
        self.memory_peak_bytes = 0

    def check(self, name: str, value, limit) -> None:
        self.checks.append((name, value, limit))


def _device_info(device) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    return {"platform": device.type, "kind": device.type, "count": 1}


def require_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: Optional[dict] = None,
             overrides: Optional[dict] = None, hooks: Optional[dict] = None,
             started: Optional[float] = None) -> dict:
    """Run cell ``workload`` once and return its result object.

    ``overrides`` (``{"config": {...}, "traffic": {...}}``) change keys of
    the configuration and traffic mix, for the CPU checks' tiny sizes;
    ``hooks`` lets a check or a control replace parts of a run (see the
    drivers).  ``started`` is the wall time the process started (default:
    read from ``/proc``, else now)."""
    started = started or process_start_wall() or time.time()
    bench = bench or load_benchmark()
    found = resolve(bench, workload)
    cell = found["cell"]
    for key in ("config", "traffic"):
        found[key].update((overrides or {}).get(key, {}))
    driver = load_driver(found["traffic"])
    refuse_unread_keys(driver, found["config"], found["traffic"])
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        require_card(int(cell["chips"]))
    e2e_entries, per_entries = metrics_for(bench, workload)
    run = Run(cell, found["config"], found["traffic"], seed, seconds,
              bool(trace), dev, hooks)
    from cabench import trace as dtrace
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = driver.setup(run)
    with (dtrace.DeviceTrace(dev) if run.traced
          else contextlib.nullcontext()) as run.trace:
        setup_s = time.time() - started
        driver.window(run, state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if run.trace is not None:
        run.trace.read(run.window_wall, run.spans.records)
    t = time.time()
    driver.check(run, state)
    del state
    run.e2e["setup_s"] = setup_s
    print(f"cabench: {workload} seed {seed}: set-up {setup_s:.3f} s, "
          f"window {run.window_s:.3f} s, check {time.time() - t:.3f} s, "
          f"wrote {written_bytes()}, {json.dumps(run.counters)}, "
          f"{json.dumps(run.e2e)}",
          file=sys.stderr)
    return result(run, e2e_entries, per_entries)


def result(run: Run, e2e_entries, per_entries) -> dict:
    metrics = {}
    if not run.traced:
        for m in e2e_entries:
            if m["name"] not in run.e2e:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in per_entries:
            reader = _load_file_module(reader_path(m["name"]))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = _device_info(run.device)
    device["memory_peak_bytes"] = run.memory_peak_bytes
    out = {"correct": all(v <= lim for _, v, lim in run.checks)
           and bool(run.checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in run.checks}
    return out
