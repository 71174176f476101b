#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and
check it against the port's plain PyTorch version.

    python3 chip_smoke.py          # from the repo root, on a machine with a card

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device and build: the card's name and power limit, torch and CUDA
   versions, the kernel's nvcc build time, ptxas registers and spills per
   instantiation, resident blocks per SM of each mode at its main tile
   (``ops.kernel_info``; its shared bytes held equal to ``ops.smem_bytes``,
   which ``pick_tile`` sizes tiles by), the compiled instructions of one
   word-step per
   pipe (``kernels/fhp_step/opcount.py``), which set its bound, and the
   instructions of the built kernel's round loop (``cuobjdump -sass``);
2. parity sweep: the kernel against ``fhp_step_ref`` on the card, bit for
   bit, over fhp2/fhp3/bml x T in {1,2,4,8} x B in {1,3} x p_force in
   {0, 0.05} x four tiles, static-solid included (``kernels/fhp_step/
   check.py``), on 256 x 4000- and 256 x 4096-node lattices (the second
   takes the kernel's 16-byte copies);
3. main path: ``core.distributed.make_ensemble_run`` -- the serve engine's
   call -- for 64 fhp2 steps (T = 8, moments every 8) on 4 lanes of the
   4096 x 32768 cylinder scenario; mass conserved at every recorded step,
   the first launch bit-equal to the plain version, and the static-solid
   twin of lane 0 bit-equal to the 8-plane run.  The counted run is timed
   launch by launch (CUDA events around each launch with its output's
   allocation, the gaps between launches, host time to enqueue, memory
   segments allocated), then timed again ``MAIN_REPEATS`` times: median,
   least and most;
4. times: kernel ms per launch (CUDA events, 20 launches after warm-up),
   site updates per second and the plain version's ms per launch, at
   T in {1, 8} and T = 8 static-solid, beside the card's name and power
   limit; each timed launch is first held bit-equal to its plain version;
   then the T = 8 launch at each tile shape of ``TILES`` (held bit-equal
   to the launch above), a band wider than a block covers (bit-equal at
   T = 1), the per-step time at T in {1, 2, 4, 8}, and the
   main tile's launch time at those T fitted against the word-steps it
   issues (what a launch costs besides its steps: loads, stores);
5. extended and K2 parity: the kernel's extended-shard mode through
   ``ops.run_extended`` (y0 = -T, xw0 = -1, global extents larger than the
   array; validity window and moments) and its precomputed-RNG mode
   against the plain version, bit for bit, over the same cases, tiles and
   lattices;
6. the sharded path: phase 3's state through ``make_ensemble_run`` on a
   2 x 2 ("data", "model") mesh of four slots on the one card (depth 8,
   T = 8, moments every 8), with and without ``overlap``, bit-equal to
   phase 3's planes and moments, each then timed ``MAIN_REPEATS`` times; ``make_run(static_solid=True)`` bit-equal
   to ``run_cuda`` of the same stack; and the precomputed-RNG path
   (``run_cuda(rng_in_kernel=False)``, 8 one-step launches) bit-equal to
   phase 3's first launch.  Every launch counter is set to 0 before each
   path and read after it;
7. times of the sharded path: wall time and site updates per second
   against phase 3's, the exchange and kernel time of one round, the
   extended launch (and its static-solid twin) at the shard shape, each
   piece of ``run_extended_split``, and a precomputed-RNG launch against
   a T = 1 launch, each with its bound and its plain version's time, and
   each held bit-equal to its plain version on the same inputs (extended
   launches on their validity window, with their moments) first;
8. the serve path (``serve.CAServeEngine``, with telemetry on):
   a. full width, clean: 4 slots, depth 8, T = 8, audits every round,
      checkpoints every 4 rounds (keep 2) in a temporary directory; 4
      cylinder jobs (seeds 0-3) and 4 bml_city jobs (seeds 0-3) of 64
      steps with a frame every 16, then ``drain()``.  Every job done; the
      cylinder results bit-equal to phase 3's lanes, the bml results to
      ``make_ensemble_run(None, 64, variant="bml")`` of the same lanes,
      the bml group's first round (planes and moments) to
      ``fhp_step_ref``; every audit read fused moments; no detection; the
      kernel launched every round of each group.  Prints the round walls,
      each ``serve.*`` span's total, admission (lattice set-up) per job,
      checkpoint seconds and bytes, jobs/s and site updates/s against
      phase 3's, and ``_modeled_round_s()`` (which must not exceed the
      median round);
   b. faults at full width: 2 slots, seeds 0-1, checkpoints every 2
      rounds; a bitflip on the fhp2 group at round 2, a nan_shard on the
      bml group at round 3, a torn round-4 checkpoint and a killed_step at
      round 6, then ``CAServeEngine.resume``.  Both corruptions detected
      and rolled back, the torn checkpoint refused by
      ``verify_checkpoint``, every result bit-equal to 8a's;
   c. the engine on a 2 x 2 mesh of four slots on the card against the
      single-device engine, 1024 x 8192 lattices, fhp3 (cylinder) and bml
      jobs, 32 steps, with a bitflip rolled back on the mesh (checkpoint
      restored onto the mesh, invariants recomputed on the shards):
      results and frames bit-equal, the mesh engine through the kernel's
      extended-shard mode only.

Every entry's ``max_abs_err`` comes from its timed launch held against the
plain version.

It ends with a kernels line and, last, ``{"ok": true, "device": ...}``.
The K1/K3/K4 entries add ``launches_serve`` (phase 8a's launches) and the
K5 entry ``launches_serve_mesh`` (phase 8c's mesh engine).
"""
import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

LANES, HEIGHT, WIDTH = 4, 4096, 32768
STEPS, T_MAIN, P_FORCE = 64, 8, 0.03
MAIN_REPEATS = 7   # timed runs of the main and sharded paths after the first
SWEEP_H, SWEEP_WD = 256, 125
# A second sweep width whose rows take the kernel's 16-byte copies.
SWEEP_WD_ALIGNED = 128
HBM_BYTES_PER_S = 3.35e12
MESH = ((2, 2), ("data", "model"))
DEPTH = 8
# Tile shapes (rows x words) timed at T = 8 in phase 4.
TILES = ((32, 32), (48, 32), (64, 32), (64, 64), (32, 48), (40, 48),
         (64, 48), (32, 112))
# Phase 8: the serve path.
SERVE_FRAME_EVERY, SERVE_CKPT_EVERY = 16, 4
SERVE_MESH_HW, SERVE_MESH_STEPS = (1024, 8192), 32
SOURCE = "src/repro_torch/kernels/fhp_step/csrc/fhp_step.cu"
REPLACES = "src/repro/kernels/fhp_step/kernel.py:330"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _bound_ms(x, T, n_rec, static, counted, owned=None, step="step",
              extra_planes=0):
    """(ops ms, the pipe that sets it, bytes ms) of one fhp2 launch on
    stack ``x``: the compiled instructions (``opcount``, ``step`` or the
    precomputed-RNG ``pre``) of every word-step of the ``owned`` (rows,
    words) of each lane (default: all of it), and each plane word read
    and written once, plus the solid plane, ``extra_planes`` more read-only
    ``(H, Wd)`` planes and the moments."""
    from repro_torch.core import rulespec
    from repro_torch.kernels.fhp_step import opcount
    lanes, nps, h, wd = x.shape
    rows, words = owned or (h, wd)
    ops_ms, pipe = opcount.ops_ms(
        lanes * rows * words * T,
        opcount.per_word_step(counted, n_rec / T, step))
    n_moments = rulespec.moment_spec(rulespec.get_rule("fhp2"),
                                     nps).n_moments
    n_bytes = 4 * (2 * x.numel() + h * wd * (int(static) + extra_planes)
                   + lanes * n_rec * n_moments)
    return ops_ms, pipe, n_bytes / HBM_BYTES_PER_S * 1e3


def _apron(bh, bw, T) -> float:
    """Word-steps a (bh, bw) tile computes at T per word-step it owns."""
    return sum((bh + 2 * (T - s) - 2) * (bw + 2 * (T - s) - 2)
               for s in range(T)) / (T * bh * bw)


def _lanes(bh, bw, T) -> float:
    """Thread word-steps a tile issues (whole warps per row) per word-step
    it owns."""
    w = -(-(bw + 2 * T) // 32) * 32
    return sum((bh + 2 * (T - s) - 2) * w for s in range(T)) / (T * bh * bw)


def _max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _reset_counts():
    from repro_torch.kernels.fhp_step import ops
    ops.LAUNCHES.clear()


def _counts():
    from repro_torch.kernels.fhp_step import ops
    return ops.launches_total(), dict(ops.LAUNCHES)


def _entry(name, mode, launches, timed, card, **extra):
    """One kernel line entry from ``timed`` = (kernel ms, plain ms, ops ms,
    bytes ms, pipe, max_abs_err against the plain version)."""
    k_ms, p_ms, ops_ms, bytes_ms, pipe, max_abs_err = timed
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "mode": mode, "launches": launches,
            "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_pipe": pipe if ops_ms >= bytes_ms else "memory",
            "library_ms": None, "checked_vs_plain": True, "card": card,
            **extra}


def _time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def _launch_events(store):
    """While open, every kernel launch appends (start, end) CUDA events
    recorded around it to ``store`` (the launch counts are untouched)."""
    from repro_torch.kernels.fhp_step import ops
    inner = ops._launch

    def timed(*args):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(*args)
        ev[1].record()
        store.append(ev)
        return out

    ops._launch = timed
    try:
        yield
    finally:
        ops._launch = inner


def _segments() -> int:
    """Device memory segments the caching allocator has taken so far (its
    cudaMalloc calls)."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def _path_run(run, *args):
    """``(result, times)`` of one call ``run(*args)``: wall seconds to its
    device synchronisation, host seconds until it returned, from CUDA
    events around each kernel launch (its output's allocation included)
    the launch ms summed, the ms from the call to its first launch's
    start and the gaps between launches (ms, summed and largest), and the
    device memory segments the call allocated."""
    ev = []
    torch.cuda.synchronize()
    seg = _segments()
    start = torch.cuda.Event(enable_timing=True)
    with _launch_events(ev):
        t = time.perf_counter()
        start.record()
        res = run(*args)
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    gaps = [a[1].elapsed_time(b[0]) for a, b in zip(ev, ev[1:])]
    return res, {"wall_s": wall_s, "host_s": host_s,
                 "kernel_ms": sum(a.elapsed_time(b) for a, b in ev),
                 "lead_ms": start.elapsed_time(ev[0][0]) if ev else 0.0,
                 "gap_ms": sum(gaps), "max_gap_ms": max(gaps, default=0.0),
                 "segments": _segments() - seg}


def _fmt_run(r) -> str:
    return (f"wall {r['wall_s']:.4f} s (host returned after {r['host_s']:.4f}"
            f" s), launches {r['kernel_ms']:.4f} ms, first launch "
            f"{r['lead_ms']:.4f} ms after the call, gaps between launches "
            f"{r['gap_ms']:.4f} ms (largest {r['max_gap_ms']:.4f}), "
            f"{r['segments']} memory segments allocated")


def _repeats(label, card, run, *args) -> float:
    """Times ``run(*args)`` ``MAIN_REPEATS`` times; prints every run and
    the median and spread of the walls, returns the median wall seconds."""
    walls = []
    for i in range(MAIN_REPEATS):
        res, r = _path_run(run, *args)
        del res   # each run finds the memory the last one freed
        walls.append(r["wall_s"])
        print(f"[repeat] {card} | {label} run {i + 1}: {_fmt_run(r)}")
    med = statistics.median(walls)
    print(f"[time] {card} | {label}: median {med:.4f} s of {MAIN_REPEATS} "
          f"runs after the first (least {min(walls):.4f}, most "
          f"{max(walls):.4f})")
    return med


def _extended_sweeps(dev) -> None:
    """Phase 5: the extended-shard and precomputed-RNG sweeps on the card."""
    from repro_torch.kernels.fhp_step import check
    n_tiles = len(check._tiles(1, SWEEP_WD))
    for name, cases, run_case, wd in (
            ("extended", check.CASES, check.run_extended_case, SWEEP_WD),
            ("extended", check.CASES, check.run_extended_case,
             SWEEP_WD_ALIGNED),
            ("K2", check.K2_CASES, check.run_k2_case, SWEEP_WD),
            ("K2", check.K2_CASES, check.run_k2_case, SWEEP_WD_ALIGNED)):
        t = time.perf_counter()
        bad = []
        _reset_counts()
        for i, case in enumerate(cases):
            bad += run_case(case, dev, SWEEP_H, wd, seed=i)
        torch.cuda.synchronize()
        _, modes = _counts()
        if bad:
            print("\n".join(bad[:20]))
            raise AssertionError(f"{name} sweep: {len(bad)} mismatches")
        # Every K2 case (one launch per tile) must run the K2 kernel.
        if name == "K2" and modes.get("precomputed_rng") != n_tiles * len(
                cases):
            raise AssertionError(f"K2 sweep made launches {modes}")
        print(f"[sweep] {name}: {len(cases)} cases x {n_tiles} tiles on "
              f"{SWEEP_H} x {wd * 32} nodes: 0 mismatches, launches by mode "
              f"{modes} ({time.perf_counter() - t:.1f} s)")


def _held(label, got, want, window=None) -> int:
    """The max_abs_err of a kernel launch's output ``got`` against its plain
    version's ``want`` -- planes (on ``window`` = (rows, words) when given)
    and moments; raises unless it is 0."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 0 and window is not None:
            a, b = a[..., window[0], window[1]], b[..., window[0], window[1]]
        e = _max_abs_err(a, b) if a.shape == b.shape else -1
        if e:
            from repro_torch.kernels.fhp_step import check
            raise AssertionError(
                f"{label}: {'moments' if i else 'planes'} differ from the "
                f"plain version first at {check.first_difference(a, b)}")
        err = max(err, e)
    return err


def _timed(label, fn, plain, x, T, n_rec, static, counted, window=None,
           **bound):
    """(kernel ms, plain ms, ops ms, bytes ms, pipe, max_abs_err) of one
    launch ``fn``, held against its plain version ``plain`` first."""
    err = _held(label, fn(), plain(), window)
    k_ms = _time_ms(fn, reps=20)
    p_ms = _time_ms(plain, reps=2, warmup=1)
    ops_ms, pipe, bytes_ms = _bound_ms(x, T, n_rec, static, counted, **bound)
    return k_ms, p_ms, ops_ms, bytes_ms, pipe, err


def _print_time(card, label, timed, sites_updates=None):
    k_ms, p_ms, ops_ms, bytes_ms, pipe, _ = timed
    rate = (f" ({sites_updates / (k_ms * 1e-3):.4e} site-updates/s)"
            if sites_updates else "")
    print(f"[time] {card} | {label}: kernel {k_ms:.4f} ms/launch{rate}, "
          f"plain {p_ms:.2f} ms/launch, bound {max(ops_ms, bytes_ms):.4f} ms "
          f"(instructions {ops_ms:.4f} ms, set by {pipe}; bytes "
          f"{bytes_ms:.4f} ms)")


def _sharded_path(dev, planes, out, mom, first, main_s, card, counted,
                  timed_t1):
    """Phases 6 and 7: the sharded path and the precomputed-RNG path, each
    held bit-equal to phase 3's single-device results, then their times.
    Returns the kernels line's entries of modes K5, K6 (extended) and K2."""
    from repro_torch.core import distributed
    from repro_torch.kernels.fhp_step import check, ops, ref

    # -- 6. the sharded path --------------------------------------------------
    mesh = distributed.make_mesh(*MESH, devices=dev)
    rounds, shards = STEPS // DEPTH, mesh.size
    kw = dict(variant="fhp2", p_force=P_FORCE, depth=DEPTH,
              steps_per_launch=T_MAIN, moments_every=T_MAIN)
    walls, modes = {}, {}
    for overlap in (False, True):
        run, sharding = distributed.make_ensemble_run(mesh, STEPS,
                                                      overlap=overlap, **kw)
        placed = sharding.place(planes)
        _reset_counts()
        (sout, smom), first_run = _path_run(run, placed, 0)
        launches, modes[overlap] = _counts()
        want = rounds * shards * (5 if overlap else 1)
        if launches != want or modes[overlap].get("extended") != want:
            raise AssertionError(f"sharded run (overlap={overlap}) made "
                                 f"{modes[overlap]} launches, not {want}")
        got = sout.gather()
        for name, a, b in (("planes", got, out), ("moments", smom, mom)):
            where = check.first_difference(a, b)
            if where is not None:
                raise AssertionError(f"sharded run (overlap={overlap}): "
                                     f"{name} differ first at {where}")
        print(f"[sharded] {mesh} of {shards} slots on {dev}, depth {DEPTH}, "
              f"overlap={overlap}: first run {_fmt_run(first_run)}; launches "
              f"by mode {modes[overlap]}; planes and moments bit-equal to the "
              f"single-device run")
        del got, sout, smom
        walls[overlap] = _repeats(f"sharded run, overlap={overlap}", card,
                                  run, placed, 0)

    full = planes.clone()
    full[:, 7] = planes[0, 7]
    run = distributed.make_run(mesh, STEPS, static_solid=True, batched=True,
                               **dict(kw, moments_every=0))
    placed_full = sharding.place(full)
    torch.cuda.synchronize()
    _reset_counts()
    sres = run(placed_full, 0)
    torch.cuda.synchronize()
    _, static_modes = _counts()
    if static_modes.get("extended_static_solid") != rounds * shards:
        raise AssertionError(f"static-solid sharded run made {static_modes}")
    twin = ops.run_cuda(full, STEPS, p_force=P_FORCE,
                        steps_per_launch=T_MAIN)
    got = sres.gather()
    where = check.first_difference(got, twin)
    if where is not None:
        raise AssertionError(f"static-solid sharded run differs first at "
                             f"{where}")
    print(f"[sharded] static_solid=True, batched: launches by mode "
          f"{static_modes}; bit-equal to run_cuda of the same stack")
    del got, twin, sres, placed_full, full

    _reset_counts()
    k2_out = ops.run_cuda(planes, T_MAIN, p_force=P_FORCE,
                          steps_per_launch=1, rng_in_kernel=False)
    torch.cuda.synchronize()
    _, k2_modes = _counts()
    if k2_modes.get("precomputed_rng") != T_MAIN:
        raise AssertionError(f"precomputed-RNG path made {k2_modes}")
    where = check.first_difference(k2_out, first)
    if where is not None:
        raise AssertionError(f"precomputed-RNG path differs first at {where}")
    print(f"[K2] run_cuda(rng_in_kernel=False), {T_MAIN} one-step launches: "
          f"bit-equal to phase 3's first {T_MAIN}-step launch, launches by "
          f"mode {k2_modes}")
    del k2_out

    # -- 7. times -------------------------------------------------------------
    sites = planes.shape[0] * HEIGHT * WIDTH
    for overlap, wall in walls.items():
        print(f"[time] {card} | sharded run, overlap={overlap}: {wall:.4f} s "
              f"for {STEPS} steps ({sites * STEPS / wall:.4e} site-updates/s) "
              f"against {main_s:.4f} s ({sites * STEPS / main_s:.4e}) on one "
              f"device (medians)")
    tiles, devs = placed.tiles, sharding.devices
    hl, wdl = tiles[0][0].shape[-2:]
    glob = dict(hg=HEIGHT, wdg=WIDTH // 32, p_force=P_FORCE)
    ext = distributed._exchange_halo(tiles, DEPTH, devs)
    ex_ms = _time_ms(lambda: distributed._exchange_halo(tiles, DEPTH, devs),
                     reps=5)

    def round_kernels(advance):
        for iy, row in enumerate(ext):
            for ix, e in enumerate(row):
                advance(e, DEPTH, t0=0, y0=iy * hl - DEPTH,
                        xw0=ix * wdl - 1, steps_per_launch=T_MAIN,
                        moments_every=T_MAIN, **glob)

    for overlap, advance in ((False, ops.run_extended),
                             (True, ops.run_extended_split)):
        r_ms = _time_ms(lambda: round_kernels(advance), reps=5)
        print(f"[time] {card} | one round, overlap={overlap}: exchange "
              f"{ex_ms:.4f} ms + kernels {r_ms:.4f} ms ({shards} shards) = "
              f"{ex_ms + r_ms:.4f} ms; measured {walls[overlap] / rounds * 1e3:.4f}"
              f" ms per round")

    e = ext[0][0]
    lanes, _, he, wde = e.shape
    bounds = (DEPTH, he - DEPTH, 1, wde - 1)
    one = dict(y0=-DEPTH, xw0=-1, steps_per_launch=T_MAIN,
               record_steps=(T_MAIN - 1,), moment_bounds=bounds,
               extended=True, **glob)
    window = (slice(DEPTH, he - DEPTH), slice(1, wde - 1))
    timed_k5 = _timed("extended launch",
                      lambda: ops.fhp_step_cuda(e, 0, **one),
                      lambda: ref.fhp_step_ref(e, 0, **one), e, T_MAIN, 1,
                      False, counted, window, owned=(hl, wdl))
    _print_time(card, f"extended launch at the shard shape {tuple(e.shape)}"
                f", T={T_MAIN}, moments", timed_k5, lanes * hl * wdl * 32 * T_MAIN)
    dyn = e[:, :7].contiguous()
    sol = e[0, 7].contiguous()
    timed_k6 = _timed("extended static-solid launch",
                      lambda: ops.fhp_step_cuda(dyn, 0, solid=sol, **one),
                      lambda: ref.fhp_step_ref(dyn, 0, solid=sol, **one),
                      dyn, T_MAIN, 1, True, counted, window, owned=(hl, wdl))
    _print_time(card, "extended static-solid launch at the shard shape",
                timed_k6, lanes * hl * wdl * 32 * T_MAIN)
    d = DEPTH
    pieces = (("interior", slice(d, he - d), slice(1, wde - 1), d, 1,
               (hl - 2 * d, wdl - 2)),
              ("top", slice(0, 3 * d), slice(None), 0, 0, (d, wdl)),
              ("bottom", slice(he - 3 * d, he), slice(None), he - 3 * d, 0,
               (d, wdl)),
              ("left", slice(d, he - d), slice(0, 3), d, 0, (hl - 2 * d, 1)),
              ("right", slice(d, he - d), slice(wde - 3, wde), d, wde - 3,
               (hl - 2 * d, 1)))
    for name, rows, words, dy, dx, owned in pieces:
        x = e[..., rows, words].contiguous()
        xh, xw = x.shape[-2:]
        pkw = dict(one, y0=-d + dy, xw0=-1 + dx,
                   moment_bounds=(d, xh - d, 1, xw - 1))
        label = f"run_extended_split piece {name} {tuple(x.shape)}"
        _print_time(card, label, _timed(
            label, lambda: ops.fhp_step_cuda(x, 0, **pkw),
            lambda: ref.fhp_step_ref(x, 0, **pkw), x, T_MAIN, 1, False,
            counted, (slice(d, xh - d), slice(1, xw - 1)), owned=owned))
    del ext, e, dyn

    # The two planes are drawn once, outside the timed launches.
    chi, acc = ops.rng_words(planes.shape[-2:], 0, p_force=P_FORCE,
                             device=dev)
    k2_kw = dict(p_force=P_FORCE, rng_in_kernel=False)
    timed_k2 = _timed(
        "K2 launch",
        lambda: ops.fhp_step_cuda(planes, 0, rng_planes=(chi, acc), **k2_kw),
        lambda: ref.fhp_step_ref(planes, 0, p_force=P_FORCE, chi=chi,
                                 accel=acc),
        planes, 1, 0, False, counted, step="pre", extra_planes=2)
    k2_ms = timed_k2[0]
    wrapper_ms = _time_ms(lambda: ops.fhp_step_cuda(planes, 0, **k2_kw),
                          reps=5)
    _print_time(card, "K2 launch (precomputed RNG planes, T=1)", timed_k2,
                sites)
    print(f"[time] {card} | K2 against K1 at T=1: {k2_ms:.4f} against "
          f"{timed_t1[0]:.4f} ms per launch; the K2 wrapper with its two "
          f"planes drawn on the card {wrapper_ms:.4f} ms")
    return [
        _entry("fhp_step K5 extended shard", "extended",
               modes[False]["extended"], timed_k5, card,
               launches_overlap=modes[True]["extended"]),
        _entry("fhp_step K6 static solid, extended", "extended_static_solid",
               static_modes["extended_static_solid"], timed_k6, card),
        _entry("fhp_step K2 precomputed RNG", "precomputed_rng",
               k2_modes["precomputed_rng"], timed_k2, card),
    ]


def _equal_words(label, got, want) -> None:
    """Raise unless host uint32 words ``got`` equal ``want``."""
    import numpy as np
    if got is None or got.shape != want.shape:
        raise AssertionError(f"{label}: result {None if got is None else got.shape}"
                             f", want {want.shape}")
    if not np.array_equal(got, want):
        where = tuple(int(i) for i in np.argwhere(got != want)[0])
        raise AssertionError(f"{label}: differs first at {where}")


def _serve_jobs(scenario_seeds, steps, frame_every, overrides=None):
    """One ``SimJob`` per ``(scenario, seed)``, with ``overrides[scenario]``
    passed to the scenario."""
    from repro_torch.serve import SimJob
    return [SimJob(rid=rid, scenario=name, steps=steps,
                   frame_every=frame_every,
                   overrides=dict((overrides or {}).get(name, {}), seed=seed))
            for rid, (name, seed) in enumerate(scenario_seeds)]


def _serve_path(dev, card, out, main_s):
    """Phase 8: the serve engine at full width (clean, then with faults)
    and on a 2 x 2 mesh.  Returns the launches by mode of 8a's and 8c's
    mesh engine runs."""
    import numpy as np

    from repro_torch import scenarios, telemetry
    from repro_torch.checkpoint import store
    from repro_torch.core import carry, distributed
    from repro_torch.kernels.fhp_step import check, ref
    from repro_torch.serve import (DONE, CAServeEngine, Fault, FaultInjector,
                                   SimulatedCrash)

    # -- 8a. full width, clean ------------------------------------------------
    t = time.perf_counter()
    bml0 = torch.stack([
        scenarios.get("bml_city", height=HEIGHT, width=WIDTH,
                      seed=s).initial_planes(device=dev)
        for s in range(LANES)])
    bml_run, _ = distributed.make_ensemble_run(None, STEPS, variant="bml",
                                               steps_per_launch=T_MAIN)
    want = {("cylinder", s): w
            for s, w in enumerate(carry.planes_to_reference(out))}
    want.update({("bml_city", s): w for s, w in enumerate(
        carry.planes_to_reference(bml_run(bml0, 0)))})
    first_bml = ref.fhp_step_ref(bml0, 0, variant="bml",
                                 steps_per_launch=DEPTH,
                                 record_steps=(DEPTH - 1,))
    del bml0
    print(f"[serve] reference lanes: {LANES} bml_city lanes built and run "
          f"{STEPS} steps in {time.perf_counter() - t:.2f} s")

    seeds = [("cylinder", s) for s in range(LANES)] + \
            [("bml_city", s) for s in range(LANES)]
    sites = len(seeds) * HEIGHT * WIDTH * STEPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as d:
        tel = telemetry.Telemetry(enabled=True)
        eng = CAServeEngine(height=HEIGHT, width=WIDTH, slots=LANES,
                            depth=DEPTH, steps_per_launch=T_MAIN,
                            device=dev, audit_every=1, ckpt_dir=d,
                            ckpt_every=SERVE_CKPT_EVERY, keep=2,
                            telemetry=tel)
        jobs = _serve_jobs(seeds, STEPS, SERVE_FRAME_EVERY)
        for job in jobs:
            eng.submit(job)
        torch.cuda.synchronize()
        _reset_counts()
        t = time.perf_counter()
        eng.tick()      # the first round admits (builds) every lattice
        g = eng.groups["bml|0.0"]
        got = (g.state, torch.from_numpy(g.last_moments).to(dev))
        _held("serve: bml group's first round", got,
              (first_bml[0], first_bml[1][:, 0]))
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, modes = _counts()
        ckpt_step = store.latest_step(d)
        ckpt_bytes = sum(os.path.getsize(os.path.join(
            store.step_dir(d, ckpt_step), f))
            for f in os.listdir(store.step_dir(d, ckpt_step)))
    del first_bml, got
    summary = tel.summary()
    rounds = eng.stats["rounds"]
    if [j.status for j in jobs] != [DONE] * len(jobs):
        raise AssertionError(f"serve: jobs {[j.status for j in jobs]}")
    results = {}
    for job, key in zip(jobs, seeds):
        _equal_words(f"serve job {job.rid} {key}", job.result, want[key])
        results[key] = job.result
    del want
    counters = summary["counters"]
    if counters.get("serve.audit.recomputed") or not counters.get(
            "serve.audit.fused"):
        raise AssertionError(f"serve: audits {counters}")
    if eng.detections:
        raise AssertionError(f"serve: detections {eng.detections}")
    if launches != 2 * rounds or modes.get("periodic") != 2 * rounds:
        raise AssertionError(f"serve: {rounds} rounds of two groups made "
                             f"launches {modes}")
    walls = sorted(eng._round_walls)
    med = statistics.median(walls)
    model = eng._modeled_round_s()
    print(f"[serve] {card} | {len(jobs)} jobs ({LANES} cylinder fhp2 + "
          f"{LANES} bml_city) on {HEIGHT} x {WIDTH}, {STEPS} steps, depth "
          f"{DEPTH}, T={T_MAIN}: all done, results bit-equal to phase 3's "
          f"lanes and the bml ensemble run, first bml round bit-equal to "
          f"fhp_step_ref; {rounds} rounds, launches by mode {modes}; "
          f"{int(counters['serve.audit.fused'])} fused audits, 0 "
          f"recomputed, 0 detections")
    print(f"[serve] {card} | round wall: median {med:.4f} s, least "
          f"{walls[0]:.4f}, most {walls[-1]:.4f} ({len(walls)} rounds; the "
          f"first admits every job); in order "
          f"{[round(x, 4) for x in eng._round_walls]} s")
    for name, st in sorted(summary["spans"].items()):
        print(f"[serve] {card} | span {name}: {st['count']} x, total "
              f"{st['total_s']:.4f} s, median {st['p50_s']:.4f}, most "
              f"{st['max_s']:.4f}")
    spans = summary["spans"]
    ck = spans["serve.checkpoint"]
    print(f"[serve] {card} | admission (lattice set-up) "
          f"{spans['serve.admit']['total_s'] / len(jobs):.2f} s per job; "
          f"checkpoints {ck['count']} x, {ck['total_s'] / ck['count']:.3f} "
          f"s and {ckpt_bytes} bytes each")
    steady = sum(eng._round_walls[1:])
    print(f"[serve] {card} | drain wall {wall:.2f} s: {len(jobs) / wall:.4f} "
          f"jobs/s, {sites / wall:.4e} site-updates/s; rounds after the "
          f"first {steady:.4f} s, "
          f"{sites * (rounds - 1) / rounds / steady:.4e} site-updates/s; "
          f"phase 3's main path {LANES * HEIGHT * WIDTH * STEPS / main_s:.4e}")
    print(f"[serve] {card} | modeled round (H100 datasheet rates) "
          f"{model:.4e} s against the median round {med:.4f} s")
    if not 0 < model <= med:
        raise AssertionError(f"serve: modeled round {model} s exceeds the "
                             f"median round {med} s")
    serve_modes = modes

    # -- 8b. faults at full width ---------------------------------------------
    seeds = [("cylinder", s) for s in range(2)] + \
            [("bml_city", s) for s in range(2)]
    inj = FaultInjector([
        Fault(kind="bitflip", round=2, rule="fhp2", lane=0, plane=3,
              bits=1, seed=21),
        Fault(kind="nan_shard", round=3, rule="bml", lane=1, plane=0,
              rows=2, seed=22),
        Fault(kind="torn_checkpoint", round=4, seed=23),
        Fault(kind="killed_step", round=6, seed=24)])
    kw = dict(steps_per_launch=T_MAIN, device=dev, audit_every=1,
              ckpt_every=2, keep=2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_faults_") as d:
        tel = telemetry.Telemetry(enabled=True)
        eng = CAServeEngine(height=HEIGHT, width=WIDTH, slots=2, depth=DEPTH,
                            ckpt_dir=d, injector=inj, telemetry=tel, **kw)
        jobs = _serve_jobs(seeds, STEPS, SERVE_FRAME_EVERY)
        for job in jobs:
            eng.submit(job)
        _reset_counts()
        t = time.perf_counter()
        try:
            eng.drain()
            raise AssertionError("serve faults: the killed_step did not fire")
        except SimulatedCrash:
            pass
        crash_round, stats = eng.round, dict(eng.stats)
        try:
            store.verify_checkpoint(d, 4)
            raise AssertionError("serve faults: the torn round-4 checkpoint "
                                 "verifies")
        except store.CheckpointError as e:
            torn = type(e).__name__
        t_resume = time.perf_counter()
        eng2 = CAServeEngine.resume(d, injector=inj, telemetry=tel, **kw)
        resume_s = time.perf_counter() - t_resume
        resumed_at = eng2.round
        done = eng2.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches, fault_modes = _counts()
    rules = sorted(v["rule"] for v in eng.detections)
    if rules != ["bml", "fhp2"] or len(inj.corruption_events()) != 2:
        raise AssertionError(f"serve faults: detections {eng.detections}, "
                             f"corruptions {inj.corruption_events()}")
    if stats["rollbacks"] != 2 or not launches:
        raise AssertionError(f"serve faults: stats {stats}, launches "
                             f"{fault_modes}")
    if sorted(j.rid for j in done) != list(range(len(seeds))):
        raise AssertionError(f"serve faults: done {[j.rid for j in done]}")
    for job, key in zip(sorted(done, key=lambda j: j.rid), seeds):
        _equal_words(f"serve faults job {job.rid} {key}", job.result,
                     results[key])
    print(f"[serve] {card} | faults, 2 slots, seeds 0-1: events "
          f"{[(e.kind, e.round, e.rule) for e in inj.events]}; detections "
          f"{[(v['round'], v['rule'], sorted(v['violations'])) for v in eng.detections]}; "
          f"rollbacks {[(r['detected_round'], r['restored_round'], round(r['restore_s'], 3)) for r in stats['recovery']]} "
          f"(detected, restored, restore s); crash at round {crash_round}, "
          f"round-4 checkpoint refused ({torn}), resumed at round "
          f"{resumed_at} in {resume_s:.2f} s; every result bit-equal to "
          f"8a's; launches by mode {fault_modes}; {wall:.2f} s")
    del results

    # -- 8c. the engine on a 2 x 2 mesh ---------------------------------------
    h, w = SERVE_MESH_HW
    seeds = [("cylinder", s) for s in range(2)] + \
            [("bml_city", s) for s in range(2)]
    variant = {"cylinder": {"variant": "fhp3"}}
    mesh = distributed.make_mesh(*MESH, devices=dev)
    runs = {}
    for label, mesh_kw in (("single device", {}), ("mesh", {"mesh": mesh})):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
            inj = (FaultInjector([Fault(kind="bitflip", round=2,
                                        rule="fhp3", lane=0, plane=2,
                                        bits=1, seed=31)])
                   if mesh_kw else None)
            eng = CAServeEngine(height=h, width=w, slots=2, depth=DEPTH,
                                steps_per_launch=T_MAIN, device=dev,
                                ckpt_dir=d, ckpt_every=1, injector=inj,
                                **mesh_kw)
            jobs = _serve_jobs(seeds, SERVE_MESH_STEPS, SERVE_FRAME_EVERY,
                               variant)
            for job in jobs:
                eng.submit(job)
            torch.cuda.synchronize()
            _reset_counts()
            eng.drain()
            torch.cuda.synchronize()
            runs[label] = (eng, jobs, _counts()[1])
    (single, sjobs, smodes), (meng, mjobs, mmodes) = runs.values()
    if not smodes.get("periodic") or not mmodes.get("extended") or \
            mmodes.get("periodic"):
        raise AssertionError(f"serve mesh: launches {smodes}, {mmodes}")
    if len(meng.detections) != 1 or meng.stats["rollbacks"] != 1:
        raise AssertionError(f"serve mesh: detections {meng.detections}")
    for a, b in zip(sjobs, mjobs):
        if a.status != DONE or b.status != DONE:
            raise AssertionError(f"serve mesh: {a.status}, {b.status}")
        _equal_words(f"serve mesh job {a.rid}", b.result, a.result)
        if a.frames != b.frames or not a.frames:
            raise AssertionError(f"serve mesh job {a.rid}: frames differ")
    print(f"[serve] mesh {mesh} of slots on {dev}, {h} x {w}, fhp3 + bml, "
          f"{SERVE_MESH_STEPS} steps: results and frames bit-equal to the "
          f"single-device engine; one bitflip detected ({meng.detections[0]['rule']}) "
          f"and rolled back onto the mesh; launches by mode {mmodes} (single "
          f"device {smodes})")
    return serve_modes, mmodes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import scenarios
    from repro_torch.core import distributed, prng, rulespec
    from repro_torch.kernels.fhp_step import build, check, opcount, ops, ref

    dev = torch.device("cuda")
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # -- 1. build ---------------------------------------------------------
    # The kernel and the instruction-count probes compile side by side.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        probes = pool.submit(opcount.counts, prng.quantize_p(P_FORCE))
        build.library()
        counted = probes.result()
    info = build.BUILD_INFO
    if not info:
        print(f"[build] reused {build.library_path()}")
    else:
        print(f"[build] nvcc {info['seconds']:.1f} s -> {info['library']}")
    for rep in build.ptxas_report(info.get("ptxas", "")):
        print(f"[build] {rep['kernel']}: {rep.get('registers')} registers, "
              f"spill stores {rep.get('spill_stores')} B, spill loads "
              f"{rep.get('spill_loads')} B")
    for mode, static, T in (("periodic", False, T_MAIN),
                            ("periodic", True, T_MAIN),
                            ("extended", False, T_MAIN),
                            ("extended", True, T_MAIN),
                            ("periodic", False, 1),
                            ("precomputed_rng", False, 1)):
        tile = ops.pick_tile(HEIGHT, WIDTH // 32, T, static)
        occ = ops.kernel_info("fhp2", mode, static, *tile, T)
        print(f"[occupancy] fhp2 {mode}{' static' if static else ''} T={T} "
              f"tile {tile}: {occ}")
        if occ["smem_bytes"] != ops.smem_bytes(*tile, T, static):
            raise AssertionError(f"ops.smem_bytes{(*tile, T, static)} = "
                                 f"{ops.smem_bytes(*tile, T, static)}, the "
                                 f"kernel takes {occ['smem_bytes']}")
    step, terms = counted["step"], counted["terms"]
    print(f"[bound] compiled fhp2 word-step at p_force {P_FORCE}, per pipe: "
          f"{step}; moment terms per word: {terms}; opcodes of the "
          f"even-row probe: {counted['opcodes']}")
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                           str(build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    rounds = [b for b in opcount.loop_bodies(
        sass, "fhp_step_kernelI9Rule_fhp2Lb0ELi0E")
        if b["barriers"] == 2]
    if rounds:
        b = rounds[0]
        print(f"[sass] fhp2 periodic kernel, round loop (2 barriers, "
              f"{opcount.WORDS_PER_ROUND} word-steps a thread): "
              f"{b['total']} instructions, "
              f"{b['total'] / opcount.WORDS_PER_ROUND:.1f} per word-step "
              f"against the probe's {sum(step.values()):.1f}; per pipe "
              f"{ {k: b[k] for k in ('alu', 'fma', 'popc', 'other')} }, "
              f"shared loads and stores {b['shared']}")

    # -- 2. parity sweep ------------------------------------------------------
    for wd in (SWEEP_WD, SWEEP_WD_ALIGNED):
        t = time.perf_counter()
        bad = []
        for i, case in enumerate(check.CASES):
            bad += check.run_case(case, dev, SWEEP_H, wd, seed=i)
        torch.cuda.synchronize()
        if bad:
            print("\n".join(bad[:20]))
            raise AssertionError(f"parity sweep: {len(bad)} mismatches")
        print(f"[sweep] {len(check.CASES)} cases x "
              f"{len(check._tiles(1, wd))} tiles on {SWEEP_H} x {wd * 32} "
              f"nodes: 0 mismatches ({time.perf_counter() - t:.1f} s)")

    # -- 3. main path ---------------------------------------------------------
    t = time.perf_counter()
    planes = torch.stack([
        scenarios.get("cylinder", height=HEIGHT, width=WIDTH,
                      seed=s).initial_planes(device=dev)
        for s in range(LANES)])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    spec = rulespec.get_rule("fhp2")
    ms = rulespec.moment_spec(spec)
    mass0 = rulespec.compute_moments(planes, ms)[:, ms.row("mass")]
    run, _ = distributed.make_ensemble_run(
        None, STEPS, variant="fhp2", p_force=P_FORCE,
        steps_per_launch=T_MAIN, moments_every=T_MAIN)
    _reset_counts()
    (out, mom), first_run = _path_run(run, planes, 0)
    launches, main_modes = _counts()
    print(f"[main] {LANES} lanes x {HEIGHT} x {WIDTH}, {STEPS} steps: host "
          f"init {init_s:.2f} s; first run {_fmt_run(first_run)}; "
          f"{launches} kernel launches, by mode {main_modes}")
    if launches != STEPS // T_MAIN:
        raise AssertionError(f"main path made {launches} kernel launches")
    if out.shape != planes.shape or mom.shape != (LANES, STEPS // T_MAIN,
                                                  ms.n_moments):
        raise AssertionError(f"shapes {out.shape} {mom.shape}")
    if not bool((mom[:, :, ms.row("mass")] == mass0[:, None]).all()):
        raise AssertionError("mass not conserved at a recorded step")
    if not torch.equal(out[:, 7], planes[:, 7]):
        raise AssertionError("the solid plane changed")
    print(f"[main] mass conserved at all {STEPS // T_MAIN} recorded steps "
          f"in all {LANES} lanes: {mass0.tolist()}")
    main_s = _repeats("main path", card, run, planes, 0)

    first = dict(p_force=P_FORCE, steps_per_launch=T_MAIN,
                 record_steps=(T_MAIN - 1,))
    kp, km = ops.fhp_step_cuda(planes, 0, **first)
    rp, rm = ref.fhp_step_ref(planes, 0, **first)
    max_abs_err = max(
        int((kp.to(torch.int64) - rp.to(torch.int64)).abs().max()),
        int((km.to(torch.int64) - rm.to(torch.int64)).abs().max()))
    if max_abs_err or not torch.equal(km[:, 0], mom[:, 0]):
        raise AssertionError(
            f"first launch differs from the plain version: first at "
            f"{check.first_difference(kp, rp)}, moments "
            f"{check.first_difference(km, rm)}")
    print("[main] first launch bit-equal to fhp_step_ref (planes, moments)")
    del rp, rm

    _reset_counts()
    twin = ops.run_cuda(planes[:1, :7], STEPS, p_force=P_FORCE,
                        steps_per_launch=T_MAIN,
                        solid=planes[0, 7].contiguous())
    twin_launches, twin_modes = _counts()
    where = check.first_difference(twin, out[:1, :7])
    if where is not None:
        raise AssertionError(f"static-solid twin differs first at {where}")
    print(f"[main] static-solid twin (lane 0, {STEPS} steps) bit-equal, "
          f"launches by mode: {twin_modes}")

    # -- 4. times -------------------------------------------------------------
    sites = LANES * HEIGHT * WIDTH
    dyn, solid = planes[:, :7].contiguous(), planes[0, 7].contiguous()
    results = {}
    for label, T, rec, static in (("T=1", 1, (), False),
                                  (f"T={T_MAIN}", T_MAIN, (T_MAIN - 1,), False),
                                  (f"T={T_MAIN} static-solid", T_MAIN, (),
                                   True)):
        kw = dict(p_force=P_FORCE, steps_per_launch=T, record_steps=rec,
                  solid=solid if static else None)
        x = dyn if static else planes
        results[label] = _timed(
            f"{label} launch", lambda: ops.fhp_step_cuda(x, 0, **kw),
            lambda: ref.fhp_step_ref(x, 0, **kw), x, T, len(rec), static,
            counted)
        _print_time(card, label, results[label], sites * T)
    del dyn

    # Tile shapes at T = 8 (rows x words), each held bit-equal to the
    # launch above, which was held against the plain version; and the
    # per-step time at T in {1, 2, 4, 8} with pick_tile's tile.
    kw = dict(p_force=P_FORCE, steps_per_launch=T_MAIN)
    want = ops.fhp_step_cuda(planes, 0, **kw)
    for bh, bw in TILES:
        tkw = dict(kw, block_rows=bh, block_words=bw)
        where = check.first_difference(ops.fhp_step_cuda(planes, 0, **tkw),
                                       want)
        if where is not None:
            raise AssertionError(f"tile {(bh, bw)} differs first at {where}")
        t_ms = _time_ms(lambda: ops.fhp_step_cuda(planes, 0, **tkw), reps=10)
        occ = ops.kernel_info("fhp2", "periodic", False, bh, bw, T_MAIN)
        print(f"[tile] {card} | T={T_MAIN} tile {bh} x {bw}: {t_ms:.4f} "
              f"ms/launch, apron {_apron(bh, bw, T_MAIN):.3f}x, lanes "
              f"{_lanes(bh, bw, T_MAIN):.3f}x, {occ['blocks_per_sm']} "
              f"blocks/SM, {occ['smem_bytes']} B shared")
    del want
    # The widest one-row band the kernel took before the row-mapped
    # redesign, 1208 words at T = 1: it runs as tiles of the widest width a
    # block covers, bit-equal to the default tile's launch (held against
    # the plain version above).
    kw1 = dict(p_force=P_FORCE, steps_per_launch=1)
    where = check.first_difference(
        ops.fhp_step_cuda(planes, 0, block_rows=1, block_words=1208, **kw1),
        ops.fhp_step_cuda(planes, 0, **kw1))
    if where is not None:
        raise AssertionError(f"tile (1, 1208) at T=1 differs first at {where}")
    print(f"[tile] T=1 tile 1 x 1208 (run as 1 x "
          f"{ops.MAX_TILE_WORDS - 2} tiles): bit-equal to the default tile")
    for T in (1, 2, 4, 8):
        tkw = dict(p_force=P_FORCE, steps_per_launch=T)
        t_ms = _time_ms(lambda: ops.fhp_step_cuda(planes, 0, **tkw), reps=10)
        print(f"[steps] {card} | T={T} tile "
              f"{ops.pick_tile(HEIGHT, WIDTH // 32, T)}: {t_ms:.4f} ms/launch"
              f", {t_ms / T:.4f} ms per step")
    # The main tile at each T: launch time against the thread word-steps
    # it issues, fitted as a + b x word-steps; a is what a launch costs
    # besides its steps (apron loads, stores, launch).
    bh, bw = ops.pick_tile(HEIGHT, WIDTH // 32, T_MAIN)
    xs, ys = [], []
    for T in (1, 2, 4, 8):
        tkw = dict(p_force=P_FORCE, steps_per_launch=T, block_rows=bh,
                   block_words=bw)
        ys.append(_time_ms(lambda: ops.fhp_step_cuda(planes, 0, **tkw),
                           reps=10))
        xs.append(_lanes(bh, bw, T) * planes[:, 0].numel() * T)
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
         / sum((x - mx) ** 2 for x in xs))
    a = my - b * mx
    print(f"[split] {card} | tile {bh} x {bw} at T=1, 2, 4, 8: "
          f"{', '.join(f'{y:.4f}' for y in ys)} ms/launch; fit {a:.4f} ms a "
          f"launch + {b * 1e9:.4f} ms per 1e9 thread word-steps; at "
          f"T={T_MAIN} the steps take {1 - a / ys[-1]:.4f} of the launch")

    k_ms = results[f"T={T_MAIN}"][0]
    print(f"[time] {card} | main path: {launches} launches x {k_ms:.4f} ms "
          f"= {launches * k_ms / (main_s * 1e3):.4f} of its median "
          f"{main_s:.4f} s wall time busy in the kernel")
    # -- 5-7. this slice: extended and K2 modes, the sharded path ------------
    _extended_sweeps(dev)
    sharded = _sharded_path(dev, planes, out, mom, kp, main_s, card, counted,
                            results["T=1"])
    # -- 8. this slice: the serve path ----------------------------------------
    serve_modes, mesh_modes = _serve_path(dev, card, out, main_s)
    sharded[0]["launches_serve_mesh"] = mesh_modes["extended"]

    entries = [
        _entry("fhp_step K1 periodic", "periodic", main_modes["periodic"],
               results["T=1"], card,
               launches_serve=serve_modes["periodic"]),
        _entry("fhp_step K3 2-D tiles", "tiles", main_modes["periodic"],
               results[f"T={T_MAIN}"], card,
               launches_serve=serve_modes["periodic"]),
        _entry("fhp_step K4 fused moments", "moments", main_modes["moments"],
               results[f"T={T_MAIN}"], card,
               launches_serve=serve_modes["moments"]),
        _entry("fhp_step K6 static solid, periodic", "static_solid",
               twin_modes["static_solid"],
               results[f"T={T_MAIN} static-solid"], card),
    ] + sharded
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
