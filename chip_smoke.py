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
   launches on their validity window, with their moments) first.

Every entry's ``max_abs_err`` comes from its timed launch held against the
plain version.

It ends with a kernels line and, last, ``{"ok": true, "device": ...}``.
"""
import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
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

    entries = [
        _entry("fhp_step K1 periodic", "periodic", main_modes["periodic"],
               results["T=1"], card),
        _entry("fhp_step K3 2-D tiles", "tiles", main_modes["periodic"],
               results[f"T={T_MAIN}"], card),
        _entry("fhp_step K4 fused moments", "moments", main_modes["moments"],
               results[f"T={T_MAIN}"], card),
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
