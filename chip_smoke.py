#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and
check it against the port's plain PyTorch version.

    python3 chip_smoke.py          # from the repo root, on a machine with a card

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device and build: the card's name and power limit, torch and CUDA
   versions, the kernel's nvcc build time and ptxas register / shared
   memory / spill report, and the compiled instructions of one word-step
   per pipe (``kernels/fhp_step/opcount.py``), which set its bound;
2. parity sweep: the kernel against ``fhp_step_ref`` on the card, bit for
   bit, over fhp2/fhp3/bml x T in {1,2,4,8} x B in {1,3} x p_force in
   {0, 0.05} x three tiles, static-solid included (``kernels/fhp_step/
   check.py``), on a 256 x 4000-node lattice;
3. main path: ``core.distributed.make_ensemble_run`` -- the serve engine's
   call -- for 64 fhp2 steps (T = 8, moments every 8) on 4 lanes of the
   4096 x 32768 cylinder scenario; mass conserved at every recorded step,
   the first launch bit-equal to the plain version, and the static-solid
   twin of lane 0 bit-equal to the 8-plane run;
4. times: kernel ms per launch (CUDA events, 20 launches after warm-up),
   site updates per second and the plain version's ms per launch, at
   T in {1, 8} and T = 8 static-solid, beside the card's name and power
   limit; each timed launch is first held bit-equal to its plain version;
5. extended and K2 parity: the kernel's extended-shard mode through
   ``ops.run_extended`` (y0 = -T, xw0 = -1, global extents larger than the
   array; validity window and moments) and its precomputed-RNG mode
   against the plain version, bit for bit, over the same cases and tiles;
6. the sharded path: phase 3's state through ``make_ensemble_run`` on a
   2 x 2 ("data", "model") mesh of four slots on the one card (depth 8,
   T = 8, moments every 8), with and without ``overlap``, bit-equal to
   phase 3's planes and moments; ``make_run(static_solid=True)`` bit-equal
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
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

LANES, HEIGHT, WIDTH = 4, 4096, 32768
STEPS, T_MAIN, P_FORCE = 64, 8, 0.03
SWEEP_H, SWEEP_WD = 256, 125
HBM_BYTES_PER_S = 3.35e12
MESH = ((2, 2), ("data", "model"))
DEPTH = 8
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


def _extended_sweeps(dev) -> None:
    """Phase 5: the extended-shard and precomputed-RNG sweeps on the card."""
    from repro_torch.kernels.fhp_step import check
    for name, cases, run_case in (
            ("extended", check.CASES, check.run_extended_case),
            ("K2", check.K2_CASES, check.run_k2_case)):
        t = time.perf_counter()
        bad = []
        _reset_counts()
        for i, case in enumerate(cases):
            bad += run_case(case, dev, SWEEP_H, SWEEP_WD, seed=i)
        torch.cuda.synchronize()
        _, modes = _counts()
        if bad:
            print("\n".join(bad[:20]))
            raise AssertionError(f"{name} sweep: {len(bad)} mismatches")
        # Every K2 case (one launch per tile) must run the K2 kernel.
        if name == "K2" and modes.get("precomputed_rng") != 3 * len(cases):
            raise AssertionError(f"K2 sweep made launches {modes}")
        print(f"[sweep] {name}: {len(cases)} cases x 3 tiles on {SWEEP_H} x "
              f"{SWEEP_WD * 32} nodes: 0 mismatches, launches by mode "
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
        torch.cuda.synchronize()
        _reset_counts()
        t = time.perf_counter()
        sout, smom = run(placed, 0)
        torch.cuda.synchronize()
        walls[overlap] = time.perf_counter() - t
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
              f"overlap={overlap}: {walls[overlap]:.4f} s, launches by mode "
              f"{modes[overlap]}; planes and moments bit-equal to the "
              f"single-device run")
    del got, sout

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
              f"device")
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
    for line in info.get("ptxas", "").splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    step, terms = counted["step"], counted["terms"]
    print(f"[bound] compiled fhp2 word-step at p_force {P_FORCE}, per pipe: "
          f"{step}; moment terms per word: {terms}; opcodes of the "
          f"even-row probe: {counted['opcodes']}")

    # -- 2. parity sweep ------------------------------------------------------
    t = time.perf_counter()
    bad = []
    for i, case in enumerate(check.CASES):
        bad += check.run_case(case, dev, SWEEP_H, SWEEP_WD, seed=i)
    torch.cuda.synchronize()
    if bad:
        print("\n".join(bad[:20]))
        raise AssertionError(f"parity sweep: {len(bad)} mismatches")
    print(f"[sweep] {len(check.CASES)} cases x 3 tiles on {SWEEP_H} x "
          f"{SWEEP_WD * 32} nodes: 0 mismatches "
          f"({time.perf_counter() - t:.1f} s)")

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
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    out, mom = run(planes, 0)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches, main_modes = _counts()
    print(f"[main] {LANES} lanes x {HEIGHT} x {WIDTH}, {STEPS} steps: host "
          f"init {init_s:.2f} s, device run {main_s:.3f} s, "
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

    k_ms = results[f"T={T_MAIN}"][0]
    print(f"[time] {card} | main path: {launches} launches x {k_ms:.4f} ms "
          f"= {launches * k_ms / (main_s * 1e3):.4f} of its {main_s:.4f} s "
          f"wall time busy in the kernel")
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
