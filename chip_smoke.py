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
   T in {1, 8}, beside the card's name and power limit.

It ends with a kernels line and, last, ``{"ok": true, "device": ...}``.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

LANES, HEIGHT, WIDTH = 4, 4096, 32768
STEPS, T_MAIN, P_FORCE = 64, 8, 0.03
SWEEP_H, SWEEP_WD = 256, 125
HBM_BYTES_PER_S = 3.35e12


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _bound_ms(x, T, n_rec, static, counted):
    """(ops ms, the pipe that sets it, bytes ms) of one fhp2 launch on
    stack ``x``: the compiled instructions of every word-step
    (``opcount``), and each plane word read and written once (plus the
    solid plane and the moments)."""
    from repro_torch.core import rulespec
    from repro_torch.kernels.fhp_step import opcount
    lanes, nps, h, wd = x.shape
    ops_ms, pipe = opcount.ops_ms(
        lanes * h * wd * T, opcount.per_word_step(counted, n_rec / T))
    n_moments = rulespec.moment_spec(rulespec.get_rule("fhp2"),
                                     nps).n_moments
    n_bytes = 4 * (2 * x.numel() + (h * wd if static else 0)
                   + lanes * n_rec * n_moments)
    return ops_ms, pipe, n_bytes / HBM_BYTES_PER_S * 1e3


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


def main() -> int:
    import torch
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
    ops.LAUNCHES = 0
    t = time.perf_counter()
    out, mom = run(planes, 0)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = ops.LAUNCHES
    print(f"[main] {LANES} lanes x {HEIGHT} x {WIDTH}, {STEPS} steps: host "
          f"init {init_s:.2f} s, device run {main_s:.3f} s, "
          f"{launches} kernel launches")
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

    twin = ops.run_cuda(planes[:1, :7], STEPS, p_force=P_FORCE,
                        steps_per_launch=T_MAIN,
                        solid=planes[0, 7].contiguous())
    where = check.first_difference(twin, out[:1, :7])
    if where is not None:
        raise AssertionError(f"static-solid twin differs first at {where}")
    print(f"[main] static-solid twin (lane 0, {STEPS} steps) bit-equal")

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
        k_ms = _time_ms(lambda: ops.fhp_step_cuda(x, 0, **kw), reps=20)
        p_ms = _time_ms(lambda: ref.fhp_step_ref(x, 0, **kw), reps=2,
                        warmup=1)
        ops_ms, pipe, bytes_ms = _bound_ms(x, T, len(rec), static, counted)
        results[label] = (k_ms, p_ms, ops_ms, bytes_ms, pipe)
        print(f"[time] {card} | {label}: kernel {k_ms:.4f} ms/launch "
              f"({sites * T / (k_ms * 1e-3):.4e} site-updates/s), plain "
              f"{p_ms:.2f} ms/launch, bound {max(ops_ms, bytes_ms):.4f} ms "
              f"(instructions {ops_ms:.4f} ms, set by {pipe}; bytes "
              f"{bytes_ms:.4f} ms)")
    del dyn

    k_ms, p_ms, ops_ms, bytes_ms, pipe = results[f"T={T_MAIN}"]
    print(f"[time] {card} | main path: {launches} launches x {k_ms:.4f} ms "
          f"= {launches * k_ms / (main_s * 1e3):.4f} of its {main_s:.4f} s "
          f"wall time busy in the kernel")
    print(json.dumps({"kernels": [{
        "name": "fhp_step", "route": "cuda",
        "source": "src/repro_torch/kernels/fhp_step/csrc/fhp_step.cu",
        "replaces": "src/repro/kernels/fhp_step/kernel.py:330",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_pipe": pipe if ops_ms >= bytes_ms else "memory",
        "library_ms": None, "checked_vs_plain": True,
        "modes": ["periodic", "tiles", "moments", "static_solid"],
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
