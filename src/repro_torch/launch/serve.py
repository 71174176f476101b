"""CA simulation-service launcher: continuous-batching job engine with
fault injection and rollback-replay.

    PYTHONPATH=src python -m repro_torch.launch.serve --jobs 8 --steps 16 \
        --height 32 --width 128 --ckpt-dir ckpt/ca
    PYTHONPATH=src python -m repro_torch.launch.serve --jobs 8 --faults 3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Lanes run on the card by default (``--device cuda``); ``--device cpu``
runs the kernel's plain version.  ``--mesh ny nx`` runs the sharded
engine on a ny x nx mesh of slots: one card per slot when as many cards
are visible, otherwise every slot on ``--device``.  ``--faults SEED`` drives a seeded fault schedule (bit flips + garbaged
shards + torn checkpoints) through the run and reports detection /
recovery statistics.  ``--tenants`` splits the job mix across a
priority-tiered gold/bronze tenant pair (gold preempts, bronze is
rate-limited and queue-bounded) and prints the SLO/fairness report;
``--deadline-s`` attaches a wall-clock deadline to every job (typed
rejections and sheds are reported, not errors).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--frame-every", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the lanes live: cuda (the kernel) or cpu "
                         "(its plain version)")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("NY", "NX"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--faults", type=int, default=None, metavar="SEED")
    ap.add_argument("--scenarios", nargs="*",
                    default=["cylinder", "bml_city"])
    ap.add_argument("--tenants", action="store_true",
                    help="gold/bronze multi-tenant demo with admission "
                         "control and the SLO report")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-job wall-clock deadline")
    ap.add_argument("--round-budget-s", type=float, default=None,
                    help="arm overload degradation above this round wall")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import distributed
    from repro_torch.serve import AdmissionError, CAServeEngine, \
        FaultInjector, SimJob, TenantConfig, make_schedule

    mesh = None
    if args.mesh:
        slots = args.mesh[0] * args.mesh[1]
        on_cards = (torch.device(args.device).type == "cuda"
                    and torch.cuda.device_count() == slots)
        mesh = distributed.make_mesh(tuple(args.mesh), ("data", "model"),
                                     None if on_cards else args.device)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="ca_serve_")
    injector = None
    if args.faults is not None:
        # Schedule over the rounds the run actually spans: jobs batch
        # concurrently (slots lanes per scenario group), so the run
        # lasts waves * steps/depth rounds, not jobs * steps/depth.
        groups = max(len(set(args.scenarios)), 1)
        per_group = -(-args.jobs // groups)
        waves = -(-per_group // args.slots)
        rounds = max(waves * (args.steps // args.depth), 4)
        injector = FaultInjector(make_schedule(
            args.faults, rounds, n_bitflip=1, n_nan=1, n_torn=1,
            lanes=args.slots))
    tenants = None
    if args.tenants:
        tenants = {
            "gold": TenantConfig("gold", priority=2, weight=2.0),
            "bronze": TenantConfig("bronze", priority=1,
                                   queue_limit=max(args.jobs, 2),
                                   rate=50.0, burst=max(args.jobs, 2)),
        }
    eng = CAServeEngine(
        height=args.height, width=args.width, slots=args.slots,
        mesh=mesh, depth=args.depth, device=args.device,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        injector=injector, tenants=tenants,
        round_budget_s=args.round_budget_s)
    admitted = 0
    for rid in range(args.jobs):
        tenant = ("gold" if rid % 2 else "bronze") if args.tenants \
            else "default"
        try:
            eng.submit(SimJob(
                rid=rid,
                scenario=args.scenarios[rid % len(args.scenarios)],
                steps=args.steps, frame_every=args.frame_every,
                overrides={"seed": rid}, tenant=tenant,
                deadline_s=args.deadline_s))
            admitted += 1
        except AdmissionError as e:
            print(f"rejected rid={rid}: {e.reason} "
                  f"(retry_after_s={e.retry_after_s:.3g})")
    t0 = time.perf_counter()
    done = eng.drain()
    dt = time.perf_counter() - t0
    frames = sum(len(j.frames) for j in eng.jobs.values())
    print(f"served {len(done)}/{args.jobs} jobs, {frames} frames in "
          f"{dt:.2f}s ({len(done) / dt:.2f} jobs/s) over "
          f"{eng.stats['rounds']} rounds")
    if injector is not None:
        print(f"faults fired: {len(injector.events)} "
              f"({len(injector.corruption_events())} corrupting); "
              f"detections: {len(eng.detections)}; "
              f"rollbacks: {eng.stats['rollbacks']}; "
              f"steps replayed: {eng.stats['steps_replayed']}; "
              f"quarantined: {eng.stats['quarantined']}")
    slo = eng.slo_report()
    if args.tenants or args.deadline_s is not None:
        print(f"slo: rejected={eng.stats['rejected']} "
              f"shed={eng.stats['shed']} "
              f"preemptions={eng.stats['preemptions']} "
              f"deadline_miss={eng.stats['deadline_miss']} "
              f"jain_fairness={slo['jain_fairness']:.3f}")
        for name in sorted(slo["tenants"]):
            d = slo["tenants"][name]
            print(f"  tenant {name}: done={d['done']} shed={d['shed']} "
                  f"rejected={d['rejected']} "
                  f"work_steps={d['work_done_steps']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
