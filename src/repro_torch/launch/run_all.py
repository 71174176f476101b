"""Sweep driver: run every (arch x shape x mesh) dry-run cell as a
subprocess (a clean process group per cell) and aggregate the roofline
table.

    PYTHONPATH=src python -m repro_torch.launch.run_all \
        [--test-mesh --smoke] [--devices N] [--archs a,b] [--shapes s1]
        [--results-dir results/dryrun] [--single-pod-only]

Each cell's ``DRYRUN_DEVICES`` is its mesh's size (256 single-pod, 512
multi-pod, 8 on the test mesh) unless ``--devices`` sets one for all.
Writes one JSON per cell plus ``summary.md``; ``write_summary`` reads
either package's records.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List

from repro_torch.configs import applicable_shapes, get_config
from repro_torch.configs.registry import ASSIGNED

def cells(archs: List[str], shapes_filter):
    out = []
    for arch in archs:
        if arch == "fhp-lattice":
            out.append(("fhp-lattice", "fhp", []))
            continue
        cfg = get_config(arch)
        for s in applicable_shapes(cfg):
            if shapes_filter and s not in shapes_filter:
                continue
            out.append((arch, s, []))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", default="results/dryrun")
    ap.add_argument("--devices", default=None)
    ap.add_argument("--test-mesh", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--archs", default=None)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    archs = (args.archs.split(",") if args.archs
             else ASSIGNED + ["fhp-lattice"])
    shapes_filter = set(args.shapes.split(",")) if args.shapes else None
    os.makedirs(args.results_dir, exist_ok=True)

    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    env = dict(os.environ)

    failures = []
    for arch, shape, extra in cells(archs, shapes_filter):
        for mp in meshes:
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
            out = os.path.join(args.results_dir, tag + ".json")
            if os.path.exists(out):
                print(f"[skip cached] {tag}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", out] + extra
            if mp:
                cmd.append("--multi-pod")
            if args.test_mesh:
                cmd.append("--test-mesh")
            if args.smoke:
                cmd.append("--smoke")
            cell_env = dict(env, DRYRUN_DEVICES=args.devices or str(
                8 if args.test_mesh else 512 if mp else 256))
            t0 = time.time()
            r = subprocess.run(cmd, env=cell_env, capture_output=True,
                               text=True, timeout=args.timeout)
            dt = time.time() - t0
            status = "OK" if r.returncode == 0 else "FAIL"
            print(f"[{status}] {tag} ({dt:.0f}s)")
            if r.returncode != 0:
                failures.append(tag)
                with open(os.path.join(args.results_dir, tag + ".err"),
                          "w") as f:
                    f.write(r.stdout + "\n" + r.stderr)

    write_summary(args.results_dir)
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def write_summary(results_dir: str):
    rows = []
    for fn in sorted(os.listdir(results_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(results_dir, fn)) as f:
            r = json.load(f)
        t = r.get("terms", {})
        rows.append({
            "cell": fn[:-5],
            "arch": r.get("arch"), "shape": r.get("shape"),
            "mesh": "x".join(str(v) for v in r.get("mesh", {}).values()),
            "bound": t.get("bound"),
            "compute_s": t.get("compute_s"), "memory_s": t.get("memory_s"),
            "collective_s": t.get("collective_s"),
            "flops_dev": r.get("flops_per_device"),
            "bytes_dev": r.get("bytes_per_device"),
            "coll_dev": r.get("collective_bytes_per_device"),
            "mf_ratio": r.get("model_flops_ratio"),
            "roofline_frac": r.get("roofline_fraction"),
            "compile_s": r.get("compile_s"),
        })
    md = ["| cell | mesh | bound | compute_s | memory_s | collective_s | "
          "MF ratio | roofline frac | compile_s |",
          "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        fmt = lambda x: ("-" if x is None else f"{x:.3g}")
        md.append(f"| {r['cell']} | {r['mesh']} | {r['bound']} | "
                  f"{fmt(r['compute_s'])} | {fmt(r['memory_s'])} | "
                  f"{fmt(r['collective_s'])} | {fmt(r['mf_ratio'])} | "
                  f"{fmt(r['roofline_frac'])} | {fmt(r['compile_s'])} |")
    with open(os.path.join(results_dir, "summary.md"), "w") as f:
        f.write("\n".join(md) + "\n")


if __name__ == "__main__":
    sys.exit(main())
