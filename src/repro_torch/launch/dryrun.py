"""Multi-pod dry-run: trace every (architecture x input shape) step on the
production mesh, and extract roofline terms from the trace.

The counterpart of ``repro/launch/dryrun.py``.  Where the reference lowers
and compiles on 512 fake host devices, the port installs the ``fake``
process group of ``DRYRUN_DEVICES`` ranks (default 512;
``launch.mesh.install_fake_group``), builds the cell's ``DeviceMesh``
(which must have exactly that many ranks: the single-pod mesh needs
``DRYRUN_DEVICES=256``, the test mesh 8), places meta tensors (shapes, no
storage) on it as DTensors by the sharding rules, and runs the cell's step
once under ``use_rules`` and ``implicit_replication()`` while
``roofline.trace.TraceRecorder`` records rank 0's local op stream.  The
record carries the reference's keys (``roofline.trace.analyze_trace``),
priced on the H100.

Usage:
    DRYRUN_DEVICES=256 PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch internlm2-20b --shape train_4k [--out results/cell.json]
    DRYRUN_DEVICES=8 PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch internlm2-20b --shape train_4k --test-mesh --smoke
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen2.5-14b --shape train_4k --multi-pod

Exit code 0 == the cell traced (sharding coherent, terms extracted).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                 get_smoke)
from repro_torch.core import distributed
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch.mesh import (batch_axes, install_fake_group,
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import (ModelCfg, decode_step, init_cache,
                                param_count, prefill)
from repro_torch.models import lm
from repro_torch.models.lm import cache_axes
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import Rules
from repro_torch.parallel.context import distribute, use_rules
from repro_torch.roofline import trace as rtrace
from repro_torch.roofline.analysis import H100, roofline_terms
from repro_torch.train import make_train_step


def abstract_params(cfg: ModelCfg):
    """(meta params tree, logical axes tree) -- no allocation."""
    return lm.abstract_params(cfg)


def opt_abstract(params, state_dtype: str = "float32"):
    """AdamW's state for ``params`` as meta tensors."""
    dt = getattr(torch, state_dtype)
    mv = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
    return {"m": lm.tree_map(mv, params), "v": lm.tree_map(mv, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def place_tree(tree, axes, rules: Rules):
    """``tree``'s meta leaves placed on the rules' mesh by their axes:
    meta DTensors, rank 0's local shards, no storage."""
    return distribute(tree, axes, rules)


def _cell_cfg(arch: str, smoke: bool) -> ModelCfg:
    return get_smoke(arch) if smoke else dataclasses.replace(
        get_config(arch), dtype="bfloat16")


def build_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
               opt_state_dtype: str = "float32",
               cfg_override: Optional[ModelCfg] = None,
               batch: Optional[Tuple[int, int]] = None):
    """Returns (fn, args, meta): the cell's step and its arguments, meta
    DTensors placed on ``mesh`` by the rules.  ``batch`` = (global batch,
    sequence length) replaces the shape's."""
    cfg = cfg_override if cfg_override is not None else _cell_cfg(arch,
                                                                  smoke)
    shape = SHAPES[shape_name]
    rules = Rules(mesh, seq_parallel=cfg.seq_parallel)
    counts = param_count(cfg)

    params_m, axes = abstract_params(cfg)
    params = place_tree(params_m, axes, rules)
    gb, sl = shape.global_batch, shape.seq_len
    if smoke:
        gb, sl = max(mesh.size() // 2, 2) * 2, 128
    if batch is not None:
        gb, sl = batch

    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "params_total": counts["total"], "params_active": counts["active"],
            "global_batch": gb, "seq_len": sl,
            "seq_parallel": cfg.seq_parallel, "pad_heads": cfg.pad_heads,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}

    if shape.kind == "train":
        batch_m, batch_ax = make_batch_specs(cfg, sl, gb)
        batch = place_tree(batch_m, batch_ax, rules)
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000),
                    state_dtype=opt_state_dtype)
        opt_m = opt_abstract(params_m, opt_state_dtype)
        opt_state = {"m": place_tree(opt_m["m"], axes, rules),
                     "v": place_tree(opt_m["v"], axes, rules),
                     "step": place_tree(opt_m["step"], (), rules)}
        fn = make_train_step(cfg, opt, microbatches=1)
        # tokens-per-step x 6N = useful model FLOPs for one optimizer step
        meta["model_flops"] = 6.0 * counts["active"] * gb * sl
        return fn, (params, opt_state, batch), meta

    if shape.kind == "prefill":
        batch_m, batch_ax = make_batch_specs(cfg, sl, gb)
        batch_m.pop("labels")
        batch = place_tree(batch_m, batch_ax, rules)
        fn = lambda p, b: prefill(p, cfg, b, max_len=sl)
        meta["model_flops"] = 2.0 * counts["active"] * gb * sl
        return fn, (params, batch), meta

    # decode: one new token against a cache of seq_len
    cache_m = init_cache(cfg, gb, sl, torch.bfloat16, device="meta")
    cache = place_tree(cache_m, cache_axes(cfg), rules)
    tok = place_tree(torch.empty((gb,), dtype=torch.int32, device="meta"),
                     ("batch",), rules)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    fn = lambda p, c, t, q: decode_step(p, cfg, c, t, q)
    meta["model_flops"] = 2.0 * counts["active"] * gb
    return fn, (params, cache, tok, pos), meta


def build_fhp_cell(mesh, *, h: int = 65536, w: int = 2 ** 21,
                   steps: int = 1, depth: int = 1, scheme: str = "shardmap",
                   p_force: float = 0.01):
    """FHP lattice cell: ``steps`` steps of the port's sharded stepper
    (``core.distributed.make_run``) on an (H, W) channel, over a mesh of
    slots on the ``meta`` device of ``mesh``'s shape and axis names: every
    slot's shard and halo are shapes only, each launch reports its bytes
    to the recorder and each ring copy its bytes as a
    ``collective-permute``.

    ``scheme`` is ``"shardmap"``, the explicit halo exchange (the port has
    no counterpart of the reference's GSPMD baseline)."""
    if scheme != "shardmap":
        raise ValueError(f"scheme {scheme!r}: the port steps the lattice "
                         f"with the explicit exchange ('shardmap') only")
    wd = w // 32
    names = tuple(mesh.mesh_dim_names)
    slots = distributed.make_mesh(tuple(mesh.shape), names, "meta")
    y_axes = batch_axes(mesh)
    run = distributed.make_run(slots, steps, y_axes=y_axes, x_axis="model",
                               p_force=p_force, depth=depth)
    planes = distributed.lattice_spec(slots, y_axes, "model").place(
        torch.empty((8, h, wd), dtype=torch.int32, device="meta"))
    chips = slots.size
    meta = {"arch": "fhp-lattice", "shape": f"{h}x{w}", "kind": "fhp",
            "steps": steps, "depth": depth, "scheme": scheme,
            "sites": h * w, "model_flops": None,
            "useful_bytes": 8 * h * wd * 4 * 2 * steps,  # RW per step
            "mesh": dict(zip(names, mesh.shape)),
            "per_device_divisor": chips}
    return run, (planes, 0), meta


def _tensors_of(x):
    """A step's arguments or results as a tree of tensors (a sharded
    lattice as its tiles)."""
    if isinstance(x, distributed.ShardedPlanes):
        return x.tiles
    if isinstance(x, tuple):
        return tuple(_tensors_of(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# Depth-knob cost correction.
#
# The reference's XLA cost analysis counts a while-loop body once, so it
# lowers shallow variants (every knob at 1, then each knob at 2), solves
# for the per-layer deltas and extrapolates to the real depths.  Eager
# PyTorch traces every layer, so a full-depth trace needs no correction;
# the port keeps the shallow variants to keep a 671B trace short and to
# compute the same quantity as the reference.  Costs are affine in the
# depth knobs -- cost = C0 + sum_k N_k * delta_k (and bilinear G*(P*m + s)
# for zamba2's nested groups) -- and per-layer shapes are depth-
# independent, so the deltas are exact.
# ---------------------------------------------------------------------------

def _knob_cfgs(cfg: ModelCfg):
    """Returns (targets, variants): depth-knob target values and the list
    of (tag, shallow_cfg) points needed to solve for per-layer deltas."""
    cyc = len(cfg.cycle)
    rep = dataclasses.replace

    if cfg.family == "hybrid":
        base = rep(cfg, n_layers=1, shared_attn_period=1)
        g2 = rep(cfg, n_layers=2, shared_attn_period=1)
        p2 = rep(cfg, n_layers=2, shared_attn_period=2)
        targets = {"G": cfg.n_cycles // cfg.shared_attn_period,
                   "P": cfg.shared_attn_period}
        return targets, [("base", base), ("G2", g2), ("P2", p2)]

    prefix = cfg.moe.first_dense if cfg.moe else 0
    variants = []
    targets = {"cycles": cfg.n_cycles}
    mk = lambda nc, np_, ne: rep(
        cfg,
        n_layers=np_ + nc * cyc,
        moe=(rep(cfg.moe, first_dense=np_) if cfg.moe else None),
        enc_layers=ne)
    np1 = 1 if prefix else 0
    ne1 = 1 if cfg.enc_layers else 0
    variants.append(("base", mk(1, np1, ne1)))
    variants.append(("cyc2", mk(2, np1, ne1)))
    if prefix:
        targets["prefix"] = prefix
        variants.append(("pre2", mk(1, 2, ne1)))
    if cfg.enc_layers:
        targets["enc"] = cfg.enc_layers
        variants.append(("enc2", mk(1, np1, 2)))
    return targets, variants


def _extrapolate(cfg, targets, costs):
    """Solve the affine model and return corrected totals."""
    out = {}
    for key in ("flops", "bytes", "bytes_xla", "coll_op", "coll_wire"):
        cb = costs["base"][key]
        # per-layer deltas cannot be negative: clamp to 0.
        d = lambda tag: max(costs[tag][key] - cb, 0.0)
        if cfg.family == "hybrid":
            m = d("P2")
            s = max(costs["G2"][key] - cb - m, 0.0)
            c0 = cb - m - s
            out[key] = c0 + targets["G"] * (targets["P"] * m + s)
        else:
            total = cb
            total += d("cyc2") * (targets["cycles"] - 1)
            if "prefix" in targets:
                total += d("pre2") * (targets["prefix"] - 1)
            if "enc" in targets:
                total += d("enc2") * (targets["enc"] - 1)
            out[key] = total
    return out


def _trace(fn, args, rules: Optional[Rules]):
    """Run ``fn(*args)`` once under the recorder: (recorder, outputs,
    seconds)."""
    t0 = time.time()
    with use_rules(rules), implicit_replication(), \
            rtrace.TraceRecorder() as rec:
        outs = fn(*args)
    return rec, outs, time.time() - t0


def _measure(fn, args, rules) -> Dict[str, float]:
    rec, outs, _ = _trace(fn, args, rules)
    return rtrace.trace_costs(rec, rtrace.local_bytes(args)
                              + rtrace.local_bytes(outs))


def _mesh(multi_pod: bool, test_mesh: bool):
    return (make_test_mesh(multi_pod=multi_pod) if test_mesh
            else make_production_mesh(multi_pod=multi_pod))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             test_mesh: bool = False, smoke: bool = False,
             fhp_kw: Optional[dict] = None,
             cfg_override: Optional[ModelCfg] = None,
             correct_scan_costs: bool = True, mesh=None,
             batch: Optional[Tuple[int, int]] = None) -> Dict:
    """Trace one cell and return its roofline record, on the test or
    production mesh (or on ``mesh``, a ``DeviceMesh`` of the process
    group's size with a ``data`` and a ``model`` dim); ``batch`` =
    (global batch, sequence length) replaces the shape's.

    With ``correct_scan_costs`` (the default for models) the step is
    traced on the shallow depth-knob variants only and the totals are
    extrapolated to the real depths (``_knob_cfgs``/``_extrapolate``):
    ``terms_measured`` are then the base variant's terms and
    ``memory_analysis`` holds the full model's argument bytes (its
    ``temp_size_in_bytes`` is left out: the high-water mark of a
    shallow trace is not the full model's).  Without it the full-depth
    step is traced and every number is the trace's own."""
    mesh = mesh if mesh is not None else _mesh(multi_pod, test_mesh)
    rules = None
    t0 = time.time()
    if arch == "fhp-lattice":
        fn, args, meta = build_fhp_cell(mesh, **(fhp_kw or {}))
        correct_scan_costs = False  # one round is one full lattice step
        chips = meta.pop("per_device_divisor")
    else:
        cfg = cfg_override if cfg_override is not None else _cell_cfg(
            arch, smoke)
        rules = Rules(mesh, seq_parallel=cfg.seq_parallel)
        chips = mesh.size()
        if correct_scan_costs:
            # The full model's placed arguments (meta: no storage) give the
            # record its argument bytes; the trace runs on the variants.
            _, full_args, meta = build_cell(arch, shape_name, mesh,
                                            smoke=smoke, cfg_override=cfg,
                                            batch=batch)
        else:
            fn, args, meta = build_cell(arch, shape_name, mesh, smoke=smoke,
                                        cfg_override=cfg, batch=batch)
    t_build = time.time() - t0
    if arch == "fhp-lattice" or not correct_scan_costs:
        rec_, outs, t_trace = _trace(fn, args, rules)
        rec = rtrace.analyze_trace(rec_, inputs=_tensors_of(args),
                                   outputs=_tensors_of(outs),
                                   model_flops=meta.get("model_flops"),
                                   chips=mesh.size(), hw=H100)
        if arch == "fhp-lattice":
            # The slots' streams were traced together: one device's share.
            for k in ("flops_per_device", "bytes_per_device",
                      "bytes_xla_prefusion_per_device",
                      "collective_bytes_per_device",
                      "collective_wire_bytes_per_device"):
                rec[k] /= chips
            for v in rec["collectives"].values():
                for k in ("count", "operand_bytes", "wire_bytes"):
                    v[k] /= chips
            for k in rec["memory_analysis"]:
                rec["memory_analysis"][k] //= chips
            rec["terms"] = roofline_terms(
                rec["flops_per_device"], rec["bytes_per_device"],
                rec["collective_bytes_per_device"], H100)
            rec["kernel_launches"] = sum(
                1 for r in rec_.ops if r.name.startswith("fhp_step"))
        rec["terms_measured"] = rec["terms"]
    else:
        targets, variants = _knob_cfgs(cfg)
        costs, base_rec, t_trace = {}, None, 0.0
        for tag, vcfg in variants:
            t1 = time.time()
            vfn, vargs, _ = build_cell(arch, shape_name, mesh, smoke=smoke,
                                       cfg_override=vcfg, batch=batch)
            t_build += time.time() - t1
            tr, outs, t = _trace(vfn, vargs, rules)
            t_trace += t
            costs[tag] = rtrace.trace_costs(
                tr, rtrace.local_bytes(vargs) + rtrace.local_bytes(outs))
            if tag == "base":
                base_rec = rtrace.analyze_trace(tr, inputs=vargs,
                                                outputs=outs, hw=H100)
            del tr, outs
        corr = _extrapolate(cfg, targets, costs)
        rec = base_rec
        rec["terms_measured"] = rec["terms"]
        rec["flops_per_device"] = corr["flops"]
        rec["bytes_per_device"] = corr["bytes"]
        rec["bytes_xla_prefusion_per_device"] = corr["bytes_xla"]
        rec["collective_bytes_per_device"] = corr["coll_op"]
        rec["collective_wire_bytes_per_device"] = corr["coll_wire"]
        rec["terms"] = roofline_terms(corr["flops"], corr["bytes"],
                                      corr["coll_op"], H100)
        rec["memory_analysis"] = {
            "argument_size_in_bytes": rtrace.local_bytes(full_args)}
        if meta.get("model_flops"):
            rtrace.add_model_flops(rec, meta["model_flops"], chips, H100)
        rec["scan_cost_correction"] = "depth-knob extrapolation"

    rec.update(meta)
    rec["chips"] = chips
    rec["multi_pod"] = multi_pod
    rec["hw"] = "H100"
    # The reference's keys: building the placed arguments stands for its
    # lowering, the trace for its compile.
    rec["lower_s"] = round(t_build, 2)
    rec["trace_s"] = rec["compile_s"] = round(t_trace, 2)
    if meta.get("useful_bytes"):  # FHP: memory-roofline efficiency
        per_dev = meta["useful_bytes"] / chips
        rec["useful_bytes_ratio"] = (per_dev / rec["bytes_per_device"]
                                     if rec["bytes_per_device"] else 0.0)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--test-mesh", action="store_true",
                    help="4x2 (or 2x2x2) mesh for CI")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CI)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fhp-scheme", default="shardmap",
                    choices=["shardmap"])
    ap.add_argument("--fhp-depth", type=int, default=1)
    ap.add_argument("--fhp-h", type=int, default=65536)
    ap.add_argument("--fhp-w", type=int, default=2 ** 21)
    ap.add_argument("--fhp-steps", type=int, default=1)
    args = ap.parse_args(argv)

    fhp_kw = None
    if args.arch == "fhp-lattice":
        fhp_kw = {"scheme": args.fhp_scheme, "depth": args.fhp_depth,
                  "h": args.fhp_h, "w": args.fhp_w, "steps": args.fhp_steps}
    else:
        cfg = get_config(args.arch)
        if args.shape not in applicable_shapes(cfg):
            print(f"SKIP {args.arch} x {args.shape}: inapplicable "
                  f"(family={cfg.family}); see DESIGN.md")
            return 0

    install_fake_group()
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   test_mesh=args.test_mesh, smoke=args.smoke,
                   fhp_kw=fhp_kw)
    out = json.dumps(rec, indent=2, default=str)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    print(f"DRYRUN OK {args.arch} x {args.shape} "
          f"(multi_pod={args.multi_pod}) bound={rec['terms']['bound']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
