"""Perf hillclimb driver: named hypothesis -> change -> re-trace ->
compare experiments on the three selected cells, priced on the H100.

The port's copy of ``repro/launch/perf.py``, on the port's ``run_cell``
(``launch.dryrun``) and cost model (``kernels.fhp_step.ops``).

    PYTHONPATH=src python -m repro_torch.launch.perf --exp qwen_headpad
    PYTHONPATH=src python -m repro_torch.launch.perf --exp seamless_seqpar
    PYTHONPATH=src python -m repro_torch.launch.perf --exp fhp_depth
    PYTHONPATH=src python -m repro_torch.launch.perf --exp fhp_temporal
    PYTHONPATH=src python -m repro_torch.launch.perf --exp all

Each experiment writes <out-dir>/<exp>.json with the baseline and the
optimized variant's corrected roofline terms.  The three cells trace on
the single-pod production mesh, in a ``fake`` process group of 256 ranks
that ``_cell`` installs; ``fhp_temporal`` is the cost model alone.
"""
import os
import argparse
import dataclasses
import json
import sys
from typing import Dict

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import install_fake_group


def _cell(arch, shape, cfg=None, fhp_kw=None, multi_pod=False):
    install_fake_group(512 if multi_pod else 256)
    rec = run_cell(arch, shape, multi_pod=multi_pod, cfg_override=cfg,
                   fhp_kw=fhp_kw)
    t = rec["terms"]
    return {"terms": t, "flops_dev": rec["flops_per_device"],
            "bytes_dev": rec["bytes_per_device"],
            "coll_dev": rec["collective_bytes_per_device"],
            "mf_ratio": rec.get("model_flops_ratio"),
            "roofline_fraction": rec.get("roofline_fraction"),
            "collectives": rec.get("collectives")}


def exp_qwen_headpad() -> Dict:
    """qwen2.5-14b x train_4k (worst roofline fraction of the dense archs).

    HYPOTHESIS: 40 q-heads % 16 != 0 forces the rules engine to replicate
    attention over the model axis -> every chip computes the full-batch
    attention (~16x waste on the attention share of flops) and the score
    tensors replicate in memory.  Padding to 48 zero-masked heads
    (math-identical, +20% attention flops) restores 16-way head TP:
    predicted compute-term drop ~ (attention share) x (1 - 1.2/16),
    memory-term drop from de-replicated score slabs.
    """
    base_cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                                   dtype="bfloat16")
    opt_cfg = dataclasses.replace(base_cfg, pad_heads=48)
    return {"cell": "qwen2.5-14b x train_4k",
            "hypothesis": exp_qwen_headpad.__doc__,
            "baseline": _cell("qwen2.5-14b", "train_4k", base_cfg),
            "optimized(pad_heads=48)": _cell("qwen2.5-14b", "train_4k",
                                             opt_cfg)}


def exp_seamless_seqpar() -> Dict:
    """seamless-m4t-medium x prefill_32k (most collective-bound cell).

    HYPOTHESIS: d_model=1024 is tiny, so TP over d_ff/heads makes every
    layer pay 2 all-reduces of the full (B,S,d) activations: collective
    term >> compute term.  Sequence parallelism (activations seq-sharded
    on the model axis, block weights replicated, one K/V all-gather per
    attention) replaces ~2 all-reduce x 2x factor with 1 all-gather of
    the same magnitude: predicted collective-term drop ~3-4x, compute
    unchanged.
    """
    base_cfg = dataclasses.replace(get_config("seamless-m4t-medium"),
                                   dtype="bfloat16")
    opt_cfg = dataclasses.replace(base_cfg, seq_parallel=True)
    return {"cell": "seamless-m4t-medium x prefill_32k",
            "hypothesis": exp_seamless_seqpar.__doc__,
            "baseline": _cell("seamless-m4t-medium", "prefill_32k", base_cfg),
            "optimized(seq_parallel)": _cell("seamless-m4t-medium",
                                             "prefill_32k", opt_cfg)}


def exp_fhp_depth() -> Dict:
    """fhp-lattice (the paper's own technique cell).

    HYPOTHESIS: the FHP step is memory-bound (paper sec. 4) with a small
    but latency-critical collective term (halo exchange every step).
    (a) halo-widening depth d cuts exchange *count* by d at the cost of
    O(d x perimeter) redundant rows: collective bytes/step should fall
    ~d-fold for the row halos; (b) (the reference's GSPMD baseline has no
    counterpart in the port: the lattice steps with the explicit
    exchange only); (c) fused single-pass stepping keeps HBM bytes/site
    at ~2 B vs ~4 B unfused.
    """
    out = {"cell": "fhp-lattice 65536x2097152, per-step metrics",
           "hypothesis": exp_fhp_depth.__doc__}
    for depth in (1, 2, 4, 8):
        rec = _cell("fhp-lattice", "fhp",
                    fhp_kw={"depth": depth, "steps": depth,
                            "scheme": "shardmap"})
        # steps == depth -> whole chunk lowered once; divide to per-step
        per = {k: (v / depth if isinstance(v, (int, float)) else v)
               for k, v in rec["terms"].items() if k.endswith("_s")}
        out[f"shardmap depth={depth}"] = {
            "terms_per_step": per,
            "coll_bytes_per_step_dev": rec["coll_dev"] / depth,
            "bytes_per_step_dev": rec["bytes_dev"] / depth}
    return out


def exp_fhp_temporal() -> Dict:
    """fhp-lattice temporal blocking (the tentpole HBM-traffic lever).

    HYPOTHESIS: the fused step moves ~2 B/site (one read + one write of 8
    bit planes); computing T steps per launch with a T-row apron moves the
    stack once per T steps, so modeled traffic should approach 2/T + halo
    overhead B/site while redundant apron compute grows only as
    (T-1)/block_rows.  The autotuner should therefore push T to the
    redundancy/shared-memory frontier.
    """
    from repro_torch.kernels.fhp_step import ops
    h_shard, w_shard = 8192, 65536        # per-device shard of the big cell
    wd = w_shard // 32
    out = {"cell": f"fhp-lattice shard {h_shard}x{w_shard}, modeled",
           "hypothesis": exp_fhp_temporal.__doc__}
    for t_launch in (1, 2, 4, 8):
        bh, bw = ops.pick_tile(h_shard, wd, steps=t_launch)
        out[f"temporal T={t_launch}"] = {
            "block_rows": bh, "block_words": bw,
            "hbm_bytes_per_site_step": ops.hbm_bytes_per_site(
                bh, t_launch, bw, wd),
            "smem_bytes": ops.smem_bytes(bh, bw, t_launch),
            "launch_cost_row_units": ops.launch_cost(bh, t_launch, bw, wd),
            "redundant_row_fraction": (t_launch - 1) / bh,
        }
    bh_t, bw_t, t_t = ops.autotune_launch(h_shard, wd)
    bh1, bw1 = ops.pick_tile(h_shard, wd)
    out["autotune"] = {
        "block_rows": bh_t, "block_words": bw_t, "steps_per_launch": t_t,
        "hbm_bytes_per_site_step": ops.hbm_bytes_per_site(bh_t, t_t,
                                                          bw_t, wd),
        "speedup_vs_T1_modeled":
            ops.hbm_bytes_per_site(bh1, 1, bw1, wd)
            / ops.hbm_bytes_per_site(bh_t, t_t, bw_t, wd),
    }
    return out


EXPERIMENTS = {
    "qwen_headpad": exp_qwen_headpad,
    "seamless_seqpar": exp_seamless_seqpar,
    "fhp_depth": exp_fhp_depth,
    "fhp_temporal": exp_fhp_temporal,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True,
                    choices=list(EXPERIMENTS) + ["all"])
    ap.add_argument("--out-dir", default="results/perf")
    args = ap.parse_args(argv)
    names = list(EXPERIMENTS) if args.exp == "all" else [args.exp]
    os.makedirs(args.out_dir, exist_ok=True)
    for name in names:
        print(f"=== {name} ===")
        rec = EXPERIMENTS[name]()
        path = os.path.join(args.out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        for k, v in rec.items():
            if isinstance(v, dict) and "terms" in v:
                print(f"  {k}: {v['terms']}")
            elif isinstance(v, dict) and "terms_per_step" in v:
                print(f"  {k}: {v['terms_per_step']}")
        print(f"  -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
