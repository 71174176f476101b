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
   which ``pick_tile`` sizes tiles by), the streamed geometry of the main
   launch at T = 8 and 1 (strips, rows a block, chunks a warp, threads,
   blocks an SM, registers, shared bytes held equal to
   ``ops.stream_geometry``'s, thread word-steps per owned word-step), the
   compiled instructions of one word-step per
   pipe (``kernels/fhp_step/opcount.py``), which set its bound, and the
   instructions of the built kernels' loops (``cuobjdump -sass``): the
   tile kernel's two-barrier round loop and the row-streaming kernel's
   one-barrier wave loop;
2. parity sweep: the kernel against ``fhp_step_ref`` on the card, bit for
   bit, over fhp2/fhp3/bml x T in {1,2,4,8} x B in {1,3} x p_force in
   {0, 0.05} x four block shapes (tiles; strips and shares where the
   launch streams), static-solid included (``kernels/fhp_step/
   check.py``), on 256 x 4000- and 256 x 4096-node lattices (the second
   takes the kernel's 16-byte copies);
3. main path: ``core.distributed.make_ensemble_run`` -- the serve engine's
   call -- for 64 fhp2 steps (T = 8, moments every 8) on 4 lanes of the
   4096 x 32768 cylinder scenario, every launch streamed (the
   row-streaming kernel); mass conserved at every recorded step,
   the first launch bit-equal to the plain version, and the static-solid
   twin of lane 0 bit-equal to the 8-plane run.  The counted run is timed
   launch by launch (CUDA events around each launch with its output's
   allocation, the gaps between launches, host time to enqueue, memory
   segments allocated), then timed again ``MAIN_REPEATS`` times: median,
   least and most;
4. times: kernel ms per launch (CUDA events, 20 launches after warm-up),
   site updates per second and the plain version's ms per launch, at
   T in {1, 8} (streamed) and T = 8 static-solid (tiles), beside the
   card's name and power limit; each timed launch is first held bit-equal
   to its plain version; the same T = 1 and 8 launches on the tile kernel;
   then the T = 8 launch at each strip count of ``STRIPS`` and on the tile
   kernel at each tile shape of ``TILES`` (each held bit-equal to the
   launch above), a band wider than a block covers (bit-equal at T = 1),
   the per-step time at T in {1, 2, 4, 8} streamed and on tiles, and the
   main tile's and the streamed launch's time at those T fitted against
   the thread word-steps each issues (what a launch costs besides its
   steps), the tile cost model's compute weight re-derived from the tile
   fit, and ``ops.autotune_launch``'s single-device pick for this lattice
   beside the measured tile sweeps: each timed (tile, T)'s modeled cost
   against the main tile's next to its measured ms a step against the
   main tile's (the pick timed on tiles too, held bit-equal to the plain
   version first, when the sweeps did not time it);
5. extended and K2 parity: the kernel's extended-shard mode through
   ``ops.run_extended`` (y0 = -T, xw0 = -1, global extents larger than the
   array; validity window and moments) and its precomputed-RNG mode
   against the plain version, bit for bit, over the same cases, tiles and
   lattices;
6. the sharded path: phase 3's state through ``make_ensemble_run`` on a
   2 x 2 ("data", "model") mesh of four slots on the one card (depth 8,
   T = 8, moments every 8), with and without ``overlap`` (1 and 5
   extended launches a shard a round; the overlapped round's interior
   launches on a side stream), bit-equal to phase 3's planes and moments,
   the overlapped run twice more from the same placed state, each equal,
   and each path then timed ``MAIN_REPEATS`` times;
   ``make_run(static_solid=True)`` bit-equal to ``run_cuda`` of the same
   stack; and the precomputed-RNG path
   (``run_cuda(rng_in_kernel=False)``, 8 one-step launches) bit-equal to
   phase 3's first launch.  Every launch counter is set to 0 before each
   path and read after it;
7. times of the sharded path: wall time and site updates per second
   against phase 3's; the parts of a round each alone on one stream (the
   serial exchange and launches; the boundary-slice exchange, the
   interior and the boundary launches); one overlapped and one serial
   round of the stepper with CUDA events on both streams (the interior
   launches on the side stream, the boundary-slice exchange, the boundary
   launches and the composition on the current one), how long the
   interior and the exchange ran at the same time, and both rounds'
   walls; ``measured_exchange_latency()`` and the branch it took;
   ``ops.autotune_launch``'s sharded pick for the shard (depth <= 16)
   with ``sharded_launch_cost`` of it and of the overlapped and serial
   points above beside their measured runs, the pick run once through
   ``make_ensemble_run`` (bit-equal to phase 3) and timed when its depth
   divides the steps; then the extended launch (and its static-solid
   twin) at the shard shape, each piece of ``run_extended_split``, and a
   precomputed-RNG launch against a T = 1 launch, each with its bound and
   its plain version's time, and each held bit-equal to its plain version
   on the same inputs (extended launches on their validity window, with
   their moments) first;
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

9. Poiseuille (``repro_torch.examples.poiseuille`` at its defaults: 64 x
   512, 3000 steps, p_force 0.02) through the kernel
   (``make_ensemble_run(None, ...)``, counts set to 0 before and read
   after), bit-equal to ``bitplane.run_planes`` on the card after the warm
   phase and at the end, the profile equal, R^2 > 0.9 and concave; prints
   R^2, the curvature and both runs' ms;
10. the LM serve path (``serve.ServeEngine``), which reaches no custom
    kernel (nor do phases 12-13; phase 11's MLA decode in bf16 does)
    (plain PyTorch, as the reference's attention, experts and SSD are
    plain jnp):
    a. the smoke configs of repro-100m, gemma2-27b, deepseek-v3-671b,
       llama4-scout-17b-a16e, mamba2-2.7b and zamba2-2.7b in float32,
       built from the same seeded numpy parameters on the card and on the
       CPU, 8 requests through both engines: greedy tokens equal, every
       logit the engines saw within 1e-3, matmuls at "highest" precision;
    b. internlm2-20b at its published width (d_model 6144, 48/8 heads,
       d_ff 16384, vocab 92544), 4 slots, max_len 1024, 8 greedy requests
       (prompts of 32-512 tokens from ``default_rng(7)``, 32 new tokens
       each), first in float32 with the depth cut to 4 layers, then at
       its published depth (48 layers) in bf16 with a bf16 cache, the
       parameters drawn on the card in that dtype each time.  Every
       request finishes; for two of them a teacher-forced ``forward``
       over prompt + output has the decoded token as its argmax wherever
       its top-2 margin is at least the tolerance, and the engine's logits
       lie within it (float32: 1e-3; bf16: 1.0, twice the measured
       difference of the same forward over a prefix and over the whole).
       Prints parameter bytes, peak memory, prefill ms per prompt token,
       decode ms per step, tokens/s, a step's byte bound (parameter bytes
       / 3.35 TB/s) with its share, and a profile of three bf16 decode
       steps (device busy share, kernels a step, the costliest kernels).
11. the experts/MLA and SSM/hybrid families at their published widths,
    with 10b's traffic and numbers: deepseek-v3-671b (MLA, 256 experts
    top-8 + 1 shared) in float32 cut to 2 layers (1 dense) at the
    no-drop capacity factor n_experts / top_k, against a teacher-forced
    forward at 1e-3 on its two shortest requests, then in bf16 at 5
    layers (the 3 dense-prefix layers, 2 MoE) at the published capacity
    factor, whose prefill logits must equal a forward over the same
    prompt within twice a measured floor (forward over the prompt twice,
    and over the prompt + k generated tokens at equal capacity);
    llama4-scout-17b-a16e in float32 cut to 2 layers, no-drop, at 1e-3;
    mamba2-2.7b and zamba2-2.7b at full depth in float32 at 1e-3 (the
    teacher-forced sequence right-padded to the SSD chunk), then in bf16.
    Each bf16 run prints a profile of three decode steps; a step's byte
    bound counts every parameter it reads (every expert, not the MTP
    leaves).  The bf16 deepseek run decodes through MLA's attention-core
    kernel (``kernels/mla_decode``; its split and merge launches counted
    apart).  Then that kernel alone at DeepSeek-V3's widths (128 heads,
    512 + 64, the YaRN scale), against the plain core within 2^-6
    (relative L2 of each context vector) at that run's decode shapes
    (``LM_SLOTS`` rows over ``LM_MAX_LEN`` positions, split and merged)
    and over 256 rows of a 2,560-long cache at the chat mix's depths (one
    split), where it prints its ms (CUDA events) beside its bound (live
    latent bytes at 3.35e12 B/s against the absorbed FLOPs at 989.4e12)
    and the plain core's ms.
12. the encoder-decoder (seamless-m4t-medium at its published width and
    depth: 12 + 12 layers, d_model 1024, vocab 256206) through
    ``models.lm.prefill`` and ``decode_step`` (``ServeEngine`` refuses
    this family, as the reference's cannot serve it): 4 rows of 512
    frames from ``SyntheticLM(frames_dim=1024, seed=7)``, prompts of its
    first 16 tokens, 64 greedy tokens at per-row positions.  Float32:
    every generated position's logits within 1e-3 of a teacher-forced
    ``forward`` over prompt + generated tokens with the same frames.
    Bf16: the encoder's and prefill's ms, decode ms a step against its
    byte bound (the bytes a step reads, from the meta device: decoder
    layers without the cached cross K/V projections, final norm, head,
    one embedding row a token, both caches), a profile of three steps,
    peak memory; the logits within twice a measured floor of the same
    forward (the bf16 forward against the float32 forward of the same
    parameters, and over a prefix against the whole);
13. training (``loss_fn`` with autograd, ``optim.AdamW``,
    ``train.make_train_step`` and ``Trainer``):
    a. the ten assigned smoke configs in float32 (experts no-drop, MTP
       for deepseek), the same parameters and batch on the card and the
       CPU: loss and every gradient leaf within 1e-4 of the leaf's
       largest magnitude, one AdamW update from the same gradients
       within 1e-4;
    b. repro-100m at full width (12 layers, d_model 768, vocab 32768,
       tied) through ``Trainer`` (seq 512 x batch 8, 60 steps, lr 3e-4,
       warmup 20, checkpoints every 20; bf16 compute, float32 masters,
       remat): the loss falls, a fresh Trainer resumes at step 60
       bit-equal, a run stopped at step 20 and resumed equals the
       straight one (rtol 1e-6, atol 1e-7), 4 microbatches give a first
       loss within 1e-2; step ms, tokens/s, the FLOP bound (6 N T, 2
       N_layers T of recompute, the attention's S^2 products, at 989
       TFLOP/s), a profile of three steps, peak memory;
    c. one ``make_train_step`` of seamless-m4t-medium at full width (seq
       256 x batch 4, frames from ``SyntheticLM``): a finite loss, step
       ms and peak memory;
14. the dry-run and sharded training (``launch.dryrun``,
    ``roofline.trace``, ``parallel``, ``Trainer(mesh=, rules=)``):
    a. on the host, with meta tensors: ``python -m
       repro_torch.launch.dryrun`` in a subprocess per cell, as
       ``launch.run_all`` runs them, all three started together, each on a
       ``fake`` process group of 256 ranks (the single-pod (16, 16)
       production mesh): internlm2-20b x train_4k, deepseek-v3-671b x
       decode_32k and the fhp-lattice cell at its defaults; per-device
       FLOPs, bytes and collective bytes, the three terms on the H100's
       rates, the bound and the trace seconds.  A cell that fails fails
       the run;
    b. on the card: 13b's Trainer run (same config, seed and steps) with
       ``mesh=`` a (1, 1) ``DeviceMesh`` over a world-size-1 NCCL group
       and ``rules=Rules(mesh)``: every leaf a DTensor, the losses equal
       13b's within 1e-5; the median step, kernels a step and the device's
       busy share against 13b's (DTensor's host cost); the group is
       destroyed afterwards;
    c. the dry-run of 14b's cell, traced at full depth on a ``fake`` group
       of one rank: its compute term against 14b's measured step and
       ``PERF.md`` §5's 3.7528 ms FLOP bound;
    d. on the card: the FHP cell's recorder (``roofline.trace``) around
       two rounds of the sharded path on the 2 x 2 mesh of slots (phase
       3's lane 0, depth 8): its kernel launches equal the wrappers'
       count, its exchange bytes and copies the stepper's ``EXCHANGE``,
       its halo bytes a shard a round ``sharded_fhp_traffic``'s, and the
       run equals the same run unrecorded, bit for bit.

Every entry's ``max_abs_err`` comes from its timed launch held against the
plain version.

It ends with a kernels line and, last, ``{"ok": true, "device": ...}``.
The K1/K3/K4 entries add ``launches_serve`` (phase 8a's launches),
``tile_ms`` (the same launch on the tile kernel), K1 and K3
``launches_poiseuille`` (phase 9's) and ``launches_streamed`` (the main
path's launches that the row-streaming kernel ran), and the
K5 entry ``launches_overlap`` (phase 6's overlapped run),
``launches_serve_mesh`` (phase 8c's mesh engine), ``split_piece_ms``
(each piece of the split round) and ``overlap_round`` (phase 7's
timeline, ms).
"""
import concurrent.futures
import contextlib
import functools
import json
import math
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
# Tile shapes (rows x words) timed at T = 8 in phase 4 on the tile kernel,
# and strip counts of the streamed launch.
TILES = ((32, 32), (48, 32), (64, 32), (64, 64), (32, 48), (40, 48),
         (64, 48), (32, 112))
STRIPS = (6, 8, 10, 16)
# Phase 8: the serve path.
SERVE_FRAME_EVERY, SERVE_CKPT_EVERY = 16, 4
SERVE_MESH_HW, SERVE_MESH_STEPS = (1024, 8192), 32
# Phase 9: the Poiseuille example at its defaults.
POIS_HW, POIS_STEPS, POIS_P_FORCE = (64, 512), 3000, 0.02
# Phase 10: the LM serve path.
LM_SMOKE_ARCHS = ("repro-100m", "gemma2-27b", "deepseek-v3-671b",
                  "llama4-scout-17b-a16e", "mamba2-2.7b", "zamba2-2.7b")
LM_SMOKE_ATOL = 1e-3        # float32 logits, card against CPU
LM_ARCH, LM_SLOTS, LM_MAX_LEN = "internlm2-20b", 4, 1024
LM_REQUESTS, LM_PROMPT_LENS, LM_MAX_NEW = 8, (32, 513), 32
# Engine logits against a teacher-forced forward: float32 at full width
# with the depth cut to LM_CHECK_LAYERS (the correctness check), then bf16
# at full depth.  In bf16 the same forward over a prefix and over the
# whole sequence already differ by ~0.5 at 48 layers of these random
# weights (PERF.md §6): the bf16 tolerance is twice that.
LM_CHECK_LAYERS, LM_FP32_ATOL = 4, 1e-3
LM_BF16_ATOL = 1.0
# Phase 11: the experts/MLA and SSM/hybrid families at published width,
# phase 10b's traffic.  Float32 runs (the teacher-forced check at
# LM_FP32_ATOL): deepseek-v3 cut to DS_CHECK_LAYERS (its first layer
# dense) and llama4-scout to SCOUT_CHECK_LAYERS, each at the capacity
# factor n_experts / top_k, under which no assignment is dropped; mamba2
# and zamba2 at full depth.  deepseek-v3's forward buffers (E, C, D) are
# float32 and C is the whole sequence at that factor (~4 GB each at
# C = 544 beside 58.5 GB of parameters), so its check takes the two
# shortest prompts.  Bf16 runs: deepseek-v3 at DS_BF16_LAYERS (its three
# dense-prefix layers and two MoE layers, published capacity factor),
# mamba2 and zamba2 at full depth.
DS_CHECK_LAYERS, DS_CHECK_DENSE = 2, 1
DS_BF16_LAYERS = 5
SCOUT_CHECK_LAYERS = 2
# Phase 12: the encoder-decoder at published width and depth: a batch of
# ENC_BATCH, ENC_FRAMES frames of SyntheticLM(frames_dim=d_model,
# seed=ENC_SEED), prompts of the stream's first ENC_PROMPT tokens,
# ENC_NEW greedy tokens through prefill and decode_step.
ENC_ARCH, ENC_SEED = "seamless-m4t-medium", 7
ENC_BATCH, ENC_FRAMES, ENC_PROMPT, ENC_NEW = 4, 512, 16, 64
# Phase 13: training.  13b is the reference example's --full config
# (train_lm.py) with its step count cut; 13c one step of the
# encoder-decoder at full width.
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = "repro-100m", 512, 8, 60
TRAIN_LR, TRAIN_WARMUP, TRAIN_CKPT_EVERY, TRAIN_STOP = 3e-4, 20, 20, 20
TRAIN_SMOKE_ATOL = 1e-4     # float32, card against CPU (13a)
ENC_TRAIN_SEQ, ENC_TRAIN_BATCH = 256, 4
BF16_FLOPS = 989e12         # H100 SXM datasheet, dense bf16
# Phase 14: the dry-run (14a: three cells on the single-pod production
# mesh, 256 fake ranks, one subprocess each, all started together) and
# sharded training (14b-d).  PERF.md §5 holds 13b's FLOP bound from an
# earlier run, which 14c's compute term is set beside.
DRYRUN_CELLS = (("internlm2-20b", "train_4k"),
                ("deepseek-v3-671b", "decode_32k"), ("fhp-lattice", "fhp"))
DRYRUN_RANKS, DRYRUN_TIMEOUT_S = 256, 600
PERF_TRAIN_BOUND_MS = 3.7528
SHARDED_LOSS_ATOL = 1e-5
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


def _tile_launch(x, T, bh, bw, rec=()):
    """One fhp2 launch of ``x`` at p_force ``P_FORCE`` on the tile kernel
    (``fhp_step_kernel``, bh x bw tiles), where the program streams it:
    the tile design's time beside the streamed one."""
    from repro_torch.core import prng, rulespec
    from repro_torch.kernels.fhp_step import ops
    h, wd = x.shape[-2:]
    n_moments = rulespec.moment_spec(rulespec.get_rule("fhp2")).n_moments
    return ops._launch(x, None, None, None, ops._RULE_ID["fhp2"],
                       ops._MODE_ID["periodic"], 0, 0, 0, 0, 0, bh, bw, T,
                       prng.quantize_p(P_FORCE), tuple(rec),
                       n_moments if rec else 0, (0, h, 0, wd))


def _stream_line(card, T, bw, ms, sms) -> str:
    """A streamed fhp2 launch at T on the main lattice with strips of at
    most ``bw`` words: its geometry, what the card gives the kernel
    (``ops.kernel_info``), the rows a block owns, its thread word-steps
    per owned word-step and its time ``ms`` (None: not timed)."""
    from repro_torch.kernels.fhp_step import ops
    wd = WIDTH // 32
    g = ops.stream_geometry(wd, T, 8, bw)
    occ = ops.kernel_info("fhp2", "streamed", False, 0, bw, T)
    if occ["smem_bytes"] != g["smem_bytes"]:
        raise AssertionError(f"ops.stream_geometry's {g['smem_bytes']} B of "
                             f"shared memory, the kernel takes "
                             f"{occ['smem_bytes']}")
    blocks = sms * occ["blocks_per_sm"]
    return (f"[stream] {card} | T={T}: {g['strips']} strips of {g['owned']}"
            f" words (rows {g['words']} words with the apron), "
            f"{LANES * g['strips'] * HEIGHT / blocks:.1f} rows a block, "
            f"{g['per_warp']} chunks a warp, {32 * g['warps']} threads, "
            f"{occ['blocks_per_sm']} blocks/SM, {occ['registers']} registers"
            f" ({occ['local_bytes']} B local), {occ['smem_bytes']} B shared;"
            f" thread word-steps per owned "
            f"{ops.stream_thread_steps(HEIGHT, wd, T, 8, LANES, bw, blocks):.4f}"
            + ("" if ms is None else f"; {ms:.4f} ms/launch"))


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
def _marked(module, name, marks):
    """While open, each call of ``module.name`` appends ``(name, stream,
    start, end)`` to ``marks``: CUDA events recorded around the call on
    the stream current at the call."""
    inner = getattr(module, name)

    def wrapped(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = inner(*args, **kw)
        end.record()
        marks.append((name, torch.cuda.current_stream(), start, end))
        return res

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, inner)


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
    from repro_torch.kernels.fhp_step import ops
    marks = []
    torch.cuda.synchronize()
    seg = _segments()
    start = torch.cuda.Event(enable_timing=True)
    with _marked(ops, "_launch", marks):
        t = time.perf_counter()
        start.record()
        res = run(*args)
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    ev = [(a, b) for _, _, a, b in marks]
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


def _round_timeline(mesh, placed, kw, card) -> dict:
    """Phase 7: one overlapped and one serial round of the sharded stepper
    on the card with CUDA events around each part -- the interior launches
    (side stream), the boundary-slice exchange, the boundary launches and
    the in-place composition (current stream); the serial round's
    exchange and launches -- each part's interval from the round's start,
    how long the interior and the exchange ran at the same time, and the
    two rounds' walls.  Returns the overlapped round's numbers (ms)."""
    from repro_torch.core import distributed
    from repro_torch.kernels.fhp_step import ops
    parts = {True: ((ops, "run_extended_interior"),
                    (distributed, "_exchange_boundary"),
                    (ops, "run_extended_boundary"), (ops, "compose_split")),
             False: ((distributed, "_exchange_halo"), (ops, "run_extended"))}
    steppers = {ov: distributed.make_sharded_stepper(mesh, overlap=ov, **kw)
                for ov in parts}
    for step in steppers.values():      # warm: side stream, memory
        step(placed, 0)
    torch.cuda.synchronize()
    spans = {}
    for ov, wrapped in parts.items():
        marks = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with contextlib.ExitStack() as stack:
            for module, name in wrapped:
                stack.enter_context(_marked(module, name, marks))
            start.record()
            res = steppers[ov](placed, 0)
            end.record()
        torch.cuda.synchronize()
        del res
        cur = torch.cuda.current_stream()
        spans[ov] = {"round": (0.0, start.elapsed_time(end))}
        for name in dict.fromkeys(n for n, *_ in marks):
            calls = [(start.elapsed_time(a), start.elapsed_time(b), st)
                     for n, st, a, b in marks if n == name]
            spans[ov][name] = (min(c[0] for c in calls),
                               max(c[1] for c in calls))
            stream = "side" if calls[0][2] != cur else "current"
            print(f"[timeline] {card} | overlap={ov} round: {name} on the "
                  f"{stream} stream, {len(calls)} calls, "
                  f"{spans[ov][name][0]:.4f}-{spans[ov][name][1]:.4f} ms "
                  f"after the round's start, busy "
                  f"{sum(b - a for a, b, _ in calls):.4f} ms "
                  f"(calls {[(round(a, 4), round(b, 4)) for a, b, _ in calls]})")
    sp = spans[True]
    (i0, i1), (e0, e1) = sp["run_extended_interior"], sp["_exchange_boundary"]
    both = max(0.0, min(i1, e1) - max(i0, e0))
    print(f"[timeline] {card} | overlapped round {sp['round'][1]:.4f} ms "
          f"against the serial round {spans[False]['round'][1]:.4f} ms; the "
          f"interior launches ({i1 - i0:.4f} ms) and the boundary-slice "
          f"exchange ({e1 - e0:.4f} ms) ran {both:.4f} ms at the same time")
    return {"round_ms": sp["round"][1],
            "serial_round_ms": spans[False]["round"][1],
            "interior_ms": i1 - i0, "exchange_ms": e1 - e0,
            "boundary_ms": sp["run_extended_boundary"][1]
            - sp["run_extended_boundary"][0],
            "interior_and_exchange_ms": both}


def _sharded_pick(mesh, placed, out, mom, walls, card) -> None:
    """Phase 7: the exchange-latency probe, and ``autotune_launch``'s
    sharded pick for the phase-6 shard beside the modeled and measured
    runs of the phase-6 points; a pick whose depth divides the steps runs
    once through ``make_ensemble_run`` (held bit-equal to phase 3) and is
    timed ``MAIN_REPEATS`` times."""
    import math

    from repro_torch.core import distributed
    from repro_torch.kernels.fhp_step import check, ops
    from repro_torch.roofline import analysis
    lat = analysis.measured_exchange_latency()
    n = torch.cuda.device_count()
    branch = (f"timed: a ring over {n} cards" if n >= 2 else
              "the constant EXCHANGE_LATENCY_S: one card has no link to time")
    print(f"[latency] {card} | measured_exchange_latency() = {lat:.4e} s "
          f"({branch})")
    hl, wdl = placed.tiles[0][0].shape[-2:]
    t = time.perf_counter()
    pick = ops.autotune_launch(hl, wdl, max_depth=16,
                               moments_words=mom.shape[-1])
    print(f"[autotune] {card} | sharded, {hl} x {wdl}-word shards, depth <= "
          f"16: autotune_launch picks (block_rows, block_words, T, depth, "
          f"overlap) = {pick} ({time.perf_counter() - t:.2f} s on the host)")
    bh, bw, T, depth, ov = pick
    measured = {}
    if STEPS % depth == 0:
        k = math.gcd(T_MAIN, depth)      # phase 3 recorded every T_MAIN
        run, _ = distributed.make_ensemble_run(
            mesh, STEPS, variant="fhp2", p_force=P_FORCE, depth=depth,
            steps_per_launch=T, block_rows=bh, block_words=bw, overlap=ov,
            moments_every=k)
        _reset_counts()
        (pout, pmom), first = _path_run(run, placed, 0)
        _, modes = _counts()
        every = T_MAIN // k
        for name, a, b in (("planes", pout.gather(), out),
                           ("moments", pmom[..., every - 1::every, :], mom)):
            where = check.first_difference(a, b)
            if where is not None:
                raise AssertionError(f"autotuner's sharded pick: {name} "
                                     f"differ first at {where}")
        del pout, pmom
        print(f"[autotune] {card} | the pick through make_ensemble_run: "
              f"first run {_fmt_run(first)}; launches by mode {modes}; "
              f"planes and moments bit-equal to phase 3")
        measured[pick] = _repeats("sharded run at the autotuner's pick",
                                  card, run, placed, 0)
    else:
        print(f"[autotune] {card} | the pick's depth {depth} does not divide "
              f"{STEPS} steps: not run")
    default = ops.pick_tile(hl + 2 * DEPTH, wdl + 2, T_MAIN)
    for o in (False, True):
        measured[(*default, T_MAIN, DEPTH, o)] = walls[o]
    sites = LANES * HEIGHT * WIDTH
    for (pbh, pbw, pt, pd, po), wall in measured.items():
        cost = ops.sharded_launch_cost(pbh, pt, pd, hl, wdl,
                                       block_words=pbw, overlap=po)
        print(f"[autotune] {card} | tile {pbh} x {pbw}, T={pt}, depth {pd}, "
              f"overlap={po}: modeled {cost:.4e} s a site update, "
              f"{cost * sites * pd * 1e3:.4f} ms a round, "
              f"{cost * sites * STEPS:.4f} s a run; measured median "
              f"{wall:.4f} s a run, {wall / (STEPS // pd) * 1e3:.4f} ms a "
              f"round{' <- pick' if (pbh, pbw, pt, pd, po) == pick else ''}")


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
        if overlap:
            # Two more runs from the same placed state, back to back: a
            # stream or allocator hazard would show as a difference.
            for i in (2, 3):
                again, amom = run(placed, 0)
                for name, a, b in (("planes", again.gather(), out),
                                   ("moments", amom, mom)):
                    where = check.first_difference(a, b)
                    if where is not None:
                        raise AssertionError(f"overlapped run {i}: {name} "
                                             f"differ first at {where}")
                del again, amom
            print(f"[sharded] overlap=True: runs 2 and 3 from the same "
                  f"placed state bit-equal to the first")
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
    rkw = dict(t0=0, steps_per_launch=T_MAIN, moments_every=T_MAIN, **glob)
    ext = distributed._exchange_halo(tiles, DEPTH, devs)
    ex_ms = _time_ms(lambda: distributed._exchange_halo(tiles, DEPTH, devs),
                     reps=5)
    bnd_ms = _time_ms(lambda: distributed._exchange_boundary(
        tiles, DEPTH, devs), reps=5)
    slices = distributed._exchange_boundary(tiles, DEPTH, devs)

    def each_shard(fn):
        return lambda: [fn(iy, ix) for iy in range(len(tiles))
                        for ix in range(len(tiles[0]))]

    serial_ms = _time_ms(each_shard(lambda iy, ix: ops.run_extended(
        ext[iy][ix], DEPTH, y0=iy * hl - DEPTH, xw0=ix * wdl - 1, **rkw)),
        reps=5)
    interior_ms = _time_ms(each_shard(lambda iy, ix: ops.run_extended_interior(
        tiles[iy][ix], DEPTH, y0=iy * hl, xw0=ix * wdl, **rkw)), reps=5)
    boundary_ms = _time_ms(each_shard(lambda iy, ix: ops.run_extended_boundary(
        slices[iy][ix], DEPTH, y0=iy * hl, xw0=ix * wdl, **rkw)), reps=5)
    print(f"[time] {card} | one round, serial, one stream: exchange "
          f"{ex_ms:.4f} ms + {shards} extended launches {serial_ms:.4f} ms = "
          f"{ex_ms + serial_ms:.4f} ms; measured "
          f"{walls[False] / rounds * 1e3:.4f} ms per round (median run)")
    print(f"[time] {card} | one round, overlap, each part alone on one "
          f"stream: boundary-slice exchange {bnd_ms:.4f} ms, {shards} "
          f"interior launches {interior_ms:.4f} ms, {4 * shards} boundary "
          f"launches {boundary_ms:.4f} ms; measured "
          f"{walls[True] / rounds * 1e3:.4f} ms per round (median run)")
    del slices
    timeline = _round_timeline(mesh, placed, kw, card)
    _sharded_pick(mesh, placed, out, mom, walls, card)

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
    piece_ms = {}
    for name, rows, words, dy, dx, owned in pieces:
        x = e[..., rows, words].contiguous()
        xh, xw = x.shape[-2:]
        pkw = dict(one, y0=-d + dy, xw0=-1 + dx,
                   moment_bounds=(d, xh - d, 1, xw - 1))
        label = f"run_extended_split piece {name} {tuple(x.shape)}"
        timed = _timed(
            label, lambda: ops.fhp_step_cuda(x, 0, **pkw),
            lambda: ref.fhp_step_ref(x, 0, **pkw), x, T_MAIN, 1, False,
            counted, (slice(d, xh - d), slice(1, xw - 1)), owned=owned)
        piece_ms[name] = timed[0]
        _print_time(card, label, timed)
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
               launches_overlap=modes[True]["extended"],
               split_piece_ms=piece_ms, overlap_round=timeline),
        _entry("fhp_step K6 static solid, extended", "extended_static_solid",
               static_modes["extended_static_solid"], timed_k6, card),
        _entry("fhp_step K2 precomputed RNG", "precomputed_rng",
               k2_modes["precomputed_rng"], timed_k2, card),
    ]


def _single_device_pick(planes, card, swept, n_moments, counted) -> None:
    """Phase 4: ``autotune_launch``'s single-device pick for this lattice
    beside the measured tile and T sweeps ``swept`` ((bh, bw, T) -> ms a
    launch on the tile kernel, which the model prices): for each timed
    point the modeled cost against the main
    tile's at T = 8, beside the measured ms a step against its; the pick
    itself is timed (held bit-equal to the plain version first) where the
    sweeps did not time it."""
    from repro_torch.kernels.fhp_step import ops, ref
    wd = WIDTH // 32
    pick = ops.autotune_launch(HEIGHT, wd, moments_words=n_moments)
    bh, bw, T = pick
    if pick not in swept:
        timed = _timed("autotuner's pick", functools.partial(
            _tile_launch, planes, T, bh, bw), lambda: ref.fhp_step_ref(
                planes, 0, p_force=P_FORCE, steps_per_launch=T),
            planes, T, 0, False, counted)
        swept[pick] = timed[0]
    main = (*ops.pick_tile(HEIGHT, wd, T_MAIN), T_MAIN)
    base_cost = ops.launch_cost(main[0], T_MAIN, main[1], wd,
                                moments_words=n_moments)
    base_ms = swept[main] / T_MAIN
    print(f"[autotune] {card} | single device, {HEIGHT} x {wd} words: "
          f"autotune_launch picks tile {bh} x {bw} at T={T} ("
          f"{swept[pick]:.4f} ms/launch, {swept[pick] / T:.4f} ms per step "
          f"against {base_ms:.4f} at the main tile {main[:2]}, T={T_MAIN})")
    for (h_, w_, t_), t_ms in sorted(swept.items(), key=lambda kv: kv[0][2]):
        cost = ops.launch_cost(h_, t_, w_, wd, moments_words=n_moments)
        fits = ops.smem_bytes(h_, w_, t_) <= ops.TILE_SMEM_BYTES
        print(f"[autotune] {card} | tile {h_} x {w_}, T={t_}: modeled cost "
              f"{cost / base_cost:.4f} of the main tile's, measured ms per "
              f"step {t_ms / t_ / base_ms:.4f} of its"
              f"{'' if fits else ' (outside the two-blocks-an-SM budget)'}"
              f"{' <- pick' if (h_, w_, t_) == pick else ''}")


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
        got = (g.state, g.last_moments)
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


# -- phases 9 and 10 ----------------------------------------------------------

def _poiseuille(dev, card):
    """Phase 9: the Poiseuille example at its defaults through the kernel
    (``make_ensemble_run(None, ...)``), held bit-equal to
    ``bitplane.run_planes`` on the card after the warm phase and at the
    end, with the example's fit and asserts.  Returns the kernel run's
    launches by mode."""
    from repro_torch import scenarios
    from repro_torch.examples import poiseuille
    from repro_torch.kernels.fhp_step import check
    sc = scenarios.get("poiseuille", height=POIS_HW[0], width=POIS_HW[1],
                       p_force=POIS_P_FORCE)
    runs = {}
    for plain in (False, True):
        torch.cuda.synchronize()
        _reset_counts()
        t = time.perf_counter()
        res = poiseuille.simulate(sc, POIS_STEPS, dev, plain=plain)
        torch.cuda.synchronize()
        runs[plain] = (res, (time.perf_counter() - t) * 1e3, _counts())
    (kwarm, kend, kprof), k_ms, (launches, modes) = runs[False]
    (pwarm, pend, pprof), p_ms, (plain_launches, _) = runs[True]
    if launches == 0 or plain_launches:
        raise AssertionError(f"Poiseuille: {launches} kernel launches "
                             f"through the entry point, {plain_launches} "
                             f"in the plain run")
    for name, a, b in (("after the warm phase", kwarm, pwarm),
                       ("at the end", kend, pend)):
        where = check.first_difference(a, b)
        if where is not None:
            raise AssertionError(f"Poiseuille {name}: the kernel run "
                                 f"differs from run_planes first at {where}")
    if not (kprof == pprof).all():
        raise AssertionError("Poiseuille profiles differ")
    r2, coef = poiseuille.fit(kprof)
    if not (r2 > 0.9 and coef[0] < 0):
        raise AssertionError(f"Poiseuille: R^2 {r2:.4f}, curvature "
                             f"{coef[0]:.3e}")
    print(f"[poiseuille] {card} | {POIS_HW[0]} x {POIS_HW[1]}, {POIS_STEPS} "
          f"steps, p_force {POIS_P_FORCE}: R^2 = {r2:.4f}, curvature a = "
          f"{coef[0]:.3e}; kernel run {k_ms:.1f} ms ({launches} launches, by "
          f"mode {modes}), run_planes on the card {p_ms:.1f} ms; planes "
          f"bit-equal after the warm phase and at the end")
    return modes


@contextlib.contextmanager
def _recorded(module, name, calls, engine=None):
    """While open, each call of ``module.name`` (an LM entry point the
    engine calls) appends ``(tokens in, seconds to its device
    synchronisation, logits on the host as float32, live slots' request
    ids)`` to ``calls``."""
    inner = getattr(module, name)

    def wrapped(params, cfg, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = inner(params, cfg, *args, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = (args[0]["tokens"].numel() if name == "prefill"
                else args[1].numel())
        rids = ([s.rid if s is not None else None for s in engine.slots]
                if engine is not None else None)
        calls.append((toks, dt, logits.float().cpu(), rids))
        return logits, cache

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, inner)


def _serve_reqs(vocab, n, lens, max_new, seed=7):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(*lens))
        out.append(Request(rid=rid, prompt=rng.integers(
            0, vocab, plen).astype(np.int32), max_new=max_new))
    return out


def _lm_smoke_check(dev, card):
    """Phase 10, the check: smoke configs in float32 built from the same
    seeded numpy parameters on the card and the CPU, the same 8 requests
    through ``ServeEngine`` on both: equal greedy tokens, every logit the
    engines saw within ``LM_SMOKE_ATOL``; matmuls at "highest" precision
    (no TF32)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params, lm, params_from_reference
    from repro_torch.serve import ServeEngine, lm_engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for arch in LM_SMOKE_ARCHS:
        cfg = get_smoke(arch)
        tree = lm.tree_map(lambda t: t.numpy(),
                           init_params(cfg, seed=0, device="cpu"))
        res = {}
        for d in (dev, torch.device("cpu")):
            eng = ServeEngine(params_from_reference(tree, cfg, device=d), cfg,
                              batch_size=4, max_len=96, device=d)
            for r in _serve_reqs(cfg.vocab, 8, (4, 24), 12):
                eng.submit(r)
            calls = []
            with _recorded(lm_engine, "prefill", calls), \
                    _recorded(lm_engine, "decode_step", calls):
                done = eng.run_until_done()
            res[d.type] = ({r.rid: r.out for r in done}, calls)
        (gtok, gcalls), (ctok, ccalls) = res["cuda"], res["cpu"]
        if len(gtok) != 8 or gtok != ctok:
            raise AssertionError(f"{arch} smoke: card tokens {gtok} differ "
                                 f"from the CPU's {ctok}")
        err = max(float((a[2] - b[2]).abs().max())
                  for a, b in zip(gcalls, ccalls))
        if len(gcalls) != len(ccalls) or not err <= LM_SMOKE_ATOL:
            raise AssertionError(f"{arch} smoke: logits differ by {err} "
                                 f"(> {LM_SMOKE_ATOL})")
        print(f"[lm] {card} | {arch} smoke (float32, matmul precision "
              f"{torch.get_float32_matmul_precision()}, TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32}): 8 requests, "
              f"{sum(map(len, gtok.values()))} tokens equal on the card and "
              f"the CPU; {len(gcalls)} prefill/decode calls, logits max abs "
              f"difference {err:.3e} (<= {LM_SMOKE_ATOL})")


def _forward_logits(params, cfg, toks, dev, start=0):
    """``forward``'s logits rows ``start:len(toks)`` of one sequence, as
    float32 on the host; an SSM or hybrid sequence is right-padded to its
    chunk first (the model is causal: the real rows are unaffected)."""
    import numpy as np
    from repro_torch.models import forward
    n = len(toks)
    pad = (-n) % cfg.ssm.chunk if cfg.ssm else 0
    out, _ = forward(params, cfg, {"tokens": torch.as_tensor(
        np.pad(toks, (0, pad))[None], dtype=torch.int64, device=dev)})
    return out[0, start:n].float().cpu()


def _teacher_forced(params, cfg, r, pre_row, dec, dev, tol, label, card):
    """For served request ``r``: a teacher-forced ``forward`` over prompt +
    output must have the decoded token as its argmax at every generated
    position whose top-2 margin is at least ``tol``, and the engine's
    logits there (its prefill row ``pre_row`` and its row of each decode
    step in ``dec``) must lie within ``tol`` of forward's.  Also prints
    the same positions' difference between forward over a prefix (prompt
    + half the output) and forward over the whole: the rounding noise
    of the compute dtype alone."""
    import numpy as np
    seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
    s0, n = len(r.prompt) - 1, len(r.out)

    def logits(toks):
        return _forward_logits(params, cfg, toks, dev, s0)

    fl = logits(seq)                                    # (n, vocab)
    floor = float((logits(seq[:s0 + 1 + n // 2]) - fl[:n // 2 + 1]).abs().max())
    eng_l = torch.stack([pre_row] + [c[2][c[3].index(r.rid)] for c in dec
                                     if r.rid in c[3]])
    if eng_l.shape != fl.shape:
        raise AssertionError(f"{label} request {r.rid}: {eng_l.shape[0]} "
                             f"engine logit rows for {n} generated positions")
    top2 = fl.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    arg, want = fl.argmax(dim=-1), torch.tensor(r.out)
    bad = (arg != want) & (margin >= tol)
    excused = int(((arg != want) & (margin < tol)).sum())
    diff = (eng_l - fl).abs()
    worst = diff.amax(dim=-1)
    print(f"[lm] {card} | {label} request {r.rid} (prompt {len(r.prompt)}): "
          f"teacher-forced forward over {len(seq)} tokens -- argmax equal to "
          f"the decoded token at {int((arg == want).sum())} of {n} "
          f"positions, {excused} more under the top-2 margin {tol}; engine "
          f"logits against forward's: max abs difference "
          f"{float(diff.max()):.3e} (at generated position "
          f"{int(worst.argmax())}), mean {float(diff.mean()):.3e}, tolerance "
          f"{tol}; forward over a prefix against the whole: {floor:.3e}; "
          f"smallest top-2 margin {float(margin.min()):.4f}")
    if bad.any() or not float(diff.max()) <= tol:
        raise AssertionError(
            f"{label} request {r.rid}: teacher-forced argmax differs at "
            f"{bad.nonzero().flatten().tolist()} (margins >= {tol}); logits "
            f"max abs difference {float(diff.max())} (> {tol}?)")


def _lm_decode_profile(params, cfg, eng, label, card, steps=3):
    """``steps`` batched decode steps on the engine's cache under
    ``torch.profiler`` (``_profiled``), every slot at position 600."""
    from repro_torch.models import decode_step
    toks = torch.zeros(eng.bs, dtype=torch.int64, device=eng.device)
    pos = torch.full((eng.bs,), 600, dtype=torch.int64, device=eng.device)
    decode_step(params, cfg, eng.cache, toks, pos)         # warm
    _profiled(lambda: decode_step(params, cfg, eng.cache, toks, pos),
              f"{label}: {steps} decode steps", "a step", card, steps)


def _profiled(fn, label, unit, card, steps=3):
    """``fn`` called ``steps`` times under ``torch.profiler``: wall,
    device time of the kernels (the device's busy share), kernel count
    and the kernels that take the most, per call.  Returns (device busy
    share of the wall, kernels a call), None for either not measured."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in rows)
    n_k = sum(e.count for e in rows)
    if not dev_us:
        print(f"[lm-profile] {card} | {label}: the profiler showed no "
              f"device time (not measured); wall {wall / steps * 1e3:.3f} "
              f"ms {unit}")
        return None, None
    top = sorted(rows, key=lambda e: -getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
    print(f"[lm-profile] {card} | {label}, wall "
          f"{wall / steps * 1e3:.3f} ms {unit}, device busy "
          f"{dev_us / 1e3 / steps:.3f} ms {unit} "
          f"({dev_us / 1e6 / wall:.4f} of the wall), {n_k / steps:.0f} "
          f"kernels {unit}; most device time: " + "; ".join(
              f"{e.key[:60]} x{e.count // steps} "
              f"{getattr(e, 'self_device_time_total', getattr(e, 'self_cuda_time_total', 0)) / 1e3 / steps:.3f} ms"
              for e in top[:6]))
    return dev_us / 1e6 / wall, n_k / steps


def _describe(cfg) -> str:
    """The width of ``cfg``'s family-specific parts, for the run lines."""
    parts = []
    if cfg.mla:
        m = cfg.mla
        parts.append(f"MLA q_lora {m.q_lora}, kv_lora {m.kv_lora}, rope "
                     f"{m.rope_dim}, nope {m.nope_dim}, v {m.v_dim}")
    if cfg.moe:
        e = cfg.moe
        parts.append(f"{e.n_experts} experts top-{e.top_k} + {e.n_shared} "
                     f"shared, d_ff_expert {e.d_ff_expert}, first_dense "
                     f"{e.first_dense}, capacity factor {e.capacity_factor}")
    if cfg.ssm:
        m = cfg.ssm
        parts.append(f"SSD d_state {m.d_state}, head_dim {m.head_dim}, "
                     f"expand {m.expand}, chunk {m.chunk}")
    if cfg.shared_attn_period:
        parts.append(f"{cfg.n_shared_blocks} shared blocks every "
                     f"{cfg.shared_attn_period} layers")
    return "; ".join(parts)


def _lm_serve_run(dev, card, cfg, dtype, label, *, tol=None,
                  check_rids=(0, 1), prefill_check=False, profile=False):
    """Phases 10b and 11: ``cfg`` with parameters drawn on the card in
    ``dtype``, served by ``ServeEngine`` (``LM_SLOTS`` slots,
    ``LM_MAX_LEN``, a cache in ``dtype``) for ``LM_REQUESTS`` greedy
    requests; every request finishes.  With ``tol``, requests
    ``check_rids`` pass ``_teacher_forced`` at it; with
    ``prefill_check``, their prefill logits pass
    ``_prefill_against_forward``.  The step's byte bound counts every
    parameter the decode step reads (every expert; not the MTP leaves).
    Returns the run's numbers."""
    from repro_torch.models import init_params, lm, param_count
    from repro_torch.serve import ServeEngine, lm_engine
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    param_bytes = sum(p.numel() * p.element_size()
                      for p in lm.tree_leaves(params))
    read_bytes = sum(p.numel() * p.element_size()
                     for p in lm.tree_leaves({k: v for k, v in params.items()
                                              if k != "mtp"}))
    extra = _describe(cfg)
    print(f"[lm] {card} | {label}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          f"{'; ' + extra if extra else ''}: "
          f"{lm.param_numel(params)} parameters (analytic, matrices only: "
          f"{param_count(cfg)['total']}), {param_bytes} bytes in {dtype} "
          f"({read_bytes} read by a decode step), drawn on the card in "
          f"{init_s:.2f} s")
    eng = ServeEngine(params, cfg, batch_size=LM_SLOTS, max_len=LM_MAX_LEN,
                      cache_dtype=dtype, device=dev)
    reqs = _serve_reqs(cfg.vocab, LM_REQUESTS, LM_PROMPT_LENS, LM_MAX_NEW)
    for r in reqs:
        eng.submit(r)
    pre, dec = [], []
    with _recorded(lm_engine, "prefill", pre, eng), \
            _recorded(lm_engine, "decode_step", dec, eng):
        t = time.perf_counter()
        done = eng.run_until_done()
        wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    if sorted(r.rid for r in done) != list(range(LM_REQUESTS)) or any(
            len(r.out) != LM_MAX_NEW for r in done):
        raise AssertionError(f"{label}: {len(done)} of {LM_REQUESTS} "
                             f"requests finished")
    n_tok = sum(len(r.out) for r in done)
    pre_tok = sum(c[0] for c in pre)
    pre_s = sum(c[1] for c in pre)
    dec_ms = sorted(c[1] * 1e3 for c in dec)
    bound_ms = read_bytes / HBM_BYTES_PER_S * 1e3
    med = statistics.median(dec_ms)
    print(f"[lm] {card} | {label} served {len(done)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}, {LM_MAX_NEW} new tokens each, "
          f"{LM_SLOTS} slots, max_len {LM_MAX_LEN}, greedy) in {wall:.3f} s: "
          f"{n_tok / wall:.2f} tokens/s; prefill {pre_s * 1e3:.1f} ms for "
          f"{pre_tok} prompt tokens ({pre_s * 1e3 / pre_tok:.4f} ms a token, "
          f"{len(pre)} calls); decode {len(dec)} steps, median "
          f"{med:.3f} ms (least {dec_ms[0]:.3f}, most {dec_ms[-1]:.3f}); "
          f"byte bound of a step (bytes a step reads / "
          f"{HBM_BYTES_PER_S:.3g} B/s) {bound_ms:.3f} ms, the median step "
          f"at {bound_ms / med:.4f} of it; peak memory {peak} bytes")
    if profile:
        _lm_decode_profile(params, cfg, eng, label, card)
    by_rid = {r.rid: r for r in done}
    rows = {rid: pre[rid][2][0] for rid in check_rids}   # queue order
    if tol is not None:
        for rid in check_rids:
            _teacher_forced(params, cfg, by_rid[rid], rows[rid], dec, dev,
                            tol, label, card)
    if prefill_check:
        _prefill_against_forward(params, cfg, [by_rid[i] for i in check_rids],
                                 rows, dev, label, card)
    del params, eng
    _free_memory()
    return {"param_bytes": param_bytes, "read_bytes": read_bytes,
            "peak_bytes": peak, "decode_ms": med, "bound_ms": bound_ms,
            "tokens_per_s": n_tok / wall,
            "prefill_ms_per_token": pre_s * 1e3 / pre_tok}


def _prefill_against_forward(params, cfg, reqs, rows, dev, label, card):
    """Phase 11's bf16 check: each request's prefill logits (``rows`` by
    request id) against ``forward`` over the same prompt, within twice
    the floor -- the largest forward-against-forward difference over the
    requests: over the prompt twice (run-to-run noise), and, at the
    prompt's positions, over the prompt and over the prompt + ``k`` of
    its generated tokens (the same math on other GEMM shapes).  For
    experts, ``k`` keeps the longer forward's capacity equal to the
    prompt's, so the same assignments are dropped in both."""
    import numpy as np
    from repro_torch.models import moe
    seen = []
    for r in reqs:
        s, k = len(r.prompt), len(r.out) // 2
        if cfg.moe:
            while k and moe.capacity(s + k, cfg) != moe.capacity(s, cfg):
                k -= 1
        if not k:
            raise AssertionError(f"{label} request {r.rid}: no prefix floor")
        whole = np.concatenate([r.prompt, np.asarray(r.out[:k], np.int32)])
        fl = _forward_logits(params, cfg, r.prompt, dev)   # (s, vocab)
        repeat = float((_forward_logits(params, cfg, r.prompt, dev) - fl)
                       .abs().max())
        prefix = float((_forward_logits(params, cfg, whole, dev)[:s] - fl)
                       .abs().max())
        diff = float((rows[r.rid] - fl[-1]).abs().max())
        same = int(rows[r.rid].argmax()) == int(fl[-1].argmax())
        seen.append((r, k, diff, same, repeat, prefix))
    floor = max(max(x[4], x[5]) for x in seen)
    for r, k, diff, same, repeat, prefix in seen:
        print(f"[lm] {card} | {label} request {r.rid} (prompt "
              f"{len(r.prompt)}): prefill logits against forward over the "
              f"prompt: max abs difference {diff:.3e}, argmax "
              f"{'equal' if same else 'differs'}; forward over the prompt "
              f"twice {repeat:.3e}, against the prompt + {k} tokens at the "
              f"prompt's positions {prefix:.3e}; tolerance {2 * floor:.3e} "
              f"(twice the floor over {len(seen)} requests)")
        if not diff <= 2 * floor:
            raise AssertionError(f"{label} request {r.rid}: prefill logits "
                                 f"differ from forward's by {diff} (> twice "
                                 f"the floor {floor})")


def _lm_full_width(dev, card):
    """Phase 10b: ``LM_ARCH`` at its published width in float32 with its
    depth cut to ``LM_CHECK_LAYERS`` (matmuls at "highest" precision;
    tolerance ``LM_FP32_ATOL``), then at its published width and depth in
    bf16 (tolerance ``LM_BF16_ATOL``)."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(LM_ARCH)
    cut = dataclasses.replace(full, n_layers=LM_CHECK_LAYERS, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _lm_serve_run(dev, card, cut, torch.float32,
                  f"{LM_ARCH} float32, {LM_CHECK_LAYERS} layers",
                  tol=LM_FP32_ATOL)
    return _lm_serve_run(dev, card, full, torch.bfloat16, f"{LM_ARCH} bf16",
                         tol=LM_BF16_ATOL, profile=True)


def _no_drop(cfg, **replace):
    """``cfg`` at the capacity factor n_experts / top_k: every expert can
    take every token, so no assignment is dropped."""
    import dataclasses
    e = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k, **replace))


def _lm_families(dev, card):
    """Phase 11: deepseek-v3 (MLA, 256 experts), llama4-scout (16
    experts), mamba2 (SSD) and zamba2 (SSD + shared attention) at their
    published widths through ``ServeEngine`` with phase 10b's traffic:
    float32 runs against a teacher-forced forward at ``LM_FP32_ATOL``
    (matmuls at "highest" precision), then bf16 runs with their numbers
    and a profile of three decode steps."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    lens = [len(r.prompt) for r in _serve_reqs(
        1000, LM_REQUESTS, LM_PROMPT_LENS, LM_MAX_NEW)]
    shortest = tuple(sorted(int(i) for i in np.argsort(lens)[:2]))
    ds = get_config("deepseek-v3-671b")
    cut = _no_drop(dataclasses.replace(ds, n_layers=DS_CHECK_LAYERS,
                                       dtype="float32"),
                   first_dense=DS_CHECK_DENSE)
    _lm_serve_run(dev, card, cut, torch.float32,
                  f"deepseek-v3-671b float32, {DS_CHECK_LAYERS} layers "
                  f"({DS_CHECK_DENSE} dense), no-drop capacity",
                  tol=LM_FP32_ATOL, check_rids=shortest)
    out = {"deepseek-v3-671b": _lm_serve_run(
        dev, card, dataclasses.replace(ds, n_layers=DS_BF16_LAYERS),
        torch.bfloat16, f"deepseek-v3-671b bf16, {DS_BF16_LAYERS} layers",
        check_rids=shortest, prefill_check=True, profile=True)}
    scout = get_config("llama4-scout-17b-a16e")
    _lm_serve_run(dev, card, _no_drop(dataclasses.replace(
        scout, n_layers=SCOUT_CHECK_LAYERS, dtype="float32")),
        torch.float32, f"llama4-scout-17b-a16e float32, "
        f"{SCOUT_CHECK_LAYERS} layers, no-drop capacity", tol=LM_FP32_ATOL)
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        full = get_config(arch)
        _lm_serve_run(dev, card, dataclasses.replace(full, dtype="float32"),
                      torch.float32, f"{arch} float32", tol=LM_FP32_ATOL)
        out[arch] = _lm_serve_run(dev, card, full, torch.bfloat16,
                                  f"{arch} bf16", profile=True)
    return out


def _mla_decode_core(dev, card, launches):
    """Phase 11's kernel row: MLA decode's attention core at DeepSeek-V3's
    widths, the kernel against the plain core
    (``kernels/mla_decode/check.py``), at the bf16 deepseek run's own
    decode shapes (``LM_SLOTS`` rows over ``LM_MAX_LEN`` positions, split
    and merged) and over 256 rows of 2,560 positions at the chat mix's
    depths (one split), which it times.  ``launches``: the kernel's
    launches by kind in the bf16 deepseek run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mla_decode import check as mcheck
    from repro_torch.kernels.mla_decode import ops as mops
    from repro_torch.models import attention
    cfg = get_config("deepseek-v3")
    m = cfg.mla
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {}
    for rows, t in ((LM_SLOTS, LM_MAX_LEN), (256, 2560)):
        splits, chunk = mops.plan(rows, cfg.n_heads, t, n_sm)
        pos = (mcheck.boundary_positions(t, chunk)[:rows] if splits > 1
               else mcheck.chat_positions(rows, t, seed=7))
        k = mcheck.case(rows, cfg.n_heads, m.kv_lora, m.rope_dim, t, pos,
                        scale=attention.mla_scale(cfg), device=dev, seed=7)
        err = mcheck.compare(k)
        if not (err["finite"] and err["kernel_vs_plain_max"] <= 2 ** -6):
            raise AssertionError(f"mla_decode kernel against plain at {rows} "
                                 f"rows x {t}, {splits} splits: {err}")
        errs[(rows, t, splits)] = err["kernel_vs_plain_max"]
    row = mcheck.time_core(k)
    checked = "; ".join(f"{r} rows x {t} in {s} split(s) {e:.2e}"
                        for (r, t, s), e in errs.items())
    print(f"[mla] {card} | attention core, 256 rows x 128 heads, 512 + 64, "
          f"{int((k.pv + 1).sum())} live keys: kernel {row['kernel_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{100 * row['share']:.2f}% of it; plain {row['plain_ms']:.4f} ms; "
          f"max relative L2 against plain: {checked}; the bf16 deepseek "
          f"run launched {launches['split']} split and {launches['merge']} "
          f"merge kernels")
    return {"name": "mla_decode attention core", "route": "cuda",
            "source": "src/repro_torch/kernels/mla_decode/csrc/mla_decode.cu",
            "replaces": None, "mode": "split-KV",
            "launches": launches["split"],
            "merge_launches": launches["merge"],
            "max_rel_l2": max(errs.values()),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "checked_vs_plain": True, "card": card}


# -- phases 12 and 13 ---------------------------------------------------------

def _encdec_decode_bytes(cfg, dtype, batch, max_len, t_enc) -> int:
    """Bytes one encoder-decoder ``decode_step`` must read, from the
    parameter shapes on the meta device: every decoder layer's leaves but
    the cross block's ``wk``/``wv`` (its K/V are cached), the final norm,
    the head (the tied embedding when tied), one embedding row a token,
    and the self and cross caches whole (the masked full-cache attention
    reads every slot)."""
    from repro_torch.models import init_params, lm
    meta = init_params(cfg, device="meta", dtype=dtype)
    size = torch.finfo(dtype).bits // 8
    layers = lm.param_numel(meta["layers"]) - sum(
        lm.param_numel(st["xattn"][w]) for st in meta["layers"].values()
        for w in ("wk", "wv"))
    head = lm.param_numel(meta["embed"] if cfg.tie_embeddings
                          else meta["head"])
    params = (layers + lm.param_numel(meta["final_norm"]) + head
              + batch * cfg.d_model)
    kv = cfg.n_kv_heads * cfg.hd
    caches = 2 * cfg.n_cycles * batch * (max_len + t_enc) * kv
    return (params + caches) * size


def _encdec_run(dev, card, cfg, dtype, label):
    """Phase 12's run: ``cfg``'s parameters drawn on the card in
    ``dtype``; ``ENC_BATCH`` rows of ``ENC_FRAMES`` frames from
    ``SyntheticLM``, prompts of its first ``ENC_PROMPT`` tokens: the
    encoder timed alone and ``prefill`` (each median of 3 after a first
    call), then ``ENC_NEW - 1`` greedy ``decode_step``s at per-row
    positions.  Returns (params, frames, prompt + generated tokens,
    logits of every generated position (B, ENC_NEW, V) float32 on the
    host, numbers)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import decode_step, init_params, lm, prefill
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev, dtype=dtype)
    data = SyntheticLM(cfg.vocab, ENC_FRAMES, ENC_BATCH, seed=ENC_SEED,
                       frames_dim=cfg.d_model).batch_at(0)
    frames = torch.from_numpy(data["frames"]).to(dev)
    toks = torch.from_numpy(data["tokens"][:, :ENC_PROMPT]).to(dev)
    max_len = ENC_PROMPT + ENC_NEW
    enc_ms = []
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lm._encode(lm.cast_params_for_compute(params, cfg), cfg, frames)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t) * 1e3)
        pre_ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = prefill(params, cfg, {"tokens": toks,
                                                  "frames": frames},
                                    max_len, cache_dtype=dtype)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t) * 1e3)
        rows, dec_ms = [logits.float().cpu()], []
        tok = logits.argmax(-1)
        pos = torch.full((ENC_BATCH,), ENC_PROMPT, dtype=torch.int64,
                         device=dev)
        seq = [toks, tok[:, None]]
        for _ in range(ENC_NEW - 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = decode_step(params, cfg, cache, tok, pos)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t) * 1e3)
            rows.append(logits.float().cpu())
            tok, pos = logits.argmax(-1), pos + 1
            seq.append(tok[:, None])
        peak = torch.cuda.max_memory_allocated()
        busy = kernels = None
        if dtype != torch.float32:
            last = pos - 1
            busy, kernels = _profiled(
                lambda: decode_step(params, cfg, cache, tok, last),
                f"{label}: 3 decode steps", "a step", card)
    bound_ms = _encdec_decode_bytes(cfg, dtype, ENC_BATCH, max_len,
                                    ENC_FRAMES) / HBM_BYTES_PER_S * 1e3
    med = statistics.median(dec_ms)
    enc = statistics.median(enc_ms[1:])
    pre = statistics.median(pre_ms[1:])
    print(f"[encdec] {card} | {label}: {cfg.enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}: {lm.param_numel(params)} parameters in "
          f"{dtype}; {ENC_BATCH} rows of {ENC_FRAMES} frames, prompts of "
          f"{ENC_PROMPT} tokens, {ENC_NEW} greedy tokens: encoder median "
          f"{enc:.3f} ms (first {enc_ms[0]:.3f}); prefill median {pre:.3f} "
          f"ms (first {pre_ms[0]:.3f}; {pre / (ENC_BATCH * ENC_PROMPT):.4f} "
          f"ms a prompt token, the encoder included; "
          f"{(pre - enc) / (ENC_BATCH * ENC_PROMPT):.4f} without it); decode {len(dec_ms)} steps, median {med:.3f} ms "
          f"(least {min(dec_ms):.3f}, most {max(dec_ms):.3f}), byte bound "
          f"{bound_ms:.4f} ms (bytes a step reads / {HBM_BYTES_PER_S:.3g} "
          f"B/s), the median step at {bound_ms / med:.4f} of it; peak "
          f"memory {peak} bytes")
    return (params, frames, torch.cat(seq, dim=1),
            torch.stack(rows, dim=1),
            {"encoder_ms": enc, "prefill_ms": pre, "decode_ms": med,
             "bound_ms": bound_ms, "peak_bytes": peak, "busy": busy,
             "kernels": kernels})


def _teacher_forced_logits(params, cfg, frames, seq, start, end):
    """``forward``'s logits over ``seq[:, :end]`` with the same frames,
    rows ``start:end``, float32 on the host."""
    from repro_torch.models import forward
    with torch.no_grad():
        out, _ = forward(params, cfg, {"tokens": seq[:, :end],
                                       "frames": frames})
    return out[:, start:end].float().cpu()


def _lm_encdec(dev, card):
    """Phase 12: ``ENC_ARCH`` at its published width and depth, first in
    float32 (every generated position's logits within ``LM_FP32_ATOL`` of
    a teacher-forced forward over prompt + generated tokens with the same
    frames; matmuls at "highest" precision), then timed in bf16 (held
    against the same forward within twice a measured floor: the larger of
    the bf16 forward's difference from the float32 forward of the same
    parameters -- the compute dtype's own rounding -- and of the bf16
    forward over prompt + half the generated tokens from the forward over
    all of them, at the shared positions)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    full = get_config(ENC_ARCH)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    n = ENC_PROMPT - 1 + ENC_NEW                 # tokens the forward sees
    out = {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        cfg = dataclasses.replace(full, dtype=name)
        label = f"{ENC_ARCH} {name}"
        params, frames, seq, rows, nums = _encdec_run(dev, card, cfg, dtype,
                                                      label)
        tf = _teacher_forced_logits(params, cfg, frames, seq,
                                    ENC_PROMPT - 1, n)
        diff = (rows - tf).abs()
        same = int((rows.argmax(-1) == tf.argmax(-1)).sum())
        note = ""
        if dtype == torch.float32:
            tol = LM_FP32_ATOL
        else:
            half = ENC_PROMPT - 1 + ENC_NEW // 2
            prefix = float((_teacher_forced_logits(
                params, cfg, frames, seq, ENC_PROMPT - 1, half)
                - tf[:, :half - ENC_PROMPT + 1]).abs().max())
            exact = _teacher_forced_logits(
                lm.tree_map(lambda t: t.float(), params),
                dataclasses.replace(cfg, dtype="float32"), frames, seq,
                ENC_PROMPT - 1, n)
            rounding = float((tf - exact).abs().max())
            tol = 2 * max(prefix, rounding)
            note = (f" (twice the floor: the larger of the bf16 forward "
                    f"against the float32 forward of the same parameters, "
                    f"{rounding:.3e}, and the bf16 forward over a prefix "
                    f"against the whole, {prefix:.3e}; the decoded logits "
                    f"against the float32 forward: "
                    f"{float((rows - exact).abs().max()):.3e})")
            del exact
        print(f"[encdec] {card} | {label}: prefill + decode against a "
              f"teacher-forced forward over {n} tokens: logits max abs "
              f"difference {float(diff.max()):.3e} (mean "
              f"{float(diff.mean()):.3e}), argmax equal at {same} of "
              f"{rows.shape[0] * rows.shape[1]} positions; tolerance "
              f"{tol:.3e}{note}")
        if not float(diff.max()) <= tol:
            raise AssertionError(f"{label}: decoded logits differ from the "
                                 f"teacher-forced forward's by "
                                 f"{float(diff.max())} (> {tol})")
        out[name] = nums
        del params, frames, rows, tf
        _free_memory()
    return out


def _train_smoke_check(dev, card):
    """Phase 13a: every assigned smoke config in float32 from the same
    seeded parameters and batch on the card and the CPU: the loss and
    every gradient leaf (within ``TRAIN_SMOKE_ATOL`` of the leaf's largest
    magnitude), then one ``AdamW.update`` from the same parameters and
    the CPU's gradients on both (within ``TRAIN_SMOKE_ATOL``); matmuls at
    "highest" precision.  Each device's update from its own gradients is
    printed beside it: Adam's first step, ``g / (|g| + eps)``, turns the
    ulp-level difference of a gradient element near 0 into a large
    difference of that element's step."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.registry import ASSIGNED
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, lm, loss_fn
    from repro_torch.optim import AdamW, cosine_schedule
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    opt = AdamW(lr=cosine_schedule(1e-3, 0, 10))
    cpu = torch.device("cpu")

    def update(params, grads):
        return list(lm.tree_leaves(opt.update(grads, opt.init(params),
                                              params)[0]))

    for arch in ASSIGNED:
        cfg = get_smoke(arch)
        cfg = _no_drop(cfg) if cfg.moe else cfg     # as test_models.nodrop
        host = init_params(cfg, seed=0, device="cpu")
        batch = SyntheticLM(cfg.vocab, cfg.ssm.chunk if cfg.ssm else 32, 4,
                            seed=3, frames_dim=cfg.d_model
                            if cfg.enc_layers else 0).batch_at(0)
        res = []
        for d in (dev, cpu):
            live = lm.tree_map(lambda t: t.to(d).requires_grad_(True), host)
            loss, met = loss_fn(live, cfg, {k: torch.from_numpy(v).to(d)
                                            for k, v in batch.items()})
            loss.backward()
            grads = lm.tree_map(lambda t: t.grad if t.grad is not None
                                else torch.zeros_like(t), live)
            res.append((float(loss.detach()), grads,
                        lm.tree_map(lambda t: t.detach(), live)))
        (gl, gg, gp), (hl, hg, hp) = res
        gerr = max(float((a.cpu() - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(lm.tree_leaves(gg), lm.tree_leaves(hg)))
        want = update(hp, hg)
        same = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            update(gp, lm.tree_map(lambda t: t.to(dev), hg)), want))
        own = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(update(gp, gg), want))
        print(f"[train] {card} | {arch} smoke (float32, {len(want)} leaves, "
              f"terms {sorted(met)}): loss card {gl:.7f} / CPU {hl:.7f}; "
              f"gradients within {gerr:.3e} of each leaf's largest "
              f"magnitude; one AdamW update from the CPU's gradients within "
              f"{same:.3e} (tolerance {TRAIN_SMOKE_ATOL}); from each "
              f"device's own gradients {own:.3e}")
        if not (abs(gl - hl) <= TRAIN_SMOKE_ATOL * max(1.0, abs(hl))
                and gerr <= TRAIN_SMOKE_ATOL and same <= TRAIN_SMOKE_ATOL):
            raise AssertionError(f"{arch} smoke: the card's train step "
                                 f"differs from the CPU's")


def _train_flop_bound_ms(cfg, params, tokens, batch, seq) -> float:
    """The least time of one training step at ``BF16_FLOPS``: 6 N T for
    the forward and backward matmuls (N every parameter a token
    multiplies: the layers and the head), 2 N_layers T for the
    recomputed forward of every cycle (remat), and the attention's
    score and value products, S x S per row (the chunked attention
    computes every one; causal masking skips none): 4 B S^2 d per layer
    a forward pass, four passes with the backward and the recompute."""
    from repro_torch.models import lm
    n = lm.param_numel(params) - (0 if cfg.tie_embeddings
                                  else lm.param_numel(params["embed"]))
    n_layers = lm.param_numel(params["layers"])
    attn = 4 * batch * seq * seq * cfg.n_heads * cfg.hd * cfg.n_layers
    flops = 6 * n * tokens + (2 * n_layers * tokens + attn
                              if cfg.remat else 0) + 3 * attn
    return flops / BF16_FLOPS * 1e3


def _train_full(dev, card, tmp):
    """Phase 13b: ``TRAIN_ARCH`` at full width through ``Trainer`` (bf16
    compute, float32 masters, remat): the loss falls; a fresh Trainer
    resumes at the last step with bit-equal parameters; a run stopped at
    ``TRAIN_STOP`` and resumed equals the straight one (rtol 1e-6, atol
    1e-7, the reference's own test's tolerance); 4 microbatches give a
    first loss within 1e-2 of 1."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH)
    kw = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
              lr=TRAIN_LR, warmup=TRAIN_WARMUP, ckpt_every=TRAIN_CKPT_EVERY)
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    straight = Trainer(cfg, TrainConfig(ckpt_dir=os.path.join(tmp, "a"),
                                        **kw), device=dev)
    t = time.perf_counter()
    hist = straight.run()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    if not hist["loss"][-1] < hist["loss"][0]:
        raise AssertionError(f"{TRAIN_ARCH}: the loss did not fall "
                             f"({hist['loss'][0]} -> {hist['loss'][-1]})")
    fresh = Trainer(cfg, TrainConfig(ckpt_dir=os.path.join(tmp, "a"), **kw),
                    device=dev)
    same = fresh.start_step == TRAIN_STEPS and all(
        torch.equal(a, b) for a, b in zip(
            lm.tree_leaves((straight.params, straight.opt_state)),
            lm.tree_leaves((fresh.params, fresh.opt_state))))
    if not same:
        raise AssertionError(f"{TRAIN_ARCH}: a fresh Trainer resumed at "
                             f"step {fresh.start_step} with other state")
    del fresh
    tc_b = TrainConfig(ckpt_dir=os.path.join(tmp, "b"), **kw)
    Trainer(cfg, tc_b, device=dev).run(steps=TRAIN_STOP)
    resumed = Trainer(cfg, tc_b, device=dev)
    if resumed.start_step != TRAIN_STOP:
        raise AssertionError(f"resumed at {resumed.start_step}")
    resumed.run()
    worst = 0.0
    for a, b in zip(lm.tree_leaves(straight.params),
                    lm.tree_leaves(resumed.params)):
        over = (a - b).abs() - (1e-7 + 1e-6 * b.abs())
        worst = max(worst, float(over.max()))
    del resumed
    _free_memory()
    micro = Trainer(cfg, TrainConfig(microbatches=4, **kw),
                    device=dev).run(steps=1)
    step_ms = statistics.median(hist["step_time"][1:]) * 1e3
    tokens = TRAIN_SEQ * TRAIN_BATCH
    bound = _train_flop_bound_ms(cfg, straight.params, tokens, TRAIN_BATCH,
                                 TRAIN_SEQ)
    batch = straight._device_batch(0)
    state = [straight.params, straight.opt_state]

    def one():
        state[0], state[1], _ = straight.step_fn(state[0], state[1], batch)
    one()
    busy, kernels = _profiled(one, f"{TRAIN_ARCH} train: 3 steps", "a step",
                              card)
    print(f"[train] {card} | {TRAIN_ARCH} ({cfg.dtype} compute, float32 "
          f"masters, "
          f"remat {cfg.remat}; {lm.param_numel(straight.params)} "
          f"parameters), Trainer seq {TRAIN_SEQ} x batch {TRAIN_BATCH}, "
          f"lr {TRAIN_LR}, warmup {TRAIN_WARMUP}, {TRAIN_STEPS} steps in "
          f"{wall:.3f} s (checkpoints every {TRAIN_CKPT_EVERY}): loss "
          f"{hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}; step median "
          f"{step_ms:.3f} ms after the first ({hist['step_time'][0] * 1e3:.1f}"
          f" ms), {tokens / step_ms * 1e3:.1f} tokens/s; FLOP bound "
          f"{bound:.4f} ms a step at {BF16_FLOPS:.4g} FLOP/s, the median at "
          f"{bound / step_ms:.4f} of it; peak memory {peak} bytes; a fresh "
          f"Trainer resumed at step {TRAIN_STEPS} bit-equal; stopped at "
          f"{TRAIN_STOP} and resumed: every parameter within rtol 1e-6 / "
          f"atol 1e-7 of the straight run (largest excess {worst:.3e}); "
          f"4 microbatches: first loss {micro['loss'][0]:.6f} against "
          f"{hist['loss'][0]:.6f}")
    if worst > 0:
        raise AssertionError(f"{TRAIN_ARCH}: the resumed run differs from "
                             f"the straight one beyond rtol 1e-6 / atol "
                             f"1e-7 (by {worst})")
    if not abs(micro["loss"][0] - hist["loss"][0]) < 1e-2:
        raise AssertionError("4 microbatches changed the first loss")
    return {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "bound_ms": bound, "peak_bytes": peak, "busy": busy,
            "kernels": kernels, "losses": hist["loss"]}


def _train_encdec(dev, card):
    """Phase 13c: one ``make_train_step`` of ``ENC_ARCH`` at full width
    (bf16 compute, float32 masters and AdamW state, remat), seq
    ``ENC_TRAIN_SEQ`` x batch ``ENC_TRAIN_BATCH`` with frames from
    ``SyntheticLM``: a finite loss, then a second step timed."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, lm
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step
    cfg = get_config(ENC_ARCH)
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)
    n = lm.param_numel(params)
    logits = ENC_TRAIN_BATCH * ENC_TRAIN_SEQ * cfg.vocab
    print(f"[train] {card} | {ENC_ARCH} step, reckoned before the run: "
          f"{n} parameters; float32 masters, gradients, m and v "
          f"{16 * n} bytes; bf16 logits {2 * logits} bytes and their "
          f"float32 upcast {4 * logits}")
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 100))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    data = SyntheticLM(cfg.vocab, ENC_TRAIN_SEQ, ENC_TRAIN_BATCH, seed=0,
                       frames_dim=cfg.d_model)
    ms, losses = [], []
    for i in range(2):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(i).items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {card} | {ENC_ARCH} ({cfg.dtype} compute, float32 "
          f"masters, "
          f"remat {cfg.remat}) make_train_step, seq {ENC_TRAIN_SEQ} x batch "
          f"{ENC_TRAIN_BATCH}, {ENC_TRAIN_SEQ} frames a row: losses "
          f"{losses}, step {ms[0]:.1f} ms then {ms[1]:.1f} ms; peak memory "
          f"{peak} bytes")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{ENC_ARCH}: a non-finite loss {losses}")
    del params, state
    _free_memory()
    return {"step_ms": ms[1], "peak_bytes": peak}


def _lm_train(dev, card):
    """Phase 13: 13a, 13b and 13c."""
    _train_smoke_check(dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        full = _train_full(dev, card, tmp)
    return full, _train_encdec(dev, card)


def _dryrun_cells(card):
    """Phase 14a: ``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_CELLS`` on the single-pod production mesh, a subprocess each
    with a ``fake`` process group of ``DRYRUN_RANKS`` ranks, as
    ``launch.run_all`` runs them; on the host, on meta tensors.  A cell
    that fails fails the run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               DRYRUN_DEVICES=str(DRYRUN_RANKS))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        procs = []
        try:
            for arch, shape in DRYRUN_CELLS:
                path = os.path.join(tmp, f"{arch}.json")
                procs.append((arch, shape, path, time.perf_counter(),
                              subprocess.Popen(
                                  [sys.executable, "-m",
                                   "repro_torch.launch.dryrun", "--arch",
                                   arch, "--shape", shape, "--out", path],
                                  env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)))
            for arch, shape, path, t0, proc in procs:
                so, se = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
                wall = time.perf_counter() - t0
                if proc.returncode or "DRYRUN OK" not in so:
                    raise AssertionError(
                        f"dry-run {arch} x {shape} failed "
                        f"({proc.returncode}):\n{so[-2000:]}{se[-4000:]}")
                with open(path) as f:
                    rec = json.load(f)
                t = rec["terms"]
                print(f"[dryrun] {card} rates | {arch} x {shape} on "
                      f"{rec['mesh']} ({rec['chips']} fake ranks), per "
                      f"device: {rec['flops_per_device']:.6g} FLOPs, "
                      f"{rec['bytes_per_device']:.6g} bytes, "
                      f"{rec['collective_bytes_per_device']:.6g} collective "
                      f"bytes; compute {t['compute_s']:.6g} s, memory "
                      f"{t['memory_s']:.6g} s, collective "
                      f"{t['collective_s']:.6g} s: bound={t['bound']}; "
                      f"trace {rec['trace_s']} s (the process "
                      f"{wall:.1f} s)")
                out[arch] = rec
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _train_sharded(dev, card, base):
    """Phase 14b: 13b's ``Trainer`` run (``TRAIN_ARCH`` at full width, the
    same config, seed and steps) with ``mesh=`` a (1, 1) ``DeviceMesh``
    over a world-size-1 NCCL group and ``rules=Rules(mesh)``: every
    parameter and optimizer leaf a DTensor, each step under the rules.
    The losses equal 13b's unsharded ones within ``SHARDED_LOSS_ATOL``;
    the median step, kernels a step and the device's busy share, against
    13b's, are DTensor's host cost."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.parallel import Rules
    from repro_torch.train import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH)
    kw = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
              lr=TRAIN_LR, warmup=TRAIN_WARMUP, ckpt_every=TRAIN_CKPT_EVERY)
    _free_memory()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as d:
            tr = Trainer(cfg, TrainConfig(ckpt_dir=d, **kw), mesh=mesh,
                         rules=Rules(mesh))
            if not isinstance(tr.params["embed"], DTensor):
                raise AssertionError("the sharded Trainer's parameters are "
                                     "not DTensors")
            t = time.perf_counter()
            hist = tr.run()
            wall = time.perf_counter() - t
        diff = max(abs(a - b) for a, b in zip(hist["loss"], base["losses"]))
        step_ms = statistics.median(hist["step_time"][1:]) * 1e3
        batch = tr._device_batch(0)
        state = [tr.params, tr.opt_state]

        def one():
            with tr._scope():
                state[0], state[1], _ = tr.step_fn(state[0], state[1], batch)
        one()
        busy, kernels = _profiled(one, f"{TRAIN_ARCH} sharded train: 3 "
                                  f"steps", "a step", card)
        print(f"[sharded] {card} | {TRAIN_ARCH} Trainer on a (1, 1) "
              f"DeviceMesh (NCCL, world size 1), rules on: {TRAIN_STEPS} "
              f"steps in {wall:.3f} s, losses {hist['loss'][0]:.6f} -> "
              f"{hist['loss'][-1]:.6f}, largest difference from 13b's "
              f"{diff:.3e}; step median {step_ms:.3f} ms against 13b's "
              f"{base['step_ms']:.3f} ms ({step_ms / base['step_ms']:.3f}x);"
              f" kernels a step {kernels} against {base['kernels']}; device "
              f"busy {busy} of the wall against {base['busy']}")
        if diff > SHARDED_LOSS_ATOL:
            raise AssertionError(f"sharded losses differ from 13b's by "
                                 f"{diff}")
        del tr, state, batch
    finally:
        dist.destroy_process_group()
        _free_memory()
    return {"step_ms": step_ms, "busy": busy, "kernels": kernels}


def _dryrun_train_cell(card, sharded, base):
    """Phase 14c: the dry-run of 14b's cell -- ``TRAIN_ARCH`` at full
    width, seq ``TRAIN_SEQ`` x batch ``TRAIN_BATCH`` on a (1, 1) mesh --
    traced at full depth on a ``fake`` group of one rank: its compute
    term against 14b's measured step and 13b's FLOP bound."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import install_fake_group
    install_fake_group(1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell(TRAIN_ARCH, "train_4k", mesh=mesh,
                              cfg_override=get_config(TRAIN_ARCH),
                              correct_scan_costs=False,
                              batch=(TRAIN_BATCH, TRAIN_SEQ))
    finally:
        dist.destroy_process_group()
    t = rec["terms"]
    c_ms = t["compute_s"] * 1e3
    print(f"[dryrun] {card} rates | 14b's cell ({TRAIN_ARCH}, seq "
          f"{TRAIN_SEQ} x batch {TRAIN_BATCH}, (1, 1) mesh) traced in "
          f"{rec['trace_s']} s: {rec['flops_per_device']:.6g} FLOPs, "
          f"{rec['bytes_per_device']:.6g} bytes; compute {c_ms:.4f} ms, "
          f"memory {t['memory_s'] * 1e3:.4f} ms, collective "
          f"{t['collective_s'] * 1e3:.4f} ms: bound={t['bound']}; the "
          f"compute term is {c_ms / sharded['step_ms']:.5f} of 14b's "
          f"measured {sharded['step_ms']:.3f} ms and "
          f"{c_ms / PERF_TRAIN_BOUND_MS:.4f} of PERF.md §5's "
          f"{PERF_TRAIN_BOUND_MS} ms FLOP bound (this run's 13b bound "
          f"{base['bound_ms']:.4f} ms)")
    if not rec["flops_per_device"] > 0:
        raise AssertionError("14c traced no FLOPs")
    return rec


def _fhp_traced(dev, card, planes):
    """Phase 14d: the FHP cell's recorder on the sharded path of a 2 x 2
    mesh of slots on the card (phase 3's lane 0, depth ``DEPTH``, T =
    ``T_MAIN``, two rounds): its kernel launches equal the wrappers'
    count, its collective-permute bytes and copies the stepper's
    ``EXCHANGE``, its halo bytes a shard a round ``sharded_fhp_traffic``'s
    for that shard; the run is bit-equal to the same run unrecorded."""
    from repro_torch.core import distributed
    from repro_torch.roofline import analysis
    from repro_torch.roofline import trace as rt
    mesh = distributed.make_mesh(*MESH, dev)
    x = planes[0]
    rounds, shards = 2, mesh.size
    run = distributed.make_run(mesh, rounds * DEPTH, depth=DEPTH,
                               p_force=P_FORCE, steps_per_launch=T_MAIN)
    want = run(x, 0)
    distributed.EXCHANGE.clear()
    _reset_counts()
    with rt.TraceRecorder() as rec:
        got = run(x, 0)
    torch.cuda.synchronize()
    launches, modes = _counts()
    kernels = [r for r in rec.ops if r.name.startswith("fhp_step")]
    cb = rt.collective_bytes(rec)["collective-permute"]
    hl, wdl = HEIGHT // MESH[0][0], WIDTH // 32 // MESH[0][1]
    model = analysis.sharded_fhp_traffic(hl, wdl, depth=DEPTH, T=T_MAIN,
                                         block_rows=T_MAIN)
    per = cb["operand_bytes"] / (shards * rounds)
    print(f"[dryrun] {card} | 14d: {rounds} rounds of the 2 x 2 sharded "
          f"path on the card under the recorder: {len(kernels)} kernel "
          f"ops recorded, {launches} launched ({modes}); "
          f"{cb['count']} ring copies of {cb['operand_bytes']:.0f} bytes "
          f"recorded, the stepper counted {distributed.EXCHANGE['copies']}"
          f" of {distributed.EXCHANGE['bytes']}; {per:.0f} halo bytes a "
          f"shard a round against sharded_fhp_traffic's "
          f"{model['ici_bytes_per_exchange']:.0f}; bit-equal to the "
          f"unrecorded run: {torch.equal(got, want)}")
    if not (launches > 0 and len(kernels) == launches):
        raise AssertionError(f"recorded {len(kernels)} kernel ops, "
                             f"launched {launches}")
    if (cb["operand_bytes"] != distributed.EXCHANGE["bytes"]
            or cb["count"] != distributed.EXCHANGE["copies"]):
        raise AssertionError("the recorder's exchange differs from the "
                             "stepper's count")
    if per != model["ici_bytes_per_exchange"]:
        raise AssertionError(f"halo bytes {per} a shard a round, modeled "
                             f"{model['ici_bytes_per_exchange']}")
    if not torch.equal(got, want):
        raise AssertionError("the recorded run differs from the unrecorded")
    return launches


def _sharded_train(dev, card, base, planes):
    """Phase 14: 14a-d."""
    _dryrun_cells(card)
    sharded = _train_sharded(dev, card, base)
    _dryrun_train_cell(card, sharded, base)
    _fhp_traced(dev, card, planes)


def _free_memory():
    """Drop unreferenced tensors and return cached device memory."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for T in (T_MAIN, 1):
        print(_stream_line(card, T, ops.pick_stream(HEIGHT, WIDTH // 32, T,
                                                    8, LANES), None, sms))
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
    # The streamed kernel of the main launch: its wave loop (one barrier)
    # holds J words a thread in each of three parity paths (rows of either
    # parity with compile-time shifts, and the general one).
    j = ops.stream_geometry(WIDTH // 32, T_MAIN, 8, ops.pick_stream(
        HEIGHT, WIDTH // 32, T_MAIN, 8, LANES))["per_warp"]
    waves = [b for b in opcount.loop_bodies(
        sass, f"fhp_step_stream_kernelI9Rule_fhp2Li{j}E")
        if b["barriers"] == 1]
    if waves:
        b = waves[0]
        print(f"[sass] fhp2 streamed kernel (J={j}), wave loop (1 barrier, "
              f"{j} word-steps a thread a wave, 3 parity paths): "
              f"{b['total']} instructions, {b['total'] / (3 * j):.1f} per "
              f"word-step of one path against the probe's "
              f"{sum(step.values()):.1f}; per pipe "
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
    if main_modes.get("streamed") != launches:
        raise AssertionError(f"main path streamed {main_modes} launches")
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
    wd = WIDTH // 32
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
    # The periodic launches above run on the row-streaming kernel; the same
    # launches on the tile kernel, held bit-equal to them, for the record.
    tile_ms = {}
    for label, T, rec in (("T=1", 1, ()),
                          (f"T={T_MAIN}", T_MAIN, (T_MAIN - 1,))):
        bh, bw = ops.pick_tile(HEIGHT, wd, T)
        fn = functools.partial(_tile_launch, planes, T, bh, bw, rec)
        _held(f"{label} tile launch", fn(), ops.fhp_step_cuda(
            planes, 0, p_force=P_FORCE, steps_per_launch=T,
            record_steps=rec))
        tile_ms[label] = _time_ms(fn, reps=20)
        print(f"[time] {card} | {label} on tiles {bh} x {bw} "
              f"(fhp_step_kernel): {tile_ms[label]:.4f} ms/launch against "
              f"{results[label][0]:.4f} streamed")

    # Streamed launches at T = 8 over strip counts, each held bit-equal to
    # the launch above, with the geometry the card gives each; then tile
    # shapes at T = 8 (rows x words) on the tile kernel, likewise.
    kw = dict(p_force=P_FORCE, steps_per_launch=T_MAIN)
    want = ops.fhp_step_cuda(planes, 0, **kw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream_ms = {}
    for ns in STRIPS:
        bw = -(-wd // ns)
        if bw > ops.stream_max_owned(T_MAIN):
            continue
        skw = dict(kw, block_words=bw)
        where = check.first_difference(ops.fhp_step_cuda(planes, 0, **skw),
                                       want)
        if where is not None:
            raise AssertionError(f"{ns} strips differ first at {where}")
        stream_ms[bw] = _time_ms(lambda: ops.fhp_step_cuda(planes, 0, **skw),
                                 reps=10)
        print(_stream_line(card, T_MAIN, bw, stream_ms[bw], sms))
    swept = {}      # (bh, bw, T) -> ms a tile launch, for the model's ratios
    for bh, bw in TILES:
        fn = functools.partial(_tile_launch, planes, T_MAIN, bh, bw)
        where = check.first_difference(fn(), want)
        if where is not None:
            raise AssertionError(f"tile {(bh, bw)} differs first at {where}")
        t_ms = _time_ms(fn, reps=10)
        swept[bh, bw, T_MAIN] = t_ms
        occ = ops.kernel_info("fhp2", "periodic", False, bh, bw, T_MAIN)
        print(f"[tile] {card} | T={T_MAIN} tile {bh} x {bw}: {t_ms:.4f} "
              f"ms/launch, apron {_apron(bh, bw, T_MAIN):.3f}x, lanes "
              f"{_lanes(bh, bw, T_MAIN):.3f}x, {occ['blocks_per_sm']} "
              f"blocks/SM, {occ['smem_bytes']} B shared")
    del want
    # The widest one-row band the tile kernel took before the row-mapped
    # redesign, 1208 words at T = 1: it runs as tiles of the widest width
    # a block covers, bit-equal to the streamed launch (held against the
    # plain version above).
    kw1 = dict(p_force=P_FORCE, steps_per_launch=1)
    where = check.first_difference(_tile_launch(planes, 1, 1, 1208),
                                   ops.fhp_step_cuda(planes, 0, **kw1))
    if where is not None:
        raise AssertionError(f"tile (1, 1208) at T=1 differs first at {where}")
    print(f"[tile] T=1 tile 1 x 1208 (run as 1 x "
          f"{ops.MAX_TILE_WORDS - 2} tiles): bit-equal to the streamed launch")
    # The per-step time at T in {1, 2, 4, 8}: streamed (pick_stream's
    # strips) and on tiles (pick_tile's), held bit-equal to each other.
    for T in (1, 2, 4, 8):
        tkw = dict(p_force=P_FORCE, steps_per_launch=T)
        bh, bw = ops.pick_tile(HEIGHT, wd, T)
        fn = functools.partial(_tile_launch, planes, T, bh, bw)
        where = check.first_difference(fn(), ops.fhp_step_cuda(planes, 0,
                                                               **tkw))
        if where is not None:
            raise AssertionError(f"T={T}: tiles and strips differ first at "
                                 f"{where}")
        s_ms = _time_ms(lambda: ops.fhp_step_cuda(planes, 0, **tkw), reps=10)
        t_ms = _time_ms(fn, reps=10)
        swept[bh, bw, T] = t_ms
        sbw = ops.pick_stream(HEIGHT, wd, T, 8, LANES)
        strips = ops.stream_geometry(wd, T, 8, sbw)["strips"]
        print(f"[steps] {card} | T={T}: streamed ({strips} strips) "
              f"{s_ms:.4f} ms/launch, {s_ms / T:.4f} ms per step; tile "
              f"{(bh, bw)} {t_ms:.4f} ms/launch, {t_ms / T:.4f} ms per step")
        print(_stream_line(card, T, sbw, s_ms, sms))
    # The main tile at each T: launch time against the thread word-steps
    # it issues, fitted as a + b x word-steps; a is what a launch costs
    # besides its steps (apron loads, stores, launch).  The same for the
    # streamed launch at pick_stream's strips.
    bh, bw = ops.pick_tile(HEIGHT, wd, T_MAIN)
    fits = {}
    for name, time_at, steps_at in (
            ("tile", lambda T: _time_ms(functools.partial(
                _tile_launch, planes, T, bh, bw), reps=10),
             lambda T: _lanes(bh, bw, T)),
            ("streamed", lambda T: _time_ms(lambda: ops.fhp_step_cuda(
                planes, 0, p_force=P_FORCE, steps_per_launch=T), reps=10),
             lambda T: ops.stream_thread_steps(
                 HEIGHT, wd, T, 8, LANES, ops.pick_stream(HEIGHT, wd, T, 8,
                                                          LANES)))):
        xs, ys = [], []
        for T in (1, 2, 4, 8):
            ys.append(time_at(T))
            xs.append(steps_at(T) * planes[:, 0].numel() * T)
        n = len(xs)
        mx, my = sum(xs) / n, sum(ys) / n
        b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
        a = my - b * mx
        fits[name] = b
        where = f"tile {bh} x {bw}" if name == "tile" else "pick_stream's strips"
        print(f"[split] {card} | {name}, {where} at T=1, 2, 4, 8: "
              f"{', '.join(f'{y:.4f}' for y in ys)} ms/launch; fit {a:.4f} ms "
              f"a launch + {b * 1e9:.4f} ms per 1e9 thread word-steps; at "
              f"T={T_MAIN} the steps take {1 - a / ys[-1]:.4f} of the launch")
    # The cost model's compute weight (it prices tiles), re-derived from
    # the tile fit: one thread word-step against moving one 8-plane word
    # cell (32 B) at the card's datasheet memory rate.
    b = fits["tile"]
    print(f"[model] {card} | one tile thread word-step {b * 1e6:.4f} ns "
          f"against {32 / HBM_BYTES_PER_S * 1e9:.4f} ns to move a 32-byte "
          f"word cell: compute row weight "
          f"{b * 1e-3 / (32 / HBM_BYTES_PER_S):.4f} (ops.COMPUTE_ROW_WEIGHT "
          f"= {ops.COMPUTE_ROW_WEIGHT}); a streamed thread word-step "
          f"{fits['streamed'] * 1e6:.4f} ns")
    _single_device_pick(planes, card, swept, ms.n_moments, counted)

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
    # -- 9-10. this slice: Poiseuille through the kernel, the LM serve path --
    pois_modes = _poiseuille(dev, card)
    _lm_smoke_check(dev, card)
    _lm_full_width(dev, card)
    # -- 11. the experts/MLA and SSM/hybrid families ------------------------
    from repro_torch.kernels.mla_decode import ops as mla_ops
    mla_ops.LAUNCHES.clear()
    _lm_families(dev, card)
    mla_entry = _mla_decode_core(dev, card, mla_ops.LAUNCHES.copy())
    # -- 12-13. this slice: the encoder-decoder, then training --------------
    _lm_encdec(dev, card)
    train_full, _ = _lm_train(dev, card)
    # -- 14. this slice: the dry-run and sharded training -------------------
    _sharded_train(dev, card, train_full, planes)

    entries = [
        _entry("fhp_step K1 periodic", "periodic", main_modes["periodic"],
               results["T=1"], card,
               launches_serve=serve_modes["periodic"],
               launches_poiseuille=pois_modes["periodic"],
               launches_streamed=main_modes.get("streamed", 0),
               tile_ms=tile_ms["T=1"]),
        _entry("fhp_step K3 2-D tiles", "tiles", main_modes["periodic"],
               results[f"T={T_MAIN}"], card,
               launches_serve=serve_modes["periodic"],
               launches_poiseuille=pois_modes["periodic"],
               launches_streamed=main_modes.get("streamed", 0),
               tile_ms=tile_ms[f"T={T_MAIN}"]),
        _entry("fhp_step K4 fused moments", "moments", main_modes["moments"],
               results[f"T={T_MAIN}"], card,
               launches_serve=serve_modes["moments"],
               tile_ms=tile_ms[f"T={T_MAIN}"]),
        _entry("fhp_step K6 static solid, periodic", "static_solid",
               twin_modes["static_solid"],
               results[f"T={T_MAIN} static-solid"], card),
    ] + sharded + [mla_entry]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
