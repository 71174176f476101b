"""Card-only tests of the port's CUDA kernel and LM path (marker ``gpu``).

    python -m pytest -q -m gpu tests/test_torch_gpu.py    # on the card

The parity sweeps of ``chip_smoke.py`` at a small lattice -- periodic
(the row-streaming kernel), extended-shard and precomputed-RNG mode --
the kernel against its plain version on the card, bit for bit, and the
streamed launches at the main path's and the serve engine's shapes; the single-device and sharded entry
points against their plain runs on the CPU; the smoke LMs of every
decoder-only family through ``ServeEngine`` on the card against the CPU,
the encoder-decoder's prefill and decode, and one training step's loss
and gradients.  Whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests; without a card they skip.
"""
import pytest
import torch

from repro_torch.core import distributed, prng, rulespec
from repro_torch.kernels.fhp_step import check, opcount, ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("case", check.CASES, ids=str)
def test_kernel_matches_plain_version(cuda, case):
    bad = check.run_case(case, cuda, h=70, wd=31)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("case", check.CASES, ids=str)
def test_extended_kernel_matches_plain_version(cuda, case):
    bad = check.run_extended_case(case, cuda, h=70, wd=31)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("case", check.K2_CASES, ids=str)
def test_precomputed_rng_kernel_matches_plain_version(cuda, case):
    bad = check.run_k2_case(case, cuda, h=70, wd=31)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("case", [c for c in check.CASES if c.lanes == 3],
                         ids=str)
def test_kernel_matches_plain_version_16_byte_rows(cuda, case):
    # Wd % 4 == 0: the tiles' apron loads and stores take 16-byte chunks.
    for run_case in (check.run_case, check.run_extended_case):
        bad = run_case(case, cuda, h=70, wd=32)
        assert not bad, "\n".join(bad)


@pytest.mark.parametrize("overlap,static", [(False, False), (True, False),
                                            (True, True)])
def test_sharded_path_counts_launches(cuda, overlap, static):
    # A 2 x 2 mesh of four slots on the one card against the same mesh of
    # CPU slots (the plain version) and the single-device plain run.
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 8, 64, 40),
                          dtype=torch.int32)
    words[:, 7] = words[0, 7]
    kw = dict(depth=4, steps_per_launch=4, p_force=0.05, variant="fhp3",
              overlap=overlap, static_solid=static, batched=True,
              moments_every=2)
    run = distributed.make_run(
        distributed.make_mesh((2, 2), ("data", "model"), cuda), 8, **kw)
    ops.LAUNCHES.clear()
    out, mom = run(words.to(cuda), 3)
    assert ops.launches_total() == 2 * 4 * (5 if overlap else 1)
    want, wmom = distributed.make_run(
        distributed.make_mesh((2, 2), ("data", "model"), "cpu"), 8,
        **kw)(words, 3)
    assert torch.equal(out.cpu(), want) and torch.equal(mom.cpu(), wmom)
    single_run, _ = distributed.make_ensemble_run(
        None, 8, variant="fhp3", p_force=0.05, steps_per_launch=4,
        moments_every=2)
    single, smom = single_run(words, 3)
    assert torch.equal(want, single)
    assert torch.equal(wmom, smom[..., [r for r, n in enumerate(
        rulespec.moment_spec(rulespec.get_rule("fhp3")).names)
        if n != "solid" or not static]])


@pytest.mark.parametrize("variant", ["fhp2", "fhp3", "bml"])
@pytest.mark.parametrize("lattice,T,steps", [((4, 4096, 1024), 8, 16),
                                             ((4, 1024, 128), 2, 8)],
                         ids=["main", "serve"])
def test_streamed_kernel_at_main_and_serve_shapes(cuda, variant, lattice, T,
                                                  steps):
    # The main path's launches (4 x 4096 x 1024 words, T = 8, moments every
    # 8) and the serve engine's (1,024 x 4,096 nodes, T = 2) on the
    # row-streaming kernel: planes and fused moments equal to the plain
    # version's, every periodic launch counted as streamed.
    b, h, wd = lattice
    p_force = 0.0 if variant == "bml" else 0.03
    planes = check._random_planes(check.Case(variant, T, b, p_force), h, wd,
                                  seed=T, device=cuda)
    kw = dict(p_force=p_force, variant=variant, y0=check.Y0, xw0=check.XW0)
    ops.LAUNCHES.clear()
    got, gm = ops.run_cuda(planes, steps, t0=check.T0, steps_per_launch=T,
                           moments_every=T, **kw)
    assert (ops.LAUNCHES["streamed"] == ops.LAUNCHES["periodic"]
            == ops.launches_total() == steps // T)
    want, wm = check._run_plain(planes, steps, T, **kw)
    assert torch.equal(got, want) and torch.equal(gm, wm)


def test_main_path_counts_launches(cuda):
    words = torch.randint(0, 2 ** 31 - 1, (2, 8, 64, 40), dtype=torch.int32)
    planes = words.to(cuda)
    run, sharding = distributed.make_ensemble_run(
        None, 19, variant="fhp3", p_force=0.05, steps_per_launch=4,
        moments_every=4)
    assert sharding is None
    ops.LAUNCHES.clear()
    out, mom = run(planes, 3)
    assert ops.launches_total() == 5          # 4 launches of 4 steps + 1 of 3
    want, wmom = run(words, 3)        # plain version on the CPU
    assert torch.equal(out.cpu(), want)
    assert torch.equal(mom.cpu(), wmom)
    assert mom.shape == (2, 4, rulespec.moment_spec(
        rulespec.get_rule("fhp3")).n_moments)



def test_sharded_path_on_distinct_cards(cuda):
    # The same 2 x 2 mesh with one card per slot: halo slices cross
    # between cards; the result equals four slots on one card.
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 8, 256, 64),
                          dtype=torch.int32)
    kw = dict(depth=8, steps_per_launch=8, p_force=0.05, overlap=True,
              moments_every=4)
    cards = [torch.device("cuda", i) for i in range(4)]
    run, sharding = distributed.make_ensemble_run(
        distributed.make_mesh((2, 2), ("data", "model"), cards), 16, **kw)
    assert {d.index for row in sharding.devices for d in row} == {0, 1, 2, 3}
    ops.LAUNCHES.clear()
    out, mom = run(words.to(cuda), 3)
    assert ops.launches_total() == 2 * 4 * 5
    one, _ = distributed.make_ensemble_run(
        distributed.make_mesh((2, 2), ("data", "model"), cuda), 16, **kw)
    want, wmom = one(words.to(cuda), 3)
    assert torch.equal(out, want) and torch.equal(mom, wmom)


def test_compiled_word_step_is_counted(cuda):
    # The probes compile to straight-line code (counts raises otherwise).
    c = opcount.counts(prng.quantize_p(0.03))
    assert c["step"]["alu"] > 50 and c["step"]["fma"] > 0
    assert c["terms"]["popc"] == len(rulespec.moment_spec(
        rulespec.get_rule("fhp2")).terms)


@pytest.mark.parametrize("mesh", [False, True], ids=["single", "mesh"])
def test_serve_engine_on_card_matches_cpu(cuda, mesh, tmp_path):
    # The serve engine with its lanes on the card (single device, or a
    # 2 x 2 mesh of slots on it) against the same engine on the CPU, a
    # bitflip rolled back in both: equal results, frames and detections.
    from repro_torch.serve import CAServeEngine, Fault, FaultInjector, SimJob

    def serve(device, d):
        kw = {}
        if mesh:
            kw["mesh"] = distributed.make_mesh((2, 2), ("data", "model"),
                                               device)
        eng = CAServeEngine(
            height=64, width=512, slots=2, depth=4, steps_per_launch=4,
            device=device, ckpt_dir=str(tmp_path / d), ckpt_every=1,
            injector=FaultInjector([Fault(kind="bitflip", round=2,
                                          rule="fhp3", bits=3, seed=1)]),
            **kw)
        for rid in range(3):
            sc, ov = (("bml_city", {}) if rid == 1
                      else ("cylinder", {"variant": "fhp3"}))
            eng.submit(SimJob(rid=rid, scenario=sc, steps=16, frame_every=8,
                              overrides=dict(ov, seed=rid)))
        ops.LAUNCHES.clear()
        eng.drain()
        return eng, ops.launches_total()

    card, launches = serve(cuda, "card")
    host, _ = serve(torch.device("cpu"), "cpu")
    assert launches > 0 and card.detections == host.detections != []
    for rid, job in host.jobs.items():
        assert (card.jobs[rid].result == job.result).all(), rid
        assert card.jobs[rid].frames == job.frames, rid


def test_overlapped_runs_repeat_on_card(cuda):
    # One placed state on a 2 x 2 mesh of slots on the card: the serial
    # run (1 launch a shard a round) and three overlapped runs in a row (5,
    # the interior ones on a side stream) give equal planes and moments.
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 8, 256, 64),
                          dtype=torch.int32)
    mesh = distributed.make_mesh((2, 2), ("data", "model"), cuda)
    kw = dict(depth=8, steps_per_launch=8, p_force=0.05, moments_every=4)
    serial, sharding = distributed.make_ensemble_run(mesh, 32, **kw)
    overlapped, _ = distributed.make_ensemble_run(mesh, 32, overlap=True,
                                                  **kw)
    placed = sharding.place(words.to(cuda))
    ops.LAUNCHES.clear()
    want, wmom = serial(placed, 3)
    assert ops.LAUNCHES["extended"] == 4 * 4
    for _ in range(3):
        ops.LAUNCHES.clear()
        got, mom = overlapped(placed, 3)
        assert ops.LAUNCHES["extended"] == 4 * 4 * 5
        assert torch.equal(got.gather(), want.gather())
        assert torch.equal(mom, wmom)


def test_exchange_latency_probe_on_cards(cuda):
    # With two or more cards the probe times the ring and caches it under
    # the fingerprint; one card has no link to time.
    from repro_torch.roofline import analysis
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    analysis._MEASURED_EXCHANGE_LATENCY.clear()
    lat = analysis.measured_exchange_latency()
    key = analysis._mesh_fingerprint()
    assert key[:2] == ("cuda", torch.cuda.device_count())
    assert analysis._MEASURED_EXCHANGE_LATENCY[key] == lat
    assert 1e-8 <= lat < 1e-2
    assert analysis.measured_exchange_latency() == lat


def test_poiseuille_kernel_matches_run_planes_on_card(cuda):
    # The Poiseuille example's run through the kernel against the port's
    # run_planes on the card: planes after the warm phase and at the end,
    # and the profile, equal.
    from repro_torch import scenarios
    from repro_torch.examples import poiseuille
    sc = scenarios.get("poiseuille", height=32, width=256, p_force=0.05)
    ops.LAUNCHES.clear()
    warm, end, prof = poiseuille.simulate(sc, 400, cuda)
    assert ops.LAUNCHES["periodic"] == ops.launches_total() > 0
    pwarm, pend, pprof = poiseuille.simulate(sc, 400, cuda, plain=True)
    assert torch.equal(warm, pwarm) and torch.equal(end, pend)
    assert (prof == pprof).all()


@pytest.mark.parametrize("arch", ["repro-100m", "gemma2-27b",
                                  "deepseek-v3-671b", "llama4-scout-17b-a16e",
                                  "mamba2-2.7b", "zamba2-2.7b"])
def test_smoke_lm_on_card_matches_cpu(cuda, arch):
    # The same seeded float32 smoke model on the card and on the CPU, the
    # same requests through ServeEngine: equal greedy tokens; prefill and
    # decode logits within 1e-3 at "highest" matmul precision (no TF32).
    # MoE/MLA (deepseek, llama4), SSM (mamba2) and hybrid (zamba2) too.
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.models import decode_step, init_params, lm, prefill
    from repro_torch.serve import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = get_smoke(arch)
    host = init_params(cfg, seed=0, device="cpu")
    card = lm.tree_map(lambda t: t.to(cuda), host)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 24, 6)]
    outs = []
    for params, device in ((card, cuda), (host, torch.device("cpu"))):
        eng = ServeEngine(params, cfg, batch_size=4, max_len=64,
                          device=device)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=8))
        outs.append({r.rid: r.out for r in eng.run_until_done()})
    assert len(outs[0]) == 6 and outs[0] == outs[1]
    toks = torch.as_tensor(np.stack([prompts[0][:4], prompts[1][:4]]))
    (cl, cc), (hl, hc) = (prefill(p, cfg, {"tokens": toks.to(d)}, 16,
                                  torch.float32)
                          for p, d in ((card, cuda), (host, "cpu")))
    assert (cl.cpu() - hl).abs().max() <= 1e-3
    pos, tok = torch.tensor([4, 2]), torch.tensor([1, 2])
    for _ in range(3):
        cl, _ = decode_step(card, cfg, cc, tok.to(cuda), pos.to(cuda))
        hl, _ = decode_step(host, cfg, hc, tok, pos)
        assert (cl.cpu() - hl).abs().max() <= 1e-3
        tok, pos = hl.argmax(-1), pos + 1


def test_encdec_smoke_prefill_and_decode_on_card_match_cpu(cuda):
    # seamless-m4t-medium's smoke config, the same seeded float32
    # parameters, tokens and frames on the card and the CPU: prefill's
    # logits and cross cache, then three per-row decode steps, within
    # 1e-3 at "highest" matmul precision.
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.models import decode_step, init_params, lm, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = get_smoke("seamless-m4t-medium")
    host = init_params(cfg, seed=0, device="cpu")
    card = lm.tree_map(lambda t: t.to(cuda), host)
    b = SyntheticLM(cfg.vocab, 24, 2, seed=7,
                    frames_dim=cfg.d_model).batch_at(0)
    batch = {"tokens": torch.from_numpy(b["tokens"][:, :9]),
             "frames": torch.from_numpy(b["frames"])}
    (cl, cc), (hl, hc) = (
        prefill(p, cfg, {k: v.to(d) for k, v in batch.items()}, 32,
                torch.float32)
        for p, d in ((card, cuda), (host, torch.device("cpu"))))
    assert (cl.cpu() - hl).abs().max() <= 1e-3
    assert (cc["cross"]["k"].cpu() - hc["cross"]["k"]).abs().max() <= 1e-3
    cross = cc["cross"]["v"].clone()
    pos, tok = torch.tensor([9, 6]), hl.argmax(-1)
    for _ in range(3):
        cl, _ = decode_step(card, cfg, cc, tok.to(cuda), pos.to(cuda))
        hl, _ = decode_step(host, cfg, hc, tok, pos)
        assert (cl.cpu() - hl).abs().max() <= 1e-3
        tok, pos = hl.argmax(-1), pos + 1
    assert torch.equal(cc["cross"]["v"], cross)         # only read


@pytest.mark.parametrize("arch", ["repro-100m", "deepseek-v3-671b",
                                  "seamless-m4t-medium", "zamba2-2.7b"])
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    # One make_train_step from the same seeded float32 parameters and
    # batch on the card and the CPU: the loss and every gradient leaf
    # (each within 1e-4 of its largest magnitude), at "highest" matmul
    # precision; experts at the no-drop capacity factor.
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, lm, loss_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = get_smoke(arch)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    s = cfg.ssm.chunk if cfg.ssm else 32
    host = init_params(cfg, seed=0, device="cpu")
    batch = SyntheticLM(cfg.vocab, s, 4, seed=3,
                        frames_dim=cfg.d_model if cfg.enc_layers else 0
                        ).batch_at(0)
    out = []
    for d in (cuda, torch.device("cpu")):
        live = lm.tree_map(lambda t: t.to(d).requires_grad_(True), host)
        loss, _ = loss_fn(live, cfg, {k: torch.from_numpy(v).to(d)
                                      for k, v in batch.items()})
        loss.backward()
        out.append((float(loss.detach()), [t.grad.cpu() if t.grad is not None
                                  else torch.zeros_like(t.cpu())
                                  for t in lm.tree_leaves(live)]))
    (gl, gg), (hl, hg) = out
    assert abs(gl - hl) <= 1e-4 * max(abs(hl), 1.0)
    for a, b in zip(gg, hg):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_sharded_trainer_on_a_one_card_mesh_matches_unsharded(cuda):
    # chip_smoke.py phase 14b at the smoke config: a (1, 1) DeviceMesh
    # over a world-size-1 NCCL group, rules on, against the one-device
    # Trainer on the card.
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke
    from repro_torch.parallel import Rules
    from repro_torch.train import TrainConfig, Trainer
    cfg = get_smoke("repro-100m")
    tc = TrainConfig(seq_len=64, global_batch=4, steps=4, lr=1e-3, warmup=2,
                     log_every=100)
    want = Trainer(cfg, tc, device=cuda).run()["loss"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        tr = Trainer(cfg, tc, mesh=mesh, rules=Rules(mesh))
        assert isinstance(tr.params["embed"], DTensor)
        got = tr.run()["loss"]
    finally:
        dist.destroy_process_group()
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-5


def test_fhp_recorder_on_the_card_matches_the_steppers_counts(cuda):
    # chip_smoke.py phase 14d at a small lattice: the recorder on the
    # 2 x 2 sharded path on the card.
    from repro_torch.roofline import analysis
    from repro_torch.roofline import trace as rt
    spec = rulespec.get_rule("fhp2")
    x = torch.from_numpy(spec.init_bytes(64, 1024, 0.3, 5))
    from repro_torch.core import bitplane
    planes = bitplane.pack(x.to(cuda), n_planes=spec.n_planes)
    mesh = distributed.make_mesh((2, 2), ("data", "model"), cuda)
    run = distributed.make_run(mesh, 8, depth=4, p_force=0.03,
                               steps_per_launch=4)
    want = run(planes, 0)
    distributed.EXCHANGE.clear()
    ops.LAUNCHES.clear()
    with rt.TraceRecorder() as rec:
        got = run(planes, 0)
    launched = ops.launches_total()
    kernels = [r for r in rec.ops if r.name.startswith("fhp_step")]
    cb = rt.collective_bytes(rec)["collective-permute"]
    assert launched == len(kernels) == 4 * 2
    assert cb["operand_bytes"] == distributed.EXCHANGE["bytes"]
    hl, wdl = planes.shape[-2] // 2, planes.shape[-1] // 2
    assert cb["operand_bytes"] / (4 * 2) == analysis.sharded_fhp_traffic(
        hl, wdl, depth=4, T=4, block_rows=4)["ici_bytes_per_exchange"]
    assert torch.equal(got, want)


# -- MLA decode's attention core (kernels/mla_decode) -----------------------

def _mla_within(r):
    # bf16: the kernel and the plain core each round every probability to
    # bf16 (2^-9 relative) and the context once (2^-9); the kernel rounds
    # probabilities before normalising, the plain core after, and the two
    # sum in other orders.  So a (row, head) context vector of the kernel
    # lies within 2^-6 (relative L2) of the plain core's, and the kernel is
    # no farther from the float64 value of the same operands than the
    # plain core, give or take a quarter of its error and 2^-10.
    assert r["finite"]
    assert r["kernel_vs_plain_max"] <= 2 ** -6, r
    assert r["kernel_err"] <= 1.25 * r["plain_err"] + 2 ** -10, r


def _mla_case(cuda, arch, rows, t, seed, smoke=False, **kw):
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels.mla_decode import check as mcheck
    from repro_torch.kernels.mla_decode import ops as mops
    from repro_torch.models import attention
    cfg = (get_smoke if smoke else get_config)(arch)
    m = cfg.mla
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, chunk = mops.plan(rows, cfg.n_heads, t, n_sm)
    pos = mcheck.boundary_positions(t, chunk)[:rows]
    pos += mcheck.chat_positions(rows - len(pos), t, seed)
    return splits, mcheck.case(rows, cfg.n_heads, m.kv_lora, m.rope_dim, t,
                               pos, scale=attention.mla_scale(cfg),
                               device=cuda, seed=seed, **kw)


@pytest.mark.parametrize("rows", [256, 16, 4],
                         ids=["256 rows", "16 rows", "4 rows"])
def test_mla_kernel_at_the_cells_widths(cuda, rows):
    # DeepSeek-V3's published widths (128 heads, 512 + 64, the YaRN
    # scale) over a 2,560-long cache at plan's split (one split at 256
    # rows, several at 16 and 4): positions 0, each split edge - 2, - 1,
    # + 0, + 1, 2,559 and the rest drawn as the chat mix leaves them.
    from repro_torch.kernels.mla_decode import check as mcheck
    from repro_torch.kernels.mla_decode import ops as mops
    splits, k = _mla_case(cuda, "deepseek-v3", rows, 2560, seed=11)
    assert (splits == 1) == (rows == 256)
    mops.LAUNCHES.clear()
    _mla_within(mcheck.compare(k))
    assert mops.LAUNCHES["split"] == 1
    assert mops.LAUNCHES["merge"] == int(splits > 1)


@pytest.mark.parametrize("arch", ["deepseek-v3", "deepseek-v3-671b"])
@pytest.mark.parametrize("t", [96, 1024])
def test_mla_kernel_at_smoke_widths(cuda, arch, t):
    # The smoke twins' 4-8 heads, 16-32 + 8-16 widths, padded by masking;
    # 1,024 positions over 6 rows take several splits.
    from repro_torch.kernels.mla_decode import check as mcheck
    from repro_torch.kernels.mla_decode import ops as mops
    splits, k = _mla_case(cuda, arch, 6, t, seed=5, smoke=True)
    assert (splits > 1) == (t == 1024)
    mops.LAUNCHES.clear()
    _mla_within(mcheck.compare(k))
    assert mops.LAUNCHES["merge"] == int(splits > 1)


@pytest.mark.parametrize("dtype,cache_dtype,strided", [
    (torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.float32, False),
    (torch.float16, torch.float16, False),
    (torch.float16, torch.bfloat16, False)], ids=str)
def test_mla_kernel_takes_strided_and_other_caches(cuda, dtype, cache_dtype,
                                                   strided):
    # c and kr as views of one buffer; a float32 or bf16 cache rounded to
    # the queries' type as it loads (as the plain core's c.to(x.dtype));
    # fp16 throughout.
    from repro_torch.kernels.mla_decode import check as mcheck
    _, k = _mla_case(cuda, "deepseek-v3", 8, 640, seed=3, dtype=dtype,
                     cache_dtype=cache_dtype, strided=strided)
    _mla_within(mcheck.compare(k))


def test_mla_decode_in_bf16_takes_the_kernel_on_card(cuda, monkeypatch):
    # A whole bf16 mla_decode at the smoke twin's widths through the kernel
    # (launches and the rows counter), against the same call with the
    # plain core; the cache written in place either way.
    from repro_torch import telemetry
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.mla_decode import ops as mops
    from repro_torch.models import attention, common as cm
    cfg = get_smoke("deepseek-v3")
    p = {k: v.to(torch.bfloat16) for k, v in attention.init_mla(
        cm.Init(0, device=cuda), cfg).items()}
    m, rows, t = cfg.mla, 5, 48
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((rows, 1, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    cache0 = {"c": torch.randn((rows, t, m.kv_lora), generator=g,
                               device=cuda).to(torch.bfloat16),
              "kr": torch.randn((rows, t, m.rope_dim), generator=g,
                                device=cuda).to(torch.bfloat16)}
    pos = torch.tensor([0, 7, 20, 46, 47], device=cuda)
    tel = telemetry.default()
    was = tel.enabled
    tel.enabled = True
    before = tel.summary()["counters"].get("mla.decode_kernel_rows", 0)
    mops.LAUNCHES.clear()
    try:
        kc = {k: v.clone() for k, v in cache0.items()}
        got, _ = attention.mla_decode(p, x, cfg, kc, pos)
        after = tel.summary()["counters"].get("mla.decode_kernel_rows", 0)
    finally:
        tel.enabled = was
    assert mops.LAUNCHES["split"] == 1 and after - before == rows
    monkeypatch.setattr(attention, "_on_kernel", lambda *a: False)
    pc = {k: v.clone() for k, v in cache0.items()}
    want, _ = attention.mla_decode(p, x, cfg, pc, pos)
    assert mops.LAUNCHES["split"] == 1
    assert all(torch.equal(kc[k], pc[k]) for k in kc)
    rel = (got.float() - want.float()).norm() / want.float().norm()
    assert float(rel) <= 2 ** -6
