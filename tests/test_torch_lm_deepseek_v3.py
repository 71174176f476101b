"""DeepSeek-V3 as published (``deepseek-v3``) on the CPU: its gate against a
hand-worked example, the dropless expert share against a per-token loop,
the 32 shares of a layer adding up to the uncut layer of the plain
reference (``cabench/reference/lm_mla_moe.py``), YaRN's frequencies and
softmax scale against the formula, and ``ServeEngine``'s prefill and
decode at the smoke twin's widths against the reference.  The twin of the
JAX package's configuration, ``deepseek-v3-671b``, is held by
``test_torch_lm_moe.py``.  Float32; tolerance: a relative error of 1e-5
(the products and sums are taken in other orders than the reference's).
"""
import dataclasses
import math
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cabench.drivers import lm_serve_mla_moe as driver  # noqa: E402
from cabench.reference import lm_mla_moe as reference  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import GroupGateMoECfg, YarnCfg  # noqa: E402
from repro_torch.models import attention, common, moe  # noqa: E402
from repro_torch.serve import Request, ServeEngine, lm_engine  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5


def _rel(got, ref):
    return float((got - ref).norm() / ref.norm())


def _gate_cfg(**kw):
    e = GroupGateMoECfg(n_experts=8, top_k=4, d_ff_expert=1, n_groups=4,
                        topk_groups=3, route_scale=2.5, **kw)
    return SimpleNamespace(moe=e)


def _sig(z):
    return 1.0 / (1.0 + math.exp(-z))


def test_gate_hand_worked_example():
    """Eight experts in four groups of two, three groups kept, top 4.
    Scores sigmoid(3, -1, 0, 0, 0, 0, 1, -1), bias 0.5 on expert 7: the
    groups' top-2 sums are 1.22, 1.0, 1.0, 1.5, so groups 3 and 0 are kept
    and the tie of groups 1 and 2 goes to group 1; the biased scores of the
    kept experts 0.953, 0.269, 0.5, 0.5, 0.731, 0.769 give experts 0, 7,
    6 and, of the tie of 2 and 3, expert 2.  The weights are the unbiased
    scores of 0, 7, 6, 2 over their sum, times 2.5: expert 7 weighs by its
    score, not by its bias."""
    logits = torch.tensor([[3.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0, -1.0]])
    p = {"router": logits, "bias": torch.tensor(
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5])}
    weight, expert = moe.group_gate(p, torch.ones(1, 1), _gate_cfg())
    assert expert.tolist() == [[0, 7, 6, 2]]
    s = [_sig(3.0), _sig(-1.0), _sig(1.0), 0.5]
    want = [2.5 * v / sum(s) for v in s]
    np.testing.assert_allclose(weight[0].numpy(), want, rtol=1e-6)
    assert float(weight.sum()) == pytest.approx(2.5, rel=1e-6)
    # Two groups kept: group 1's experts are out, and the tie of 2 and 3
    # no longer counts; expert 1 comes in.
    weight, expert = moe.group_gate(p, torch.ones(1, 1), SimpleNamespace(
        moe=dataclasses.replace(_gate_cfg().moe, topk_groups=2)))
    assert expert.tolist() == [[0, 7, 6, 1]]
    # Without the bias and with every group kept, expert 7 falls below
    # the four-way tie of 2, 3, 4 and 5, which goes to 2 and 3.
    weight, expert = moe.group_gate(dict(p, bias=torch.zeros(8)),
                                    torch.ones(1, 1), SimpleNamespace(
        moe=dataclasses.replace(_gate_cfg().moe, topk_groups=4)))
    assert expert.tolist() == [[0, 6, 2, 3]]


def _smoke(held=0, first=0):
    cfg = dataclasses.replace(get_smoke("deepseek-v3"), mtp=False)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, held=held, first_expert=first))


def _layer(seed, cfg, scale=0.3):
    """One expert layer's parameters for ``cfg`` (every expert), seeded."""
    g = torch.Generator().manual_seed(seed)
    e, d = cfg.moe, cfg.d_model
    f = e.d_ff_expert

    def rnd(*shape):
        return torch.randn(shape, generator=g) * scale

    return {"router": rnd(d, e.n_experts), "bias": rnd(e.n_experts) * 0.2,
            "wg": rnd(e.n_experts, d, f), "wu": rnd(e.n_experts, d, f),
            "wd": rnd(e.n_experts, f, d),
            "shared": {"wg": rnd(d, f), "wu": rnd(d, f), "wd": rnd(f, d)}}


def _share(p, first, n):
    return dict(p, **{k: p[k][first:first + n] for k in ("wg", "wu", "wd")})


@pytest.mark.parametrize("t", [1, 5, 40, 300])
@pytest.mark.parametrize("held,first", [(0, 0), (2, 0), (2, 30), (2, 62),
                                        (8, 16)])
def test_dropless_share_matches_a_per_token_loop(t, held, first):
    """Every (token, held expert) pair the gate picks, through its expert,
    weighted and summed, whatever the number of pairs: no pair is dropped,
    and the pairs not picked add nothing."""
    cfg = _smoke(held, first)
    p = _layer(t + held + first, cfg)
    n = cfg.moe.n_held
    ps = _share(p, first, n)
    xt = torch.randn(t, cfg.d_model, generator=torch.Generator()
                     .manual_seed(t))
    weight, expert = moe.group_gate(p, xt, cfg)
    got = moe.share_experts(ps, xt, weight, expert, cfg)
    ref = torch.zeros_like(got)
    pairs = 0
    for i in range(t):
        for j in range(cfg.moe.top_k):
            e = int(expert[i, j]) - first
            if 0 <= e < n:
                pairs += 1
                h = common.silu(xt[i] @ ps["wg"][e]) * (xt[i] @ ps["wu"][e])
                ref[i] += weight[i, j] * (h @ ps["wd"][e])
    if pairs:
        assert _rel(got, ref) < TOL
    else:
        assert torch.equal(got, torch.zeros_like(got))


def test_share_counts_the_pairs_it_computes():
    """``moe.routed_pairs``: every held expert over every token, counted
    on the host, with no synchronise."""
    from repro_torch import telemetry
    cfg = _smoke(2, 30)
    p = _share(_layer(3, cfg), 30, 2)
    xt = torch.randn(40, cfg.d_model)
    weight, expert = moe.group_gate(p, xt, cfg)
    tel = telemetry.default()
    tel.reset()
    telemetry.configure(True)
    try:
        moe.share_experts(p, xt, weight, expert, cfg)
        assert telemetry.summary()["counters"] == {"moe.routed_pairs": 80}
    finally:
        telemetry.configure(False)
        tel.reset()


def _ref_cfg(cfg, ep_size, rank=0):
    """The reference's configuration keys of program configuration
    ``cfg``, its experts cut into ``ep_size`` shares."""
    e = cfg.moe
    return {"n_routed_experts": e.n_experts // ep_size, "ep_size": ep_size,
            "ep_rank": rank, "n_group": e.n_groups,
            "topk_group": e.topk_groups, "num_experts_per_tok": e.top_k,
            "routed_scaling_factor": e.route_scale}


def test_shares_add_up_to_the_uncut_reference_layer():
    """The 32 shares of 2 experts of the smoke twin's 64: their outputs,
    less the shared expert that each computes alike, summed, and the
    shared expert once, are the reference's uncut layer."""
    cfg = _smoke()
    p = _layer(7, cfg)
    x = torch.randn(1, 50, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    shared = moe.mlp_block(p["shared"], x)
    total = shared.clone()
    for r in range(32):
        c = _smoke(2, 2 * r)
        total += moe.share_block(_share(p, 2 * r, 2), x, c) - shared
    rp = {"router": p["router"], "bias": p["bias"], "ewg": p["wg"],
          "ewu": p["wu"], "ewd": p["wd"], "swg": p["shared"]["wg"],
          "swu": p["shared"]["wu"], "swd": p["shared"]["wd"]}
    ref = reference.expert_layer(x[0], rp, _ref_cfg(cfg, 1))
    assert _rel(total[0], ref) < TOL
    # One share alone is the reference's share.
    rs = dict(rp, ewg=p["wg"][6:8], ewu=p["wu"][6:8], ewd=p["wd"][6:8])
    one = moe.share_block(_share(p, 6, 2), x, _smoke(2, 6))
    assert _rel(one[0], reference.expert_layer(x[0], rs,
                                               _ref_cfg(cfg, 32, 3))) < TOL


def test_yarn_frequencies_and_scale_follow_the_formula():
    """The published rope_scaling over 64 rotary dims: the correction
    range is floor(64 ln(4096 / (32 2 pi)) / (2 ln 1e4)) = 10 to ceil(64
    ln(4096 / (2 pi)) / (2 ln 1e4)) = 23; pairs up to 10 keep theta's
    frequency, from 23 on take it over 40, and blend linearly between;
    the softmax scale is 192 ** -0.5 (0.1 ln 40 + 1) ** 2 = 0.13523."""
    yarn = YarnCfg()
    got = common.yarn_frequencies(64, 1e4, yarn)
    base = 1e4 ** (-np.arange(0, 64, 2) / 64)
    low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                     / (2 * math.log(1e4)))
    high = math.ceil(64 * math.log(4096 / (2 * math.pi))
                     / (2 * math.log(1e4)))
    assert (low, high) == (10, 23)
    for i in range(32):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        assert got[i] == pytest.approx(base[i] * (1 - ramp)
                                       + base[i] / 40 * ramp, rel=1e-12)
    assert got[10] == pytest.approx(base[10]) and \
        got[23] == pytest.approx(base[23] / 40)
    cfg = get_config("deepseek-v3")
    assert attention.mla_scale(cfg) == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2, rel=1e-12)
    assert attention.mla_scale(cfg) == pytest.approx(0.13523, abs=1e-5)
    assert attention.mla_scale(get_config("deepseek-v3-671b")) == \
        192 ** -0.5
    # The rotation turns pair i by position x frequency i.
    x = torch.zeros(3, 1, 64, dtype=torch.float64)
    x[..., 5] = 1.0
    inv = torch.tensor(got)
    y = common.rotate(x, torch.arange(3.0, dtype=torch.float64), inv)
    assert torch.allclose(y[:, 0, 5], torch.cos(torch.arange(3.0) * inv[5])
                          .double())
    assert torch.allclose(y[:, 0, 37], torch.sin(torch.arange(3.0) * inv[5])
                          .double())


def test_registered_models_are_the_published_one_and_the_twin():
    full = get_config("deepseek-v3")
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab,
            full.norm_eps, full.rope_theta) == (61, 7168, 128, 129280, 1e-6,
                                                1e4)
    e = full.moe
    assert (e.n_experts, e.top_k, e.n_groups, e.topk_groups, e.route_scale,
            e.n_shared, e.d_ff_expert, e.first_dense, e.n_held) == (
        256, 8, 8, 4, 2.5, 1, 2048, 3, 256)
    smoke = get_smoke("deepseek-v3")
    assert (smoke.moe.n_groups, smoke.moe.n_experts // 32) == (8, 2)
    assert not isinstance(get_config("deepseek-v3-671b").moe,
                          GroupGateMoECfg)


@pytest.mark.parametrize("seed", [5, 2 ** 32 + 17])
def test_serve_engine_matches_the_reference(seed, monkeypatch):
    """``ServeEngine`` at the smoke twin's widths, one chip's share (rank 9
    of 32), three requests through two slots: each request's prefill and
    decode logits are the reference's, teacher forced over its prompt and
    output."""
    cfg = _smoke_cell(ep_rank=9, dtype="float32", init_std=0.2)
    wt = driver.draw_weights(cfg, seed, CPU)
    mcfg = driver.model_cfg(cfg)
    eng = ServeEngine(driver.program_tree(wt, cfg), mcfg, batch_size=2,
                      max_len=40, cache_dtype=torch.float32, device=CPU)
    got = {}

    def prefill(*a, **kw):
        last, cache = inner_prefill(*a, **kw)
        got[len(got)] = [last[0]]
        return last, cache

    def decode_step(params, c, cache, token, pos):
        logits, cache = inner_decode(params, c, cache, token, pos)
        for i, s in enumerate(eng.slots):
            if s is not None:
                got[s.rid].append(logits[i])
        return logits, cache

    inner_prefill, inner_decode = lm_engine.prefill, lm_engine.decode_step
    monkeypatch.setattr(lm_engine, "prefill", prefill)
    monkeypatch.setattr(lm_engine, "decode_step", decode_step)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, n).astype(np.int32),
                    max_new=m) for i, (n, m) in enumerate(
                        [(9, 6), (17, 4), (5, 8)])]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        (ref,) = reference.logits(wt, cfg, [seq], [len(r.prompt) - 1])
        rows = torch.stack(got[r.rid][:len(r.out)])
        assert len(r.out) == r.max_new
        err = (rows - ref).norm(dim=-1) / ref.norm(dim=-1)
        assert float(err.max()) < TOL, err


def _smoke_cell(**kw):
    """The cell's configuration at tiny widths (the smoke twin's)."""
    from cabench import harness
    return {**harness.resolve(harness.load_benchmark(),
                              "deepseek-v3-ep32-bf16-256x2560.chat-256")
            ["config"],
            "hidden_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 4, "q_lora_rank": 32, "kv_lora_rank": 16,
            "qk_rope_head_dim": 8, "qk_nope_head_dim": 8, "v_head_dim": 8,
            "intermediate_size": 128, "moe_intermediate_size": 32,
            "n_routed_experts": 2, "first_k_dense_replace": 1,
            "num_hidden_layers": 4, "vocab_size": 512, **kw}


def test_greedy_engine_serves_the_host_argmax(monkeypatch):
    """``ServeEngine``'s greedy choice, taken on the device, is the first
    of equal maxima as ``np.argmax`` takes it on the host, in prefill and
    in decode; bf16 logits make ties likely."""
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                           [0.0, 0.0, 0.0, 1.0]], dtype=torch.bfloat16)
    host = SimpleNamespace(greedy=True)
    assert logits.argmax(-1).tolist() == [
        ServeEngine._select(host, r) for r in ServeEngine._host(logits)
    ] == [1, 0, 3]
    cfg = _smoke_cell(dtype="bfloat16")
    wt = driver.draw_weights(cfg, 3, CPU)
    eng = ServeEngine(driver.program_tree(wt, cfg), driver.model_cfg(cfg),
                      batch_size=2, max_len=40, cache_dtype=torch.bfloat16,
                      device=CPU)
    want = {}

    def prefill(*a, **kw):
        last, cache = inner_prefill(*a, **kw)
        want[len(want)] = [int(np.argmax(ServeEngine._host(last[0])))]
        return last, cache

    def decode_step(params, c, cache, token, pos):
        logits, cache = inner_decode(params, c, cache, token, pos)
        for i, s in enumerate(eng.slots):
            if s is not None:
                want[s.rid].append(int(np.argmax(
                    ServeEngine._host(logits[i]))))
        return logits, cache

    inner_prefill, inner_decode = lm_engine.prefill, lm_engine.decode_step
    monkeypatch.setattr(lm_engine, "prefill", prefill)
    monkeypatch.setattr(lm_engine, "decode_step", decode_step)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, n).astype(np.int32),
                    max_new=m) for i, (n, m) in enumerate(
                        [(9, 6), (17, 4), (5, 8)])]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert {r.rid: r.out for r in reqs} == want


@pytest.mark.gpu
def test_expert_share_on_the_card_matches_a_per_token_loop():
    """On the card, at the published widths in bf16: the expert share
    against a per-token loop in float32, at a decode batch and at prefill
    lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("deepseek-v3"), moe=dataclasses
                              .replace(get_config("deepseek-v3").moe,
                                       held=8, first_expert=8))
    g = torch.Generator(device=dev).manual_seed(3)
    d, f = cfg.d_model, cfg.moe.d_ff_expert

    def rnd(*shape, s=0.02):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16) * s

    p = {"router": rnd(d, 256), "bias": rnd(256, s=0.05),
         "wg": rnd(8, d, f), "wu": rnd(8, d, f), "wd": rnd(8, f, d)}
    for t in (3, 256, 1500):
        x = rnd(t, d, s=1.0)
        weight, expert = moe.group_gate(p, x, cfg)
        out = moe.share_experts(p, x, weight, expert, cfg).float()
        ref = torch.zeros(t, d, device=dev)
        for j in range(8):
            hit = expert == 8 + j
            tok = hit.any(-1).nonzero()[:, 0]
            xs = x[tok].float()
            h = torch.nn.functional.silu(xs @ p["wg"][j].float()) \
                * (xs @ p["wu"][j].float())
            ref[tok] += (weight * hit)[tok].sum(-1, keepdim=True) \
                * (h @ p["wd"][j].float())
        assert _rel(out, ref) < 2e-2
