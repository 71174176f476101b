"""The port's experts and MLA families against the JAX reference on the CPU.

deepseek-v3-671b (MLA, a dense prefix, 8 routed experts top-2 plus a
shared one, MTP) and llama4-scout-17b-a16e (4 experts top-1 plus a shared
one) at their smoke configs, in float32, from one tree given to both
packages: ``forward`` logits and aux loss, ``prefill``'s last logits and
caches (MLA's latent ``c`` and rotated ``kr``, the prefix's), four
per-row ``decode_step``s, ``init_params`` shapes and ``param_count``,
``params_from_reference`` (helpers in ``tests/_torch_lm.py``).  Units:
``moe_block`` at a capacity that drops assignments (asserted) and at one
that drops none, routing ties, ``mla_block`` and ``mla_decode``; the
engine's slot copy of the prefix cache; the entry points' card default
(both engines: ``test_torch_lm_serve_families.py``).  Tolerance: rtol
1e-4, atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import init_cache, init_params, lm
from repro_torch.models import moe
from repro_torch.models import params_from_reference
from repro_torch.serve import Request, ServeEngine

ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-a16e")
CPU = torch.device("cpu")
close = L.close


def _np(tree):
    return lm.tree_map(lambda t: t.numpy(), tree)


def _both(tree):
    """A numpy tree as the reference's (jnp) and the port's (torch)."""
    return (jax.tree.map(jnp.asarray, tree),
            lm.tree_map(lambda a: torch.from_numpy(np.array(a)), tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(arch):
    L.check_forward(arch, ref_init=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_reference(arch):
    L.check_prefill_and_decode(arch, ref_init=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes_and_count(arch):
    L.check_init(arch, ref_init=False)


def test_params_from_reference_checks_prefix_mtp_and_experts():
    jcfg, _, cfg, _ = L.model("deepseek-v3-671b", ref_init=False)
    shapes = L.ref_shapes(jcfg)
    tree = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    tp = params_from_reference(tree, cfg, device="cpu")
    assert set(tp) == {"embed", "prefix", "layers", "final_norm", "head",
                       "mtp"}
    assert tp["layers"]["0_e"]["ffn"]["wg"].shape == (
        cfg.n_cycles, cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert)
    for bad in (dict(tree, mtp=None), {k: v for k, v in tree.items()
                                       if k != "prefix"}):
        bad = {k: v for k, v in bad.items() if v is not None}
        with pytest.raises(ValueError):
            params_from_reference(bad, cfg, device="cpu")
    ffn = dict(tree["layers"]["0_e"]["ffn"])
    ffn["wg"] = ffn["wg"][:, :-1]                     # one expert short
    bad = dict(tree, layers={"0_e": dict(tree["layers"]["0_e"], ffn=ffn)})
    with pytest.raises(ValueError, match="wg"):
        params_from_reference(bad, cfg, device="cpu")


def _moe_case(arch, cf, seed):
    base = get_smoke(arch)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    p = _np(moe.init_moe(cm.Init(seed, device="cpu"), cfg))
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("drops", [True, False])
def test_moe_block_matches_reference(arch, drops):
    # The smallest capacity (8 slots) drops; n_experts / top_k drops none.
    e = get_smoke(arch).moe
    cfg, p, x = _moe_case(arch, 0.25 if drops else e.n_experts / e.top_k, 5)
    jp, tp = _both(p)
    tx = torch.from_numpy(x)
    _, _, expert = moe.route(tp, tx.reshape(-1, cfg.d_model), cfg)
    cap = moe.capacity(x.shape[0] * x.shape[1], cfg)
    _, keep = moe.assign_slots(expert.reshape(1, -1), e.n_experts, cap)
    assert bool((~keep).any()) == drops
    assert (np.bincount(expert.flatten().numpy()).max() > cap) == drops
    want, jaux = jmoe.moe_block(jp, jnp.asarray(x), cfg)
    got, aux = moe.moe_block(tp, tx, cfg)
    close(got, want)
    close(aux, jaux)


def test_moe_routing_ties_go_to_the_lower_expert():
    # Equal router columns: jax.lax.top_k picks the lower index first.
    cfg, p, x = _moe_case("deepseek-v3-671b", 4.0, 2)
    p["router"][:, 5] = p["router"][:, 2]
    p["router"][:, 6] = p["router"][:, 2]
    jp, tp = _both(p)
    _, _, expert = moe.route(tp, torch.from_numpy(x).reshape(-1, 128), cfg)
    assert ((expert == 2).any(1) & (expert == 5).any(1)).any()
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 128)
                           @ jp["router"], axis=-1)
    _, jexpert = jax.lax.top_k(probs, cfg.moe.top_k)
    assert (expert.numpy() == np.asarray(jexpert)).all()
    close(moe.moe_block(tp, torch.from_numpy(x), cfg)[0],
          jmoe.moe_block(jp, jnp.asarray(x), cfg)[0])


def _mla_case(seed):
    cfg = get_smoke("deepseek-v3-671b")
    p = _np(attn.init_mla(cm.Init(seed, device="cpu"), cfg))
    rng = np.random.default_rng(seed)
    p["qn"] = rng.standard_normal(p["qn"].shape).astype(np.float32) * 0.1
    p["kvn"] = rng.standard_normal(p["kvn"].shape).astype(np.float32) * 0.1
    return cfg, p, rng


def test_mla_block_matches_reference():
    cfg, p, rng = _mla_case(1)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    pos = np.arange(19) + 3
    jp, tp = _both(p)
    want = jattn.mla_block(jp, jnp.asarray(x), cfg,
                           positions=jnp.asarray(pos))
    got = attn.mla_block(tp, torch.from_numpy(x), cfg,
                         positions=torch.from_numpy(pos))
    close(got, want)


def test_mla_decode_matches_reference():
    # Per-row positions against a filled latent cache; the new row is
    # written in place at each row's position.
    cfg, p, rng = _mla_case(2)
    m, t = cfg.mla, 16
    cache = {"c": rng.standard_normal((3, t, m.kv_lora)).astype(np.float32),
             "kr": rng.standard_normal((3, t, m.rope_dim)).astype(
                 np.float32)}
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 7, 15], np.int32)
    jp, tp = _both(p)
    jc, tc = _both(cache)
    want, wc = jattn.mla_decode(jp, jnp.asarray(x), cfg, jc,
                                jnp.asarray(pos))
    got, gc = attn.mla_decode(tp, torch.from_numpy(x), cfg, tc,
                              torch.from_numpy(pos))
    assert gc is tc
    close(got, want)
    L.leaves_close(gc, wc)


def test_mla_attend_by_depth_matches_reference():
    # The factored core alone, on rows at depths 0, mid and T - 1 of a
    # cache whose later positions hold noise, then W_uv and wo: the
    # reference's whole decode.  A row at depth 0 sees only its own key.
    cfg, p, rng = _mla_case(3)
    m, t = cfg.mla, 24
    cache = {"c": rng.standard_normal((3, t, m.kv_lora)).astype(np.float32),
             "kr": rng.standard_normal((3, t, m.rope_dim)).astype(
                 np.float32)}
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 11, t - 1], np.int64)
    jp, tp = _both(p)
    jc, tc = _both(cache)
    want, _ = jattn.mla_decode(jp, jnp.asarray(x), cfg, jc, jnp.asarray(pos))
    tx, pv = torch.from_numpy(x), torch.from_numpy(pos)
    q_nope, q_rope = attn._mla_qkr(tp, tx, cfg, pv[:, None])
    c1, kr1 = attn._mla_latent(tp, tx, cfg, pv[:, None])
    attn.write_rows(tc["c"], pv, c1[:, 0])
    attn.write_rows(tc["kr"], pv, kr1[:, 0])
    q_lat = torch.einsum("bshk,chk->bshc", q_nope, tp["wuk"])
    ctx = attn.mla_attend(q_lat, q_rope, tc["c"], tc["kr"], pv,
                          attn.mla_scale(cfg))
    assert ctx.shape == (3, 1, cfg.n_heads, m.kv_lora)
    close(ctx[0, 0], c1[0].expand(cfg.n_heads, m.kv_lora))
    o = torch.einsum("bshc,chv->bshv", ctx, tp["wuv"])
    close(torch.einsum("bshv,hvd->bsd", o, tp["wo"]), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_mla_decode_on_cpu_takes_the_plain_core(monkeypatch, dtype):
    # CPU tensors never reach the kernel, in float32 or bf16: the plain
    # core runs once a call and the kernel's launch count stays 0; the
    # kernel's wrapper refuses CPU tensors outright.
    from repro_torch.kernels.mla_decode import ops as mla_ops
    cfg, p, rng = _mla_case(4)
    m, t = cfg.mla, 8
    tp = lm.tree_map(lambda a: torch.from_numpy(a).to(dtype), p)
    cache = {"c": torch.zeros((2, t, m.kv_lora), dtype=dtype),
             "kr": torch.zeros((2, t, m.rope_dim), dtype=dtype)}
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(
        np.float32)).to(dtype)
    plain = []
    real = attn.mla_attend
    monkeypatch.setattr(attn, "mla_attend",
                        lambda *a: plain.append(1) or real(*a))
    mla_ops.LAUNCHES.clear()
    out, _ = attn.mla_decode(tp, x, cfg, cache, torch.tensor([0, 5]))
    assert out.shape == (2, 1, cfg.d_model) and out.dtype == dtype
    assert plain == [1] and mla_ops.launches_total() == 0
    q = torch.zeros((2, cfg.n_heads, m.kv_lora), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        mla_ops.attend(q, q[..., :m.rope_dim], cache["c"], cache["kr"],
                       torch.tensor([0, 5]), 1.0)


def test_engine_copies_the_prefix_cache_into_its_slot():
    cfg = get_smoke("deepseek-v3-671b")
    params = init_params(cfg, seed=1, device="cpu")
    eng = ServeEngine(params, cfg, batch_size=3, max_len=16, device=CPU)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32) + 9,
                       max_new=4))
    eng._fill_free_slots()
    _, one = lm.prefill(params, cfg, {"tokens": torch.arange(5)[None] + 9},
                        16, torch.float32)
    for part in ("prefix", "layers"):
        got = list(lm.tree_leaves(eng.cache[part]))
        want = list(lm.tree_leaves(one[part]))
        assert all(torch.equal(g[:, 0], w[:, 0]) for g, w in zip(got, want))
        assert all(float(g[:, 1:].abs().max()) == 0.0 for g in got)


def test_entry_points_default_to_the_card(monkeypatch):
    cfg = get_smoke("deepseek-v3-671b")
    tree = _np(init_params(cfg, seed=0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_params(cfg),
                 lambda: init_cache(cfg, 1, 8, torch.float32),
                 lambda: params_from_reference(tree, cfg),
                 lambda: attn.init_mla_cache(torch.float32, cfg, 1, 8),
                 lambda: attn.init_decode_cache(torch.float32, cfg, 1, 8),
                 lambda: cm.Init(0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
