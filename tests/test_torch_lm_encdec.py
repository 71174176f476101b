"""The port's encoder-decoder (seamless-m4t-medium's smoke config) against
the JAX reference on the CPU.

The reference's ``init_params(cfg, jax.random.key(0))`` tree is carried
into the port (``params_from_reference``), and the same tokens and frame
embeddings, made from a numpy seed, go through both packages in float32:
cross-attention (``attn_block(kv_x=, rope=False)`` and
``attn_decode(cross=True)``), the encoder alone with more frames than
tokens, ``forward``, ``prefill`` with every cache leaf (``cross``
included), four ``decode_step``s at per-row positions, and the init's
shapes and count.  Tolerance: rtol 1e-4, atol 1e-4 (``_torch_lm``).  The
reference's ``ServeEngine`` cannot serve this family (its length-0 cross
cache fails the first slot write), so the port's engine refuses it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke
from repro_torch.models import (decode_step, forward, init_cache,
                                params_from_reference, prefill)
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.serve import ServeEngine

ARCH = "seamless-m4t-medium"
T_ENC = 29          # encoder frames: more than the decoder's tokens
close = L.close


def frames(cfg, b=L.B, t=T_ENC, seed=0):
    rng = np.random.default_rng(100 + seed)
    return (0.1 * rng.standard_normal((b, t, cfg.d_model))).astype(
        np.float32)


def layer0(jp, tp):
    (name,) = tp["layers"]
    return (jax.tree.map(lambda a: a[0], jp["layers"][name]),
            lm.layer(tp["layers"][name], 0))


def test_cross_attention_block_and_decode_match_reference():
    jcfg, jp, cfg, tp = L.model(ARCH)
    jl, tl = layer0(jp, tp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((L.B, 7, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((L.B, T_ENC, cfg.d_model)).astype(np.float32)
    want = jattn.attn_block(jl["xattn"], jnp.asarray(x), jcfg,
                            positions=None, causal=False,
                            kv_x=jnp.asarray(enc), rope=False)
    got = attn.attn_block(tl["xattn"], torch.from_numpy(x), cfg,
                          positions=None, causal=False,
                          kv_x=torch.from_numpy(enc), rope=False)
    close(got, want)
    kv = {k: rng.standard_normal((L.B, T_ENC, cfg.n_kv_heads, cfg.hd))
          .astype(np.float32) for k in ("k", "v")}
    pos = np.array([4, 11], np.int32)
    want, jc = jattn.attn_decode(jl["xattn"], jnp.asarray(x[:, :1]), jcfg,
                                 jax.tree.map(jnp.asarray, kv),
                                 jnp.asarray(pos), cross=True)
    tkv = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    got, tc = attn.attn_decode(tl["xattn"], torch.from_numpy(x[:, :1]), cfg,
                               tkv, torch.from_numpy(pos), cross=True)
    close(got, want)
    for k in kv:                       # the static cache is only read
        assert np.array_equal(tc[k].numpy(), kv[k])


def test_cross_block_draws_no_biases_and_decode_query_skips_qk_norm():
    # The reference's asymmetries, kept: a cross block has no bq/bk/bv,
    # and the cross decode's query takes no QK norm.
    import dataclasses
    cfg = dataclasses.replace(get_smoke(ARCH), qkv_bias=True, qk_norm=True)
    p = attn.init_attn(lm.cm.Init(0, device="cpu"), cfg, cross=True)
    assert "bq" not in p and {"qn", "kn"} <= set(p)
    p["qn"] = torch.full_like(p["qn"], 5.0)      # a norm that would show
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, cfg.d_model, generator=gen)
    kv = {k: torch.randn(2, 6, cfg.n_kv_heads, cfg.hd, generator=gen)
          for k in ("k", "v")}
    got, _ = attn.attn_decode(p, x, cfg, kv, 0, cross=True)
    plain = dict(p)
    del plain["qn"], plain["kn"]
    want, _ = attn.attn_decode(plain, x, cfg, kv, 0, cross=True)
    assert torch.equal(got, want)


def test_encoder_matches_reference_with_more_frames_than_tokens():
    jcfg, jp, cfg, tp = L.model(ARCH)
    fr = frames(cfg)
    jparams = jlm.cast_params_for_compute(jp, jcfg)
    want, _ = jlm._scan_stack(jnp.asarray(fr), {"0": jparams["enc_layers"]},
                              jcfg, positions=jnp.arange(T_ENC),
                              causal=False, train=False, kinds=("a",))
    want = jlm.cm.apply_norm(want, jparams["enc_norm"], jcfg.norm,
                             jcfg.norm_eps)
    got = lm._encode(tp, cfg, torch.from_numpy(fr))
    assert got.shape == (L.B, T_ENC, cfg.d_model)
    close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(seed):
    jcfg, jp, cfg, tp = L.model(ARCH)
    toks, fr = L.tokens(cfg, seed=seed), frames(cfg, seed=seed)
    want, jaux = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                        "frames": jnp.asarray(fr)},
                             train=False)
    got, aux = forward(tp, cfg, {"tokens": torch.from_numpy(toks),
                                 "frames": torch.from_numpy(fr)})
    assert got.shape == (L.B, L.S, cfg.vocab) and float(aux) == 0.0
    close(got, want)


def test_prefill_caches_and_decode_match_reference():
    jcfg, jp, cfg, tp = L.model(ARCH)
    toks, fr = L.tokens(cfg, seed=1), frames(cfg, seed=1)
    jl, jc = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(fr)},
                         max_len=L.MAX_LEN, cache_dtype=jnp.float32)
    tl, tc = prefill(tp, cfg, {"tokens": torch.from_numpy(toks),
                               "frames": torch.from_numpy(fr)},
                     max_len=L.MAX_LEN, cache_dtype=torch.float32)
    assert set(tc) == {"layers", "cross"}
    assert tuple(tc["cross"]["k"].shape) == (cfg.n_cycles, L.B, T_ENC,
                                             cfg.n_kv_heads, cfg.hd)
    close(tl, jl)
    L.leaves_close(tc, jc)
    cross = {k: v.clone() for k, v in tc["cross"].items()}
    jdecode = jax.jit(jlm.decode_step, static_argnums=1)
    pos = np.array([L.S, L.S - 5], np.int32)
    tok = np.array([3, 5], np.int32)
    for _ in range(4):
        jl, jc = jdecode(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc2 = decode_step(tp, cfg, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
        assert tc2 is tc
        close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        pos = pos + 1
    L.leaves_close(tc, jc)
    assert all(torch.equal(tc["cross"][k], cross[k]) for k in cross)


def test_init_params_matches_reference_shapes_and_count():
    L.check_init(ARCH)
    cache = init_cache(get_smoke(ARCH), 2, 8, torch.float32, device="cpu")
    assert tuple(cache["cross"]["k"].shape)[2] == 0   # filled by prefill


def test_params_from_reference_refuses_a_tree_without_the_encoder():
    jcfg, jp, cfg, _ = L.model(ARCH)
    tree = jax.tree.map(np.asarray, jp)
    for drop in ("enc_layers", "enc_norm"):
        with pytest.raises(ValueError, match=drop):
            params_from_reference({k: v for k, v in tree.items()
                                   if k != drop}, cfg)
    (name,) = tree["layers"]
    plain = dict(tree["layers"][name])
    del plain["xattn"]
    with pytest.raises(ValueError, match="xattn"):
        params_from_reference(dict(tree, layers={name: plain}), cfg)
    # A decoder-only tree is not an encoder-decoder's either way round.
    _, jp100, cfg100, _ = L.model("repro-100m")
    with pytest.raises(ValueError):
        params_from_reference(jax.tree.map(np.asarray, jp100), cfg)
    with pytest.raises(ValueError):
        params_from_reference(tree, cfg100)


def test_serve_engine_refuses_encdec_as_the_reference_cannot_serve_it():
    jcfg, jp, cfg, tp = L.model(ARCH)
    prompt = np.arange(3, 10).astype(np.int32)
    ref = JServeEngine(jp, jcfg, batch_size=2, max_len=16)
    ref.submit(JRequest(rid=0, prompt=prompt, max_new=2))
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        ref.run_until_done()            # the length-0 cross cache
    with pytest.raises(NotImplementedError,
                       match="cross cache.*prefill and decode_step"):
        ServeEngine(tp, cfg, 2, 16, device="cpu")
