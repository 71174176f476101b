"""The port's SSM and hybrid families against the JAX reference on the CPU.

mamba2-2.7b (Mamba-2 layers only) and zamba2-2.7b (groups of Mamba-2
layers, each followed by one of two shared attention blocks) at their
smoke configs, in float32, from one tree given to both packages:
``forward`` logits (the sequence a whole number of SSD chunks), ``prefill``
(the prompt padded to the chunk inside) with its caches -- each layer's
SSM state and conv buffer, the shared blocks' K/V -- four per-row
``decode_step``s, ``init_params`` shapes and ``param_count`` (the SSM's
``A_log`` and ``dt_bias`` equal to the reference's own draws),
``params_from_reference`` (helpers in ``tests/_torch_lm.py``).  Units:
``ssm_block`` with ``mask`` and ``return_state`` at a ``real_len`` off
the chunk boundary, with one and two B/C groups, ``ssm_decode`` and the
naive recurrence; separate cache storage per layer and group; the
engine's slot copy along zamba2's batch axis 2 (both engines:
``test_torch_lm_serve_families.py``).  Tolerance: rtol 1e-4, atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.models import common as jcm
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke
from repro_torch.models import common as cm
from repro_torch.models import init_cache, init_params, lm, ssm
from repro_torch.serve import Request, ServeEngine

ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
CPU = torch.device("cpu")
close = L.close


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    L.check_forward(arch, ref_init=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_reference(arch):
    L.check_prefill_and_decode(arch, ref_init=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes_and_count(arch):
    L.check_init(arch, ref_init=False)


def _ssm_case(groups, seed):
    base = get_smoke("mamba2-2.7b")
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, n_groups=groups))
    p = lm.tree_map(lambda t: t.numpy(),
                    ssm.init_ssm(cm.Init(seed, device="cpu"), cfg))
    rng = np.random.default_rng(seed)
    p["norm_w"] = rng.standard_normal(p["norm_w"].shape).astype(
        np.float32) * 0.1
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(
        np.float32) * 0.1
    return cfg, p, rng


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            lm.tree_map(lambda a: torch.from_numpy(np.array(a)), tree))


def test_ssm_init_draws_equal_the_reference():
    cfg = get_smoke("mamba2-2.7b")
    want, _ = jcm.split_tree(jssm.init_ssm(
        jcm.Init(jax.random.key(0)), cfg))
    got = ssm.init_ssm(cm.Init(0, device="cpu"), cfg)
    for k in ("A_log", "dt_bias", "D", "conv_b", "norm_w"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("in_proj", "conv_w", "out_proj"):
        assert tuple(got[k].shape) == want[k].shape


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("real_len", [21, 3, 32])
def test_ssm_block_mask_and_state_match_reference(groups, real_len):
    # real_len 21 and 3 lie off the 16-token chunk boundary (3 is shorter
    # than the conv kernel); the pad's dt is masked to zero.
    cfg, p, rng = _ssm_case(groups, 3 + groups)
    x = (rng.standard_normal((2, 32, cfg.d_model)) * 0.5).astype(np.float32)
    mask = (np.arange(32) < real_len)[None, :]
    jp, tp = _both(p)
    want, (wst, wcv) = jssm.ssm_block(jp, jnp.asarray(x), cfg,
                                      mask=jnp.asarray(mask),
                                      return_state=True, real_len=real_len)
    got, (gst, gcv) = ssm.ssm_block(tp, torch.from_numpy(x), cfg,
                                    mask=torch.from_numpy(mask),
                                    return_state=True, real_len=real_len)
    close(got, want)
    close(gst, wst)
    close(gcv, wcv)
    close(ssm.ssm_block(tp, torch.from_numpy(x), cfg),
          jssm.ssm_block(jp, jnp.asarray(x), cfg))


def test_ssm_decode_and_naive_recurrence_match_reference():
    cfg, p, rng = _ssm_case(2, 9)
    d_in, nheads, conv_ch = ssm.dims(cfg)
    s = cfg.ssm
    cache = (rng.standard_normal((3, nheads, s.d_state, s.head_dim)).astype(
        np.float32), rng.standard_normal((3, s.conv_dim, conv_ch)).astype(
        np.float32))
    x = (rng.standard_normal((3, 1, cfg.d_model)) * 0.5).astype(np.float32)
    jp, tp = _both(p)
    jc, tc = _both(cache)
    want, wc = jssm.ssm_decode(jp, jnp.asarray(x), cfg, jc)
    got, gc = ssm.ssm_decode(tp, torch.from_numpy(x), cfg, tc)
    assert gc is tc                           # updated in place
    close(got, want)
    L.leaves_close(gc, wc)
    xs = (rng.standard_normal((2, 10, cfg.d_model)) * 0.5).astype(np.float32)
    close(ssm.ssm_block_naive(tp, torch.from_numpy(xs), cfg),
          jssm.ssm_block_naive(jp, jnp.asarray(xs), cfg))


def test_caches_are_separate_storage():
    # Every layer's and group's cache is its own memory (no expanded
    # views): writing one leaves the others zero.
    cfg = get_smoke("zamba2-2.7b")
    cache = init_cache(cfg, 2, 16, torch.float32, device=CPU)
    st, cv = cache["ssm"]
    assert st.shape[:3] == (2, 2, 2) and st.dtype == torch.float32
    st[0, 1].fill_(1.0)
    cache["shared"]["k"][1].fill_(1.0)
    assert float(st.sum()) == st[0, 1].numel()
    assert float(cache["shared"]["k"][0].abs().max()) == 0.0
    assert float(cache["shared"]["v"].abs().max()) == 0.0


def test_hybrid_slot_copy_uses_batch_axis_2():
    cfg = get_smoke("zamba2-2.7b")
    params = init_params(cfg, seed=4, device="cpu")
    eng = ServeEngine(params, cfg, batch_size=3, max_len=32, device=CPU)
    prompt = np.arange(6, dtype=np.int32) + 2
    eng.submit(Request(rid=0, prompt=prompt, max_new=3))
    eng.submit(Request(rid=1, prompt=prompt[::-1].copy(), max_new=3))
    eng._fill_free_slots()
    for slot, p in ((0, prompt), (1, prompt[::-1].copy())):
        _, one = lm.prefill(params, cfg, {"tokens": torch.from_numpy(p)[None]},
                            32, torch.float32)
        assert torch.equal(eng.cache["ssm"][0][:, :, slot],
                           one["ssm"][0][:, :, 0])
        assert torch.equal(eng.cache["ssm"][1][:, :, slot],
                           one["ssm"][1][:, :, 0])
        assert torch.equal(eng.cache["shared"]["k"][:, slot],
                           one["shared"]["k"][:, 0])
    assert float(eng.cache["ssm"][0][:, :, 2].abs().max()) == 0.0
