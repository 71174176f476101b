"""The port's attention-family LM against the JAX reference on the CPU.

For each smoke config whose layers are all attention (kinds ``a`` and
``l``), the reference's ``init_params(cfg, jax.random.key(0))`` tree is
carried into the port (``params_from_reference``) and the same tokens,
made from a numpy seed, go through both packages in float32: ``forward``
logits, ``prefill``'s last logits and its cache K/V, and four
``decode_step``s at per-row positions (helpers in ``tests/_torch_lm.py``;
this file takes repro-100m, internlm2-20b and gemma2-27b,
``test_torch_lm_archs.py`` the other three).  ``chunked_attention`` is
held against the reference over window, softcap and KV padding, the norms
and rotary embedding on their own, the configs and parameter counts of
every registered arch.  Tolerance: rtol 1e-4, atol 1e-4.  The
experts/MLA, SSM/hybrid and encoder-decoder families are held in
``test_torch_lm_moe.py``, ``test_torch_lm_ssm.py`` and
``test_torch_lm_encdec.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs import list_archs as jlist_archs
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import param_count as jparam_count
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.models import param_count, params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import common as cm

ARCHS = ("repro-100m", "internlm2-20b", "gemma2-27b")
close = L.close


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    L.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    L.check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes_and_count(arch):
    L.check_init(arch)


@pytest.mark.parametrize("causal,window,cap,bk,t", [
    (True, 0, 0.0, 1024, 24), (True, 0, 0.0, 8, 24), (True, 5, 0.0, 7, 24),
    (True, 0, 30.0, 10, 24), (True, 6, 50.0, 16, 20), (False, 0, 0.0, 5, 17),
    (False, 0, 20.0, 6, 13)])
def test_chunked_attention_matches_reference(causal, window, cap, bk, t):
    rng = np.random.default_rng(t + bk)
    q = rng.standard_normal((2, t, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, cap=cap, bk=bk)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = attn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw)
    close(got, want)


def test_chunked_attention_explicit_positions_match_reference():
    # Explicit KV positions with padding: the pad slots sit at 2**30.
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 11, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 11, 2, 8)).astype(np.float32)
    qpos = np.arange(20, 25)
    kpos = np.arange(14, 25)
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=8, bk=4, kv_positions=jnp.asarray(kpos),
        q_positions=jnp.asarray(qpos))
    got = attn.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=8, bk=4, kv_positions=torch.from_numpy(kpos),
        q_positions=torch.from_numpy(qpos))
    close(got, want)


@pytest.mark.parametrize("frac,theta", [(1.0, 1e4), (0.25, 1e4), (1.0, 1e6),
                                        (0.5, 5e5)])
def test_norms_and_rope_match_reference(frac, theta):
    rng = np.random.default_rng(int(theta) % 97)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32) * 0.1
    b = rng.standard_normal((16,)).astype(np.float32) * 0.1
    pos = np.arange(7) + 5
    tx = torch.from_numpy(x)
    close(cm.apply_rope(tx, torch.from_numpy(pos), frac, theta),
          jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), frac, theta))
    close(cm.rms_norm(tx, torch.from_numpy(w)),
          jcm.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    close(cm.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b)),
          jcm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    close(cm.softcap(tx * 40, 30.0), jcm.softcap(jnp.asarray(x) * 40, 30.0))


@pytest.mark.parametrize("arch", sorted(jlist_archs()))
def test_configs_and_param_count_match_reference(arch):
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert param_count(cfg) == jparam_count(jcfg)
    assert list_archs() == jlist_archs()
    assert list_archs(True) == jlist_archs(True)


def test_params_from_reference_checks_the_tree():
    jcfg, jp, cfg, _ = L.model("repro-100m")
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError):
        params_from_reference(tree, get_smoke("gemma2-27b"))
    with pytest.raises(ValueError):
        params_from_reference(dict(tree, head=tree["embed"].T), cfg)
