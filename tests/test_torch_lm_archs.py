"""The port's attention-family LM against the JAX reference on the CPU,
for qwen2.5-14b (QKV bias), stablelm-3b (partial rotary, layer norm) and
chameleon-34b (QK norm), and for padded heads: the checks of
``tests/_torch_lm.py`` (see ``test_torch_lm.py``).  Tolerance: rtol
1e-4, atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.models import decode_step as jdecode_step
from repro_torch.models import decode_step

ARCHS = ("qwen2.5-14b", "stablelm-3b", "chameleon-34b")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    L.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    L.check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes_and_count(arch):
    L.check_init(arch)


def test_forward_with_padded_heads_matches_reference():
    # pad_heads: 8 real q-heads padded to 12 (2 KV groups of 6, 4 real).
    _, _, _, tp = L.model("internlm2-20b", pad_heads=12)
    assert tp["layers"]["0_a"]["attn"]["wq"].shape[2] == 12
    L.check_forward("internlm2-20b", seed=3, pad_heads=12)


def test_decode_scalar_position_matches_reference():
    (jcfg, jp, _, jc), (cfg, tp, _, tc) = L.prefill_both("qwen2.5-14b")
    tok = np.array([7, 9], np.int32)
    jl, _ = jdecode_step(jp, jcfg, jc, jnp.asarray(tok), L.S)
    tl, _ = decode_step(tp, cfg, tc, torch.from_numpy(tok), L.S)
    L.close(tl, jl)
