"""Shared helpers of the LM parity tests (``tests/test_torch_lm*.py``):
a smoke config's parameters given to both packages, and the forward (with
its aux loss) / prefill (with its caches) / decode / init checks each
file runs on its archs.  Tolerance: rtol 1e-4, atol 1e-4 (float32 on the
CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_smoke
from repro_torch.models import (decode_step, forward, init_params,
                                param_count, params_from_reference, prefill)
from repro_torch.models import lm

RTOL = ATOL = 1e-4
B, S, MAX_LEN = 2, 24, 40
# The leaves ``param_count`` counts: every matrix (attention, MLA, dense
# and expert feed-forward, router, SSM projections and conv) and the
# SSM's two drawn per-head leaves; norm scales, biases, D and the MTP
# subtree are left out of it, as in the reference.
MATRICES = {"embed", "head", "wq", "wk", "wv", "wo", "wg", "wu", "wd",
            "wdq", "wuq", "wdkv", "wkr", "wuk", "wuv", "router", "in_proj",
            "conv_w", "out_proj", "A_log", "dt_bias"}

_MODELS = {}


def model(arch, *, ref_init=True, **replace):
    """(reference cfg, reference params, port cfg, port params) of an
    arch's smoke config, memoised.  The tree is the reference's own
    ``init_params(cfg, jax.random.key(0))``, or with ``ref_init=False``
    the port's seeded init drawn on the CPU (the reference's layout and
    scales, the SSM's ``A_log``/``dt_bias`` its exact values): the
    reference's eager init compiles every new leaf shape, ~35 s for
    deepseek's smoke config on one core."""
    key = (arch, ref_init, tuple(sorted(replace.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jget_smoke(arch), **replace)
        cfg = dataclasses.replace(get_smoke(arch), **replace)
        if ref_init:
            jp, _ = jinit_params(jcfg, jax.random.key(0))
            tree = jax.tree.map(np.asarray, jp)
        else:
            tree = lm.tree_map(lambda t: t.numpy(),
                               init_params(cfg, seed=0, device="cpu"))
            jp = jax.tree.map(jnp.asarray, tree)
        tp = params_from_reference(tree, cfg, device="cpu")
        _MODELS[key] = (jcfg, jp, cfg, tp)
    return _MODELS[key]


def seq_len(cfg, s=S):
    """``s`` rounded up to the SSM chunk: the reference's chunked SSD
    takes whole chunks (the model is causal, so a right pad leaves the
    real positions as they are)."""
    ck = cfg.ssm.chunk if cfg.ssm else 1
    return -(-s // ck) * ck


def ref_shapes(jcfg):
    """The reference's parameter shapes, traced without drawing them."""
    tree = jax.eval_shape(lambda k: jinit_params(jcfg, k)[0],
                          jax.random.key(0))
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def tokens(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def check_forward(arch, seed=0, ref_init=True, **replace):
    """Logits and the aux loss (the experts' balance term; 0 without
    experts) of ``forward`` against the reference's."""
    jcfg, jp, cfg, tp = model(arch, ref_init=ref_init, **replace)
    s = seq_len(cfg)
    toks = tokens(cfg, s=s, seed=seed)
    want, jaux = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          train=False)
    got, aux = forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, s, cfg.vocab) and got.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    assert (float(aux) > 0) == bool(cfg.moe)
    close(got, want)
    close(aux, jaux)


def leaves_close(got, want):
    """Every leaf of a port cache tree against the reference's, in the
    same order (dict keys sorted, tuples in order) and of equal shapes."""
    jl, tl = jax.tree.leaves(want), list(lm.tree_leaves(got))
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    for t, a in zip(tl, jl):
        close(t, a)


def prefill_both(arch, ref_init=True):
    jcfg, jp, cfg, tp = model(arch, ref_init=ref_init)
    toks = tokens(cfg, seed=1)
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                      max_len=MAX_LEN, cache_dtype=jnp.float32)
    tl, tc = prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                     max_len=MAX_LEN, cache_dtype=torch.float32)
    return (jcfg, jp, jl, jc), (cfg, tp, tl, tc)


def check_prefill_and_decode(arch, ref_init=True):
    """``prefill``'s last logits and every cache leaf (K/V, MLA's latent
    and rotated key, the dense prefix's, SSM states and conv buffers),
    then four ``decode_step``s at per-row positions (row 1 rewinds 5
    positions and overwrites them) and the caches after them.  The
    reference's decode step runs jitted (one compile for the four)."""
    (jcfg, jp, jl, jc), (cfg, tp, tl, tc) = prefill_both(arch, ref_init)
    close(tl, jl)
    leaves_close(tc, jc)
    jdecode = jax.jit(jdecode_step, static_argnums=1)
    pos = np.array([S, S - 5], np.int32)
    tok = np.array([3, 5], np.int32)
    for _ in range(4):
        jl, jc = jdecode(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc2 = decode_step(tp, cfg, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
        assert tc2 is tc                      # updated in place
        close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        pos = pos + 1
    leaves_close(tc, jc)


def check_init(arch, ref_init=True):
    """The port's own init: the reference's shapes, the analytic count of
    its matrices (``MATRICES``), and the same values from the same seed."""
    jcfg, _, cfg, _ = model(arch, ref_init=ref_init)
    tp = init_params(cfg, seed=3, device="cpu")
    assert lm.tree_map(lambda t: tuple(t.shape), tp) == ref_shapes(jcfg)
    n = 0
    stack = [(None, tp)]
    while stack:
        name, node = stack.pop()
        if isinstance(node, dict) and name != "mtp":
            stack += list(node.items())
        elif name in MATRICES:
            n += node.numel()
    assert n == param_count(cfg)["total"]
    again = init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(lm.tree_leaves(tp),
                                                 lm.tree_leaves(again)))
