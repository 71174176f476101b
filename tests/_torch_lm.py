"""Shared helpers of the LM parity tests (``tests/test_torch_lm*.py``):
the reference's smoke-config parameters carried into the port, and the
forward / prefill / decode / init checks each file runs on its archs.
Tolerance: rtol 1e-4, atol 1e-4 (float32 on the CPU).
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
MATRICES = {"embed", "head", "wq", "wk", "wv", "wo", "wg", "wu", "wd"}

_MODELS = {}


def model(arch, **replace):
    """(reference cfg, reference params, port cfg, port params) of an
    arch's smoke config, memoised."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jget_smoke(arch), **replace)
        cfg = dataclasses.replace(get_smoke(arch), **replace)
        jp, _ = jinit_params(jcfg, jax.random.key(0))
        tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg)
        _MODELS[key] = (jcfg, jp, cfg, tp)
    return _MODELS[key]


def tokens(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def check_forward(arch, seed=0, **replace):
    jcfg, jp, cfg, tp = model(arch, **replace)
    toks = tokens(cfg, seed=seed)
    want, _ = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)}, train=False)
    got, aux = forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    close(got, want)


def prefill_both(arch):
    jcfg, jp, cfg, tp = model(arch)
    toks = tokens(cfg, seed=1)
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                      max_len=MAX_LEN, cache_dtype=jnp.float32)
    tl, tc = prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                     max_len=MAX_LEN, cache_dtype=torch.float32)
    return (jcfg, jp, jl, jc), (cfg, tp, tl, tc)


def check_prefill_and_decode(arch):
    """``prefill``'s last logits and cache, then four ``decode_step``s at
    per-row positions (row 1 rewinds 5 positions and overwrites them)."""
    (jcfg, jp, jl, jc), (cfg, tp, tl, tc) = prefill_both(arch)
    close(tl, jl)
    assert sorted(tc["layers"]) == sorted(jc["layers"])
    for name, kv in jc["layers"].items():
        for kk in ("k", "v"):
            got = tc["layers"][name][kk]
            assert got.shape == kv[kk].shape == (
                cfg.n_cycles, B, MAX_LEN, cfg.n_kv_heads, cfg.hd)
            close(got, kv[kk])
    pos = np.array([S, S - 5], np.int32)
    tok = np.array([3, 5], np.int32)
    for _ in range(4):
        jl, jc = jdecode_step(jp, jcfg, jc, jnp.asarray(tok),
                              jnp.asarray(pos))
        tl, tc2 = decode_step(tp, cfg, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
        assert tc2 is tc                      # updated in place
        close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        pos = pos + 1
    for name, kv in jc["layers"].items():
        for kk in ("k", "v"):
            close(tc["layers"][name][kk], kv[kk])


def check_init(arch):
    """The port's own init: the reference's shapes, the analytic count of
    its matrices (norm scales and biases are left out of it, as in the
    reference), and the same values from the same seed."""
    jcfg, jp, cfg, _ = model(arch)
    tp = init_params(cfg, seed=3)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert lm.tree_map(lambda t: tuple(t.shape), tp) == shapes
    n = 0
    stack = [(None, tp)]
    while stack:
        name, node = stack.pop()
        if isinstance(node, dict):
            stack += list(node.items())
        elif name in MATRICES:
            n += node.numel()
    assert n == param_count(cfg)["total"]
    again = init_params(cfg, seed=3)
    assert all(torch.equal(a, b) for a, b in zip(lm.tree_leaves(tp),
                                                 lm.tree_leaves(again)))
