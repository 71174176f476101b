"""The plain LM reference against the program's plain CPU path, at the
internlm2 smoke widths on seeded float32 weights: its logits are the
program's ``forward``'s, and its prefill's and its decode steps' through
the cache, to a relative L2 error of 1e-5 at every position (the
statistic the cell compares; the weights' spread of 0.2 makes the logits
spread by ~2, so attention and every layer move them); and the drawn
weights are the program's tree."""
from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from cabench import harness
from cabench.drivers import lm_serve
from cabench.reference import lm_dense

sys.path.insert(0, str(harness.ROOT / "src"))
TOL = 1e-5
SMOKE = {"arch": "internlm2-20b", "n_layers": 4, "d_model": 128,
         "n_heads": 8, "n_kv_heads": 2, "head_dim": 16, "d_ff": 256,
         "vocab": 512, "rope_theta": 1e6, "norm_eps": 1e-5,
         "dtype": "float32", "init_std": 0.2, "norm_std": 0.1}


def _weights(seed):
    wt = lm_serve.draw_weights(SMOKE, seed, torch.device("cpu"))
    return wt, lm_serve.program_tree(wt), lm_serve.model_cfg(SMOKE)


def _close(got, ref):
    err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert float(err.max()) <= TOL, err


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, SMOKE["vocab"], n)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 2 ** 40 + 3])
def test_reference_is_the_programs_forward(seed):
    from repro_torch.models import lm
    wt, tree, cfg = _weights(seed)
    toks = _tokens(seed, 37)
    got, _ = lm.forward(tree, cfg, {"tokens": torch.as_tensor(toks)[None]})
    (ref,) = lm_dense.logits(wt, SMOKE, [toks], [0])
    assert ref.std() > 1.0
    _close(got[0], ref)


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_reference_is_the_programs_prefill_and_decode(seed):
    from repro_torch.models import decode_step, prefill
    wt, tree, cfg = _weights(seed)
    toks = _tokens(seed, 30)
    s = 21
    last, cache = prefill(tree, cfg,
                          {"tokens": torch.as_tensor(toks[:s])[None]},
                          max_len=32, cache_dtype=torch.float32)
    got = [last[0]]
    for p in range(s, len(toks)):
        logits, cache = decode_step(tree, cfg, cache,
                                    torch.as_tensor(toks[p:p + 1]), p)
        got.append(logits[0])
    (ref,) = lm_dense.logits(wt, SMOKE, [toks], [s - 1])
    _close(torch.stack(got), ref)


def test_rotary_turns_pairs_by_position_and_theta():
    x = torch.zeros(3, 1, 4, dtype=torch.float64)
    x[..., 0] = 1.0             # pair 0 is (dim 0, dim 2)
    y = lm_dense.rotary(x, 100.0)
    assert torch.allclose(y[:, 0, 0], torch.cos(torch.arange(3.0,
                                                dtype=torch.float64)))
    assert torch.allclose(y[:, 0, 2], torch.sin(torch.arange(3.0,
                                                dtype=torch.float64)))
    x = torch.zeros(3, 1, 4, dtype=torch.float64)
    x[..., 1] = 1.0             # pair 1 turns at 100 ** -0.5 a position
    y = lm_dense.rotary(x, 100.0)
    assert torch.allclose(y[:, 0, 3], torch.sin(torch.arange(3.0,
                                                dtype=torch.float64) / 10))


def test_drawn_weights_depend_on_the_seed_alone():
    a = lm_serve.draw_weights(SMOKE, 2 ** 31 + 9, torch.device("cpu"))
    b = lm_serve.draw_weights(SMOKE, 2 ** 31 + 9, torch.device("cpu"))
    c = lm_serve.draw_weights(SMOKE, 2 ** 31 + 10, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert {k: tuple(v.shape) for k, v in a.items()} == lm_dense.shapes(SMOKE)


@pytest.mark.parametrize("change", [{"d_model": 256}, {"rope_theta": 1e4},
                                    {"arch": "qwen2.5-14b"}])
def test_other_widths_or_parts_are_refused(change):
    cfg = dict(SMOKE, **change)
    if change.get("arch"):
        from repro_torch.configs import get_smoke
        q = get_smoke("qwen2.5-14b")
        cfg.update({k: getattr(q, k) for k in lm_serve.WIDTHS})
    with pytest.raises(harness.BenchError):
        lm_serve.model_cfg(cfg)
