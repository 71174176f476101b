"""The port's training math against the JAX reference on the CPU.

One parameter tree (the port's seeded init drawn on the CPU, the
reference's layout) and one batch made from a numpy seed go through both
packages in float32: ``_xent`` on bf16 and float32 logits; ``loss_fn``
and every gradient leaf against ``jax.value_and_grad(repro.models.
loss_fn)`` for the 10 assigned smoke configs (experts at the no-drop
capacity factor, deepseek's MTP term included), each leaf within 1e-4 of
its largest magnitude; ``cosine_schedule``; ``AdamW.update`` from one
``(params, grads, m, v, step)`` with float32 and bfloat16 state (the
parameters within 1e-5; bfloat16 moments within one bfloat16 ulp);
``SyntheticLM`` batches bit-equal, frames included; and two steps of
``make_train_step`` with 1 and 4 microbatches (metrics within 1e-5, the
parameters within a tenth of the learning rate).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.configs.registry import ASSIGNED
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine_schedule
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke
from repro_torch.data import SyntheticLM
from repro_torch.models import lm, loss_fn, opt_state_from_reference
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import make_train_step

B, S = 4, 16
GRAD_RTOL = 1e-4          # of each gradient leaf's largest magnitude


def nodrop(arch):
    """``L.model`` kwargs for the no-drop capacity factor of an experts
    config (the reference's ``test_models.nodrop``), none otherwise."""
    moe = get_smoke(arch).moe
    return {"moe": dataclasses.replace(moe, capacity_factor=16.0)} if moe \
        else {}


def batch(cfg, seed=0, b=B):
    s = L.seq_len(cfg, S)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.enc_layers:
        out["frames"] = (0.1 * rng.standard_normal(
            (b, s + 5, cfg.d_model))).astype(np.float32)
    return out


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_matches_reference(dtype):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jl.astype(jnp.float32)),
                          tl.float().numpy())      # same rounded inputs
    want = jlm._xent(jl, jnp.asarray(labels))
    got = lm._xent(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # The cotangent keeps the logits' dtype, as the reference's.
    tl.requires_grad_(True)
    lm._xent(tl, torch.from_numpy(labels)).backward()
    jg = jax.grad(lambda x: jlm._xent(x, jnp.asarray(labels)))(jl)
    assert tl.grad.dtype == tl.dtype and jg.dtype == jl.dtype
    np.testing.assert_allclose(tl.grad.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5,
                               atol=1e-7)


def grads_close(got, want):
    """Every leaf of a port gradient tree within ``GRAD_RTOL`` of the
    reference leaf's largest magnitude, leaf for leaf."""
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = list(lm.tree_leaves(got))
    assert len(jl) == len(tl)
    for (path, a), t in zip(jl, tl):
        a = np.asarray(a, np.float32)
        assert tuple(t.shape) == a.shape, path
        err = float(np.abs(t.detach().float().numpy() - a).max())
        assert err <= GRAD_RTOL * float(np.abs(a).max()), (path, err)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_loss_and_gradients_match_reference(arch):
    jcfg, jp, cfg, tp = L.model(arch, ref_init=False, **nodrop(arch))
    b = batch(cfg)
    (jloss, jmet), jgrads = jax.jit(
        jax.value_and_grad(jlm.loss_fn, has_aux=True), static_argnums=1)(
            jp, jcfg, as_jax(b))
    live = lm.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, met = loss_fn(live, cfg, as_torch(b))
    loss.backward()
    assert set(met) == set(jmet)
    assert ("mtp_ce" in met) == bool(cfg.mtp)
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6)
    grads_close(lm.tree_map(lambda t: t.grad if t.grad is not None
                            else torch.zeros_like(t), live), jgrads)


def test_remat_changes_no_gradient():
    # cfg.remat recomputes each cycle in the backward pass: the same loss
    # and gradients, bit for bit, as without it.
    out = []
    for remat in (True, False):
        _, _, cfg, tp = L.model("zamba2-2.7b", ref_init=False, remat=remat)
        live = lm.tree_map(lambda t: t.clone().requires_grad_(True), tp)
        loss, _ = loss_fn(live, cfg, as_torch(batch(cfg)))
        loss.backward()
        out.append([loss] + [t.grad for t in lm.tree_leaves(live)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_cosine_schedule_matches_reference():
    for warmup, total in ((0, 10), (5, 40), (20, 60)):
        want = jcosine_schedule(3e-4, warmup, total)
        got = cosine_schedule(3e-4, warmup, total)
        for step in range(0, total + 5):
            np.testing.assert_allclose(
                float(got(torch.tensor(step, dtype=torch.int32))),
                float(want(jnp.int32(step))), rtol=1e-6, atol=0)


def _opt_inputs(state_dtype, seed=3):
    """A parameter tree of matrices, vectors and a scalar-sized leaf, its
    gradients and a mid-run AdamW state, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "s": {"k": (2, 3, 4), "n": (4,)}}
    mk = lambda scale: jax.tree.map(
        lambda sh: (scale * rng.standard_normal(sh)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, grads = mk(0.5), mk(3.0)          # gnorm > 1: clipped
    m, v = mk(0.1), jax.tree.map(np.abs, mk(0.01))
    sdt = jnp.dtype(state_dtype)
    m, v = (jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(sdt)), t)
            for t in (m, v))
    return params, grads, {"m": m, "v": v, "step": np.int32(7)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    params, grads, state = _opt_inputs(state_dtype)
    kw = dict(weight_decay=0.1, clip_norm=1.0, state_dtype=state_dtype)
    jopt = JAdamW(lr=jcosine_schedule(1e-3, 5, 40), **kw)
    opt = AdamW(lr=cosine_schedule(1e-3, 5, 40), **kw)
    jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads),
                             jax.tree.map(jnp.asarray, state),
                             jax.tree.map(jnp.asarray, params))
    tparams = lm.tree_map(torch.from_numpy, params)
    tstate = opt_state_from_reference(state, tparams)
    p, s, m = opt.update(lm.tree_map(torch.from_numpy, grads), tstate,
                         tparams)
    assert int(s["step"]) == int(js["step"]) == 8
    assert s["step"].dtype == torch.int32
    for k in ("gnorm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    for t, a in zip(lm.tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    ulp = 2.0 ** -7 if state_dtype == "bfloat16" else 1e-5
    for name in ("m", "v"):
        for t, a in zip(lm.tree_leaves(s[name]), jax.tree.leaves(js[name])):
            assert t.dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(a.astype(jnp.float32)),
                rtol=ulp, atol=1e-30)
    # The inputs are left as they were.
    for t, a in zip(lm.tree_leaves(tparams), jax.tree.leaves(params)):
        assert np.array_equal(t.numpy(), a)


def test_adamw_init_and_weight_decay_on_matrices_only():
    params = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    opt = AdamW(lr=lambda step: torch.tensor(0.5), weight_decay=0.5,
                state_dtype="bfloat16")
    st = opt.init(params)
    assert st["m"]["w"].dtype == torch.bfloat16 and int(st["step"]) == 0
    zero = lm.tree_map(torch.zeros_like, params)
    p, st, _ = opt.update(zero, st, params)
    assert torch.equal(p["b"], params["b"])               # no decay
    assert torch.allclose(p["w"], torch.full((3, 2), 0.75))  # 1 - .5 * .5


@pytest.mark.parametrize("frames_dim", [0, 24])
def test_synthetic_batches_equal_the_reference(frames_dim):
    for seed, step in ((0, 0), (3, 17), (11, 2 ** 20)):
        kw = dict(vocab=1000, seq_len=33, global_batch=6, seed=seed,
                  frames_dim=frames_dim)
        want, got = JSyntheticLM(**kw), SyntheticLM(**kw)
        for a, b in ((want.batch_at(step), got.batch_at(step)),
                     (want.batch_at(step, 2, 5), got.batch_at(step, 2, 5)),
                     (want.host_slice(step, 1, 3),
                      got.host_slice(step, 1, 3))):
            assert set(a) == set(b) == ({"tokens", "labels", "frames"}
                                        if frames_dim else
                                        {"tokens", "labels"})
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_steps_match_reference(microbatches):
    jcfg, jp, cfg, tp = L.model("repro-100m", ref_init=False)
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(lr=jcosine_schedule(1e-3, 1, 10), **kw)
    opt = AdamW(lr=cosine_schedule(1e-3, 1, 10), **kw)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, microbatches))
    step = make_train_step(cfg, opt, microbatches)
    js, ts = jopt.init(jp), opt.init(tp)
    for i in range(2):
        b = batch(cfg, seed=i, b=8)
        jp, js, jm = jstep(jp, js, as_jax(b))
        tp2, ts, m = step(tp, ts, as_torch(b))
        assert tp2 is not tp
        tp = tp2
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    # A tenth of the learning rate: Adam's normalised step turns the
    # ulp-level difference of a gradient element near 0 (a few of the
    # embedding's, summed over microbatches in another order) into a
    # percent-level difference of that element's step.
    for t, a in zip(lm.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-4)
