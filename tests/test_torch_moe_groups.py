"""The grouped MoE dispatch against the JAX reference on the CPU.

With sharding rules installed, both packages split the tokens into one
dispatch group per data shard (``_dispatch_groups``: the pod x data
extent when it divides the token count), each with its own capacity.  The
rules are given a stand-in mesh of (ng, 2) (the reference's also places
every constraint on its one CPU device), so both run ``ng`` groups on one
device: ``moe_block`` at ng = 2 and 4, with and without drops, and
deepseek-v3's smoke ``loss_fn`` with every gradient leaf at ng = 4, from
one tree given to both packages (helpers in ``tests/_torch_lm.py``).
Without rules the port runs one group.  Tolerance: 1e-4 (the gradients:
of each leaf's largest magnitude).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import SingleDeviceSharding

import _torch_lm as L
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.parallel import Rules as JRules
from repro.parallel.context import use_rules as juse_rules
from repro_torch.configs import get_smoke
from repro_torch.models import common as cm
from repro_torch.models import lm, loss_fn, moe
from repro_torch.parallel import Rules
from repro_torch.parallel.context import use_rules

ARCH = "deepseek-v3-671b"


def rules_pair(ng):
    """The reference's and the port's rules on a stand-in (ng, 2) mesh;
    the reference's place every constraint on its one CPU device."""
    names = ("data", "model")
    jr = JRules(types.SimpleNamespace(axis_names=names,
                                      devices=np.empty((ng, 2))))
    dev = SingleDeviceSharding(jax.devices()[0])
    jr.sharding = lambda shape, axes: dev
    r = Rules(types.SimpleNamespace(mesh_dim_names=names, shape=(ng, 2)))
    return jr, r


def moe_case(cf, seed=5):
    base = get_smoke(ARCH)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    p = lm.tree_map(lambda t: t.numpy(),
                    moe.init_moe(cm.Init(seed, device="cpu"), cfg))
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("ng", [2, 4])
@pytest.mark.parametrize("drops", [True, False])
def test_grouped_moe_block_matches_reference(ng, drops):
    e = get_smoke(ARCH).moe
    cfg, p, x = moe_case(0.25 if drops else e.n_experts / e.top_k)
    jp = jax.tree.map(jnp.asarray, p)
    tp = lm.tree_map(lambda a: torch.from_numpy(np.array(a)), p)
    tx = torch.from_numpy(x)
    t = x.shape[0] * x.shape[1]
    one, _ = moe.moe_block(tp, tx, cfg)
    jr, r = rules_pair(ng)
    with juse_rules(jr):
        assert jmoe._dispatch_groups(t) == ng
        want, jaux = jmoe.moe_block(jp, jnp.asarray(x), cfg)
    with use_rules(r):
        assert moe._dispatch_groups(t) == ng
        got, aux = moe.moe_block(tp, tx, cfg)
        # Each group's slots, from its own tokens: some drop only when the
        # per-group capacity is short.
        _, _, expert = moe.route(tp, tx.reshape(t, -1), cfg)
        _, keep = moe.assign_slots(expert.reshape(ng, -1), e.n_experts,
                                   moe._group_capacity(t, ng, cfg))
        assert bool((~keep).any()) == drops
    L.close(got, want)
    L.close(aux, jaux)
    if drops:        # the grouping changes which assignments drop
        assert float((got - one).abs().max()) > 1e-3


def test_grouping_needs_rules_and_divisible_tokens():
    _, r = rules_pair(4)
    assert moe._dispatch_groups(48) == 1
    with use_rules(r):
        assert moe._dispatch_groups(48) == 4
        assert moe._dispatch_groups(50) == 1        # 4 does not divide 50
    with use_rules(Rules(types.SimpleNamespace(
            mesh_dim_names=("pod", "data", "model"), shape=(2, 2, 2)))):
        assert moe._dispatch_groups(48) == 4        # pod x data


def test_grouped_loss_and_gradients_match_reference():
    jcfg, jp, cfg, tp = L.model(ARCH, ref_init=False)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jr, r = rules_pair(4)
    with juse_rules(jr):
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            jlm.loss_fn, has_aux=True), static_argnums=1)(
                jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    live = lm.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    with use_rules(r):      # remat recomputes in the backward: under them
        loss, met = loss_fn(live, cfg,
                            {k: torch.from_numpy(v) for k, v in b.items()})
        loss.backward()
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6)
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tl = [t.grad if t.grad is not None else torch.zeros_like(t)
          for t in lm.tree_leaves(live)]
    assert len(jl) == len(tl)
    for (path, a), g in zip(jl, tl):
        a = np.asarray(a, np.float32)
        err = float(np.abs(g.float().numpy() - a).max())
        assert err <= 1e-4 * float(np.abs(a).max()), (path, err)
    # The same tree without rules: one group, another loss.
    one, _ = loss_fn(tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(one) != float(loss)
