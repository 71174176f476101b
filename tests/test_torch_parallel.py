"""The port's sharding rules, logical axes and dry-run specs against the
JAX reference on the CPU.

Both packages' ``Rules`` read only a mesh's axis names and extents, so
each is given a stand-in mesh of the production or test shape (the
reference's ``axis_names``/``devices``, the port's
``mesh_dim_names``/``shape``): specs resolve at full size with no devices.
For every ``ASSIGNED`` arch, full and smoke config, on (4, 2), (2, 2, 2),
(16, 16) and (2, 16, 16), with FSDP on and off and with sequence
parallelism: every parameter leaf's spec and the fallbacks logged equal
the reference's.  The axes tree and meta shapes equal the reference's
``jax.eval_shape`` of ``init_params``; ``cache_axes`` and
``make_batch_specs`` equal the reference's.  Also the reference's five
rules tests (``tests/test_substrate.py``) on the port's ``Rules``, the
placements a spec resolves to, and ``constrain`` as a no-op.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.registry import ASSIGNED
from repro.data.pipeline import make_batch_specs as jmake_batch_specs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models.lm import cache_axes as jcache_axes
from repro.parallel import Rules as JRules
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import make_batch_specs
from repro_torch.models import init_cache, lm
from repro_torch.parallel import (DEFAULT_RULES, Rules, tree_shardings,
                                  tree_specs)
from repro_torch.parallel import context
from repro_torch.parallel.rules import tree_pairs

MESHES = [((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def port_mesh(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def ref_abstract(jcfg):
    """The reference dry-run's ``abstract_params``: (shapes, axes)."""
    captured = {}

    def f(key):
        p, a = jinit_params(jcfg, key)
        captured["axes"] = a
        return p

    return jax.eval_shape(f, jax.random.key(0)), captured["axes"]


def ref_pairs(shapes, axes):
    """(shape, axes) of every reference leaf, in the port's leaf order
    (jax flattens dicts in sorted key order, as ``tree_pairs`` walks)."""
    flat, treedef = jax.tree.flatten(shapes)
    return [(tuple(s.shape), a) for s, a in
            zip(flat, treedef.flatten_up_to(axes))]


def port_pairs(tree, axes):
    return [(tuple(t.shape), a) for t, a in tree_pairs(tree, axes)]


def configs(arch):
    return [(jget_config(arch), get_config(arch)),
            (jget_smoke(arch), get_smoke(arch))]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_axes_tree_and_meta_shapes_equal_reference(arch):
    for jcfg, cfg in configs(arch):
        shapes, axes = ref_abstract(jcfg)
        params, paxes = lm.abstract_params(cfg)
        assert port_pairs(params, paxes) == ref_pairs(shapes, axes)
        assert all(t.device.type == "meta" and t.dtype == torch.float32
                   for t in lm.tree_leaves(params))
        assert lm.param_axes(cfg) == paxes


@pytest.mark.parametrize("arch", ASSIGNED)
def test_rules_specs_and_fallbacks_equal_reference(arch):
    for jcfg, cfg in configs(arch):
        pairs = ref_pairs(*ref_abstract(jcfg))
        for shape, names in MESHES:
            for kw in ({}, {"fsdp": False}, {"seq_parallel": True}):
                jr = JRules(ref_mesh(shape, names), **kw)
                r = Rules(port_mesh(shape, names), **kw)
                for s, a in pairs:
                    assert r.spec(s, a) == tuple(jr.spec(s, a)), (s, a, kw)
                assert r.fallbacks == jr.fallbacks


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_axes_and_specs_equal_reference(arch):
    for jcfg, cfg in configs(arch):
        assert lm.cache_axes(cfg) == jcache_axes(jcfg)
        jc = jax.eval_shape(lambda: jinit_cache(jcfg, 8, 64, jnp.bfloat16))
        pairs = ref_pairs(jc, jcache_axes(jcfg))
        cache = init_cache(cfg, 8, 64, device="meta")
        assert port_pairs(cache, lm.cache_axes(cfg)) == pairs
        for shape, names in MESHES:
            jr, r = JRules(ref_mesh(shape, names)), Rules(port_mesh(shape,
                                                                    names))
            assert [r.spec(s, a) for s, a in pairs] == [
                tuple(jr.spec(s, a)) for s, a in pairs]


@pytest.mark.parametrize("arch", ["internlm2-20b", "seamless-m4t-medium"])
def test_make_batch_specs_equal_reference(arch):
    for jcfg, cfg in configs(arch):
        js, ja = jmake_batch_specs(jcfg, 128, 16)
        s, a = make_batch_specs(cfg, 128, 16)
        assert a == ja and set(s) == set(js)
        for k in s:
            assert tuple(s[k].shape) == tuple(js[k].shape)
            assert s[k].device.type == "meta"
            assert str(s[k].dtype).split(".")[-1] == str(js[k].dtype)


# --- the reference's rules tests (tests/test_substrate.py) -----------------

def _mesh22():
    return Rules(port_mesh((16, 16), ("data", "model")))


def test_rules_basic_tp_fsdp():
    r = _mesh22()
    assert r.spec((92544, 6144), ("vocab", "embed")) == ("model", "data")
    assert r.spec((48, 6144, 48, 128), ("layers", "embed", "heads", None)) \
        == (None, "data", "model", None)


def test_rules_divisibility_fallback():
    r = _mesh22()
    # qwen: 40 heads % 16 != 0 -> replicated, fallback recorded
    assert r.spec((5120, 40, 128), ("embed", "heads", None)) == (
        "data", None, None)
    assert any(f[2] == "heads" for f in r.fallbacks)


def test_rules_exclusivity():
    # two model-eligible axes: first in priority wins, second replicates
    assert _mesh22().spec((256, 16384), ("experts", "d_ff")) == ("model",
                                                                 None)


def test_rules_kv_seq_fallback_for_cache():
    # kv_heads=8 on model=16 -> kv_seq gets the model axis instead
    assert _mesh22().spec((48, 128, 32768, 8, 128),
                          ("layers", "batch", "kv_seq", "kv_heads", None)) \
        == (None, "data", "model", None, None)


def test_rules_batch_pod_data():
    r = Rules(port_mesh((2, 16, 16), ("pod", "data", "model")))
    assert r.spec((256, 4096), ("batch", None)) == (("pod", "data"), None)


# --- placements, trees, the context ----------------------------------------

def test_placements_one_per_mesh_dim():
    r = Rules(port_mesh((2, 16, 16), ("pod", "data", "model")))
    # batch over the (pod, data) group, heads over model
    assert r.sharding((256, 4096, 48, 128),
                      ("batch", None, "heads", None)) == (
        Shard(0), Shard(0), Shard(2))
    # FSDP embed on data, vocab on model, pod replicated
    assert r.sharding((92544, 6144), ("vocab", "embed")) == (
        Replicate(), Shard(1), Shard(0))
    assert r.sharding((5120, 40, 128), ("embed", "heads", None)) == (
        Replicate(), Shard(0), Replicate())
    assert r.sharding((), ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="rank"):
        r.spec((4, 4), ("batch",))


def test_tree_specs_walk_tuples_and_dicts():
    cfg = get_smoke("zamba2-2.7b")
    cache = init_cache(cfg, 8, 64, device="meta")
    axes = lm.cache_axes(cfg)
    mesh = port_mesh((4, 2), ("data", "model"))
    specs = tree_specs(mesh, cache, axes)
    shards = tree_shardings(mesh, cache, axes)
    assert isinstance(specs["ssm"], tuple) and len(specs["ssm"]) == 2
    r = Rules(mesh, DEFAULT_RULES)
    got = list(zip(tree_pairs(cache, axes), tree_pairs(cache, specs),
                   tree_pairs(cache, shards)))
    assert len(got) == 4
    for (t, a), (_, s), (_, pl) in got:
        assert s == r.spec(t.shape, a) and pl == r.sharding(t.shape, a)
    assert specs["ssm"][0][2] == "data"          # the state's batch dim


def test_constrain_is_a_no_op_without_rules_or_dtensors():
    x = torch.ones(8, 4)
    assert context.current_rules() is None
    assert context.constrain(x, ("batch", None)) is x
    r = Rules(port_mesh((4, 2), ("data", "model")))
    with context.use_rules(r):
        assert context.current_rules() is r
        assert context.constrain(x, ("batch", None)) is x   # not a DTensor
    assert context.current_rules() is None
