"""The port's core modules against the JAX reference, bit for bit.

Inputs are made from a seed with numpy, carried into both packages
(``repro_torch.core.carry``) and compared exactly: counter RNG, pack /
unpack / shift_x, the rule steppers for fhp2, fhp3 and bml with forcing,
offsets and batched lanes, the byte oracle, invariants and moments.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import bitplane as jbitplane
from repro.core import byte_step as jbyte
from repro.core import prng as jprng
from repro.core import rulespec as jrulespec
from repro_torch.core import bitplane, byte_step, carry, prng, rulespec

CPU = torch.device("cpu")
RULES = ("fhp2", "fhp3", "bml")


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


def to_t(a):
    return carry.planes_from_reference(np.asarray(a), CPU)


def to_np(t):
    return carry.planes_to_reference(t)


# ---------------------------------------------------------------------------
# Counter RNG.
# ---------------------------------------------------------------------------

@settings(deadline=None, max_examples=25)
@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 2 ** 20),
       st.integers(0, 2 ** 20))
def test_word_rng_matches_reference(t, y0, xw0):
    shape = (5, 7)
    for salt in (0x11, 0x22, 0x2201):
        want = np.asarray(jprng.word_u32(shape, t, salt, y0=y0, xw0=xw0))
        got = to_np(prng.word_u32(shape, t, salt, y0=y0, xw0=xw0))
        assert np.array_equal(want, got), (t, y0, xw0, salt)
    want = np.asarray(jprng.chirality_words(shape, t, y0=y0, xw0=xw0))
    assert np.array_equal(want, to_np(prng.chirality_words(
        shape, t, y0=y0, xw0=xw0)))


@pytest.mark.parametrize("p", [0.0, 0.03, 0.05, 0.5, 0.3, 1 / 131072,
                               3 / 131072, 0.999999, 1.0])
def test_bernoulli_words_and_quantize_match(p):
    assert prng.quantize_p(p) == jprng.quantize_p(p)
    want = np.asarray(jprng.bernoulli_words((6, 9), 13, p, y0=3, xw0=4))
    got = to_np(prng.bernoulli_words((6, 9), 13, p, y0=3, xw0=4))
    assert np.array_equal(want, got), p


def test_per_node_rng_matches_reference():
    shape = (6, 40)
    assert np.array_equal(
        np.asarray(jprng.chirality_bits(shape, 9, y0=5, x0=64)),
        prng.chirality_bits(shape, 9, y0=5, x0=64).numpy())
    for p in (0.0, 0.2, 1.0):
        assert np.array_equal(
            np.asarray(jprng.bernoulli(shape, 9, p, y0=5, x0=64)),
            prng.bernoulli(shape, 9, p, y0=5, x0=64).numpy()), p


def test_hash_matches_reference_on_edge_words():
    x = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0x85EBCA6B],
                 np.uint32)
    assert np.array_equal(np.asarray(jprng.hash_u32(jnp.asarray(x))),
                          to_np(prng.hash_u32(to_t(x))))


# ---------------------------------------------------------------------------
# Bit planes.
# ---------------------------------------------------------------------------

def test_pack_unpack_shift_match_reference():
    rng = np.random.default_rng(1)
    state = rng.integers(0, 256, size=(2, 6, 96), dtype=np.uint8)
    want = np.asarray(jbitplane.pack(jnp.asarray(state)))
    got = bitplane.pack(torch.from_numpy(state))
    assert np.array_equal(want, to_np(got))
    assert np.array_equal(bitplane.unpack(got).numpy(), state)
    w = words(2, (3, 5, 4))
    for dx in (-1, 0, 1):
        assert np.array_equal(
            np.asarray(jbitplane.shift_x(jnp.asarray(w), dx)),
            to_np(bitplane.shift_x(to_t(w), dx))), dx
    mask = (state[0] & 1).astype(np.uint8)
    assert np.array_equal(
        np.asarray(jbitplane.pack_bits_from_bytes(jnp.asarray(mask))),
        to_np(bitplane.pack_bits_from_bytes(torch.from_numpy(mask))))


def test_popcount_observables_match_reference():
    w = words(3, (2, 8, 6, 5))
    jw, tw = jnp.asarray(w), to_t(w)
    assert np.array_equal(np.asarray(jbitplane.density_total(jw)),
                          bitplane.density_total(tw).numpy())
    for a, b in zip(jbitplane.momentum_total(jw),
                    bitplane.momentum_total(tw)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jbitplane.row_velocity(jw)),
                          bitplane.row_velocity(tw).numpy())


# ---------------------------------------------------------------------------
# Rule steppers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", RULES)
@pytest.mark.parametrize("lanes", [(), (3,)])
def test_step_planes_rule_matches_reference(variant, lanes):
    spec, jspec = rulespec.get_rule(variant), jrulespec.get_rule(variant)
    w = words(4, lanes + (spec.n_planes, 10, 3))
    p_force = 0.0 if variant == "bml" else 0.05
    for t, y0, xw0 in ((0, 0, 0), (7, 3, 2), (2 ** 31 - 3, 1, 7)):
        want = np.asarray(jrulespec.step_planes_rule(
            jnp.asarray(w), t, jspec, p_force=p_force, y0=y0, xw0=xw0))
        got = to_np(rulespec.step_planes_rule(
            to_t(w), t, spec, p_force=p_force, y0=y0, xw0=xw0))
        assert np.array_equal(want, got), (variant, lanes, t, y0, xw0)


@pytest.mark.parametrize("variant", RULES)
def test_run_planes_rule_matches_reference(variant):
    spec, jspec = rulespec.get_rule(variant), jrulespec.get_rule(variant)
    w = words(5, (2, spec.n_planes, 8, 2))
    p_force = 0.0 if variant == "bml" else 0.3
    want = np.asarray(jrulespec.run_planes_rule(
        jnp.asarray(w), 6, jspec, p_force=p_force, t0=9))
    got = to_np(rulespec.run_planes_rule(to_t(w), 6, spec, p_force=p_force,
                                         t0=9))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("variant", RULES)
def test_byte_oracle_matches_reference(variant):
    spec, jspec = rulespec.get_rule(variant), jrulespec.get_rule(variant)
    state = spec.init_bytes(8, 64, 0.3, 6)
    assert np.array_equal(state, jspec.init_bytes(8, 64, 0.3, 6))
    want = np.asarray(jrulespec.oracle_run(jnp.asarray(state), 3, jspec,
                                           t0=4))
    got = rulespec.oracle_run(torch.from_numpy(state), 3, spec, t0=4)
    assert np.array_equal(want, got.numpy())
    # the packed stepper agrees with the oracle it is held against
    packed = rulespec.run_planes_rule(
        bitplane.pack(torch.from_numpy(state), spec.n_planes), 3, spec,
        t0=4)
    assert torch.equal(bitplane.unpack(packed), got)


def test_byte_step_forcing_and_channel_match_reference():
    state = byte_step.make_channel(8, 64, density=0.3, seed=2)
    assert np.array_equal(state, jbyte.make_channel(8, 64, density=0.3,
                                                    seed=2))
    want = np.asarray(jbyte.step_bytes(jnp.asarray(state), 5, p_force=0.4,
                                       y0=1, x0=32, variant="fhp3"))
    got = byte_step.step_bytes(torch.from_numpy(state), 5, p_force=0.4,
                               y0=1, x0=32, variant="fhp3")
    assert np.array_equal(want, got.numpy())
    for a, b in zip(jbyte.momentum(jnp.asarray(state)),
                    byte_step.momentum(torch.from_numpy(state))):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jbyte.density(jnp.asarray(state))),
                          byte_step.density(torch.from_numpy(state)).numpy())


# ---------------------------------------------------------------------------
# Invariants and moments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", RULES)
def test_invariants_and_moments_match_reference(variant):
    spec, jspec = rulespec.get_rule(variant), jrulespec.get_rule(variant)
    w = words(6, (3, spec.n_planes, 7, 3))
    jw, tw = jnp.asarray(w), to_t(w)
    want = jrulespec.invariants(jspec, jw, with_momentum=True)
    got = rulespec.invariants(spec, tw, with_momentum=True)
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    assert np.array_equal(np.asarray(jrulespec.integrity_ok(jspec, jw)),
                          rulespec.integrity_ok(spec, tw).numpy())
    stacks = [None] + ([spec.n_planes - 1] if spec.solid_plane else [])
    for sp in stacks:
        jms, ms = (jrulespec.moment_spec(jspec, sp),
                   rulespec.moment_spec(spec, sp))
        assert (jms.names, jms.terms, jms.coeffs) == \
            (ms.names, ms.terms, ms.coeffs)
        n = ms.n_terms and max(max(t) for t in ms.terms) + 1
        want = np.asarray(jrulespec.compute_moments(jw[:, :n], jms))
        got = rulespec.compute_moments(tw[:, :n], ms)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), (variant, sp)
        for n_sites in (2 ** 20, 2 ** 27, 2 ** 28):
            refused = [False, False]
            for i, (mod, m) in enumerate(((jrulespec, jms), (rulespec, ms))):
                try:
                    mod.require_moment_headroom(m, n_sites)
                except ValueError:
                    refused[i] = True
            assert refused[0] == refused[1], (variant, n_sites)


def test_audit_reports_violations():
    spec = rulespec.get_rule("bml")
    w = to_t(words(7, (2, 5, 2)))
    clean = {k: v.tolist() for k, v in rulespec.invariants(spec, w).items()}
    bad = rulespec.audit(spec, w, {**clean, "mass": clean["mass"] + 1})
    assert "mass" in bad
    exclusive = w.clone()
    exclusive[1] = exclusive[0] & ~exclusive[1]
    exclusive[0] = exclusive[0] & ~exclusive[1]
    assert rulespec.audit(spec, exclusive, {}) == {}


def test_carry_round_trips_every_bit():
    w = words(8, (2, 3, 4))
    t = carry.planes_from_reference(w, CPU)
    assert t.dtype == torch.int32
    assert np.array_equal(carry.planes_to_reference(t), w)
    m = torch.tensor([[-5, 7]], dtype=torch.int32)
    assert np.array_equal(carry.moments_to_reference(m), m.numpy())


def test_port_imports_no_jax_or_reference():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))))\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": src}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
