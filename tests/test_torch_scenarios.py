"""The port's geometry, scenarios and observables against the JAX
reference, bit for bit: every registered scenario's initial state (one-shot
and built in row chunks), solid planes, obstacle rasters, and the
observables the serve engine streams."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import rulespec as jrulespec
from repro.scenarios import observables as jobs
from repro_torch import scenarios
from repro_torch.core import bitplane, carry, rulespec
from repro_torch.scenarios import observables

CPU = torch.device("cpu")
TINY = dict(height=16, width=128)


def test_registry_matches_reference():
    assert scenarios.names() == jscenarios.names()


@pytest.mark.parametrize("name", jscenarios.names())
def test_initial_state_matches_reference(name):
    sc, jsc = scenarios.get(name, **TINY), jscenarios.get(name, **TINY)
    assert np.array_equal(sc.initial_bytes(), jsc.initial_bytes())
    want = np.asarray(jsc.initial_planes())
    one_shot = bitplane.pack(torch.from_numpy(sc.initial_bytes()),
                             n_planes=sc.rule().n_planes)
    assert np.array_equal(carry.planes_to_reference(one_shot), want)
    for rows in (0, 1, 3, 5, 16):
        got = sc.initial_planes(device=CPU, chunk_rows=rows)
        assert got.dtype == torch.int32
        assert np.array_equal(carry.planes_to_reference(got), want), rows
    assert np.array_equal(sc.solid_plane(chunk_rows=3), jsc.solid_plane())
    for (n, w), (jn, jw) in zip(sc.obstacle_words(), jsc.obstacle_words()):
        assert n == jn and np.array_equal(w, jw)


def test_chunked_fill_of_a_wider_lattice():
    # more rows than one chunk, porous geometry, odd chunk size
    kw = dict(height=40, width=256, seed=9)
    sc, jsc = scenarios.get("porous_plug", **kw), \
        jscenarios.get("porous_plug", **kw)
    got = sc.initial_planes(device=CPU, chunk_rows=7)
    assert np.array_equal(carry.planes_to_reference(got),
                          np.asarray(jsc.initial_planes()))


def _stepped(name, steps=6):
    jsc = jscenarios.get(name, **TINY)
    spec = jrulespec.get_rule(jsc.variant)
    p = jrulespec.run_planes_rule(jsc.initial_planes(), steps, spec,
                                  p_force=jsc.p_force)
    return jsc, np.asarray(p)


@pytest.mark.parametrize("name", ["cylinder", "bml_city", "backward_step"])
def test_frame_summary_matches_reference(name):
    jsc, w = _stepped(name)
    spec, jspec = rulespec.get_rule(jsc.variant), jsc.rule()
    t = carry.planes_from_reference(w, CPU)
    for step in (6, 7):
        want = jobs.frame_summary(jnp.asarray(w), jspec, step)
        assert observables.frame_summary(t, spec, step) == want
        inv = rulespec.invariants(spec, t,
                                  with_momentum=spec.conserves_momentum)
        assert observables.frame_summary(t, spec, step, inv=inv) == want
    if spec.n_planes == 8:
        m = int(observables.mass(t))
        assert m == int(jobs.mass(jnp.asarray(w)))
        assert observables.mass_audit(t, m)
        assert not observables.mass_audit(t, m + 1)


def test_bml_observables_match_reference():
    _, w = _stepped("bml_city", 5)
    t = carry.planes_from_reference(w, CPU)
    for a, b in zip(jobs.car_counts(jnp.asarray(w)), observables.car_counts(t)):
        assert int(a) == int(b)
    for step in (4, 5):
        assert float(jobs.jam_fraction(jnp.asarray(w), step)) == \
            float(observables.jam_fraction(t, step))


@pytest.mark.parametrize("tiles", [(8, 2), (4, 1), (16, 4)])
def test_coarse_velocity_matches_reference(tiles):
    _, w = _stepped("cylinder")
    want = np.asarray(jobs.coarse_velocity(jnp.asarray(w), *tiles))
    got = observables.coarse_velocity(carry.planes_from_reference(w, CPU),
                                      *tiles)
    assert got.dtype == torch.float32
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("name", ["cylinder", "porous_plug",
                                  "cylinder_array"])
def test_obstacle_report_matches_reference(name):
    jsc, w = _stepped(name, 9)
    sc = scenarios.get(name, **TINY)
    t = carry.planes_from_reference(w, CPU)
    assert observables.obstacle_report(t, sc) == \
        jobs.obstacle_report(jnp.asarray(w), jsc)
    words = sc.obstacle_words()[0][1]
    for a, b in zip(jobs.solid_momentum(jnp.asarray(w), words),
                    observables.solid_momentum(t, words)):
        assert int(a) == int(b)
