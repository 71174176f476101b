"""The slice as a whole: the ensemble entry point and the example entry
points of the port against the JAX reference, on the CPU (where the
port's kernel wrappers take their plain version)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import bitplane as jbitplane
from repro.core import byte_step as jbyte
from repro.core import distributed as jdist
from repro.core import rulespec as jrulespec
from repro_torch.core import carry, distributed
from repro_torch.examples import cylinder, quickstart

CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def lanes(variant, seed, h=16, w=256, b=2):
    name, kw = (("bml_city", {}) if variant == "bml"
                else ("cylinder", {"variant": variant}))
    return np.stack([np.asarray(jscenarios.get(
        name, height=h, width=w, seed=seed + i, **kw).initial_planes())
        for i in range(b)])


@pytest.mark.parametrize("variant,use_pallas,k", [
    ("fhp2", True, 2), ("fhp2", True, 0), ("bml", True, 1),
    ("fhp3", False, 2), ("fhp2", False, 0), ("bml", False, 3)])
def test_ensemble_run_matches_reference(variant, use_pallas, k):
    w = lanes(variant, seed=3)
    p_force = 0.0 if variant == "bml" else 0.05
    steps, T = 5, 2
    jrun, jshard = jdist.make_ensemble_run(
        None, steps, variant=variant, p_force=p_force,
        use_pallas=use_pallas, steps_per_launch=T, moments_every=k)
    run, shard = distributed.make_ensemble_run(
        None, steps, variant=variant, p_force=p_force, steps_per_launch=T,
        moments_every=k)
    assert jshard is None and shard is None
    want = jrun(jnp.asarray(w), 7)
    got = run(carry.planes_from_reference(w, CPU), 7)
    if k:
        (want, wm), (got, gm) = want, got
        assert gm.shape == (2, steps // k, wm.shape[-1])
        assert np.array_equal(np.asarray(wm), carry.moments_to_reference(gm))
    assert np.array_equal(np.asarray(want), carry.planes_to_reference(got))


def test_quickstart_matches_reference():
    got = quickstart.main(["--device", "cpu", "--steps", "19", "--height",
                           "32", "--width", "128"])
    state = jnp.asarray(jbyte.make_channel(32, 128, density=0.25, seed=0))
    want = jbitplane.run_planes(jbitplane.pack(state), 19, p_force=0.05)
    assert np.array_equal(np.asarray(want), carry.planes_to_reference(got))


def test_cylinder_matches_reference():
    got = cylinder.main(["--device", "cpu", "--steps", "13", "--height",
                         "32", "--width", "128", "--radius", "4"])
    sc = jscenarios.get("cylinder", height=32, width=128, radius=4,
                        p_force=0.03)
    want = jrulespec.run_planes_rule(sc.initial_planes(), 13, sc.rule(),
                                     p_force=0.03)
    assert np.array_equal(np.asarray(want), carry.planes_to_reference(got))


@pytest.mark.parametrize("module", ["quickstart", "cylinder"])
def test_example_entry_points_run(module):
    env = {**os.environ, "PYTHONPATH": SRC}
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{module}", "--device",
         "cpu", "--steps", "9", "--height", "32", "--width", "128"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK" in res.stdout.splitlines()[-1]
