"""The sharded path as a whole on meshes of CPU slots: the port's
``make_ensemble_run`` / ``make_run`` on 2 x 2 and (2, 2, 2) meshes against
the reference's single-device run (``make_ensemble_run(None,
use_pallas=False)`` and ``rulespec.run_planes_rule``), bit for bit; the
mesh, the placement and the example entry point.  The reference's own mesh
needs fake devices in a subprocess and is not driven here.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import distributed as jdist
from repro.core import rulespec as jrulespec
from repro_torch.core import carry, distributed
from repro_torch.examples import fhp_distributed

CPU = torch.device("cpu")
MESHES = {"2x2": ((2, 2), ("data", "model"), ("data",)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))}
STEPS, T0 = 4, 5


def lanes(variant, seed, h=32, w=256, b=2):
    name, kw = (("bml_city", {}) if variant == "bml"
                else ("cylinder", {"variant": variant}))
    return np.stack([np.asarray(jscenarios.get(
        name, height=h, width=w, seed=seed + i, **kw).initial_planes())
        for i in range(b)])


def cpu_mesh(name):
    shape, axes, y_axes = MESHES[name]
    return distributed.make_mesh(shape, axes, CPU), y_axes


def p_force(variant):
    return 0.0 if variant == "bml" else 0.05


@functools.lru_cache(maxsize=None)
def reference(variant):
    """Two lanes (sharing the scenario's geometry) and the reference's
    single-device run of them: the final planes and the moments after
    every step.  The eager jnp run is what these tests spend their time
    on, so each rule runs once."""
    w = lanes(variant, seed=1)
    run, _ = jdist.make_ensemble_run(None, STEPS, variant=variant,
                                     p_force=p_force(variant),
                                     use_pallas=False, moments_every=1)
    out, mom = run(jnp.asarray(w), T0)
    return w, np.asarray(out), np.asarray(mom)


@pytest.mark.parametrize("variant,mesh,depth,overlap,k", [
    ("fhp2", "2x2", 1, False, 0), ("fhp2", "2x2", 4, True, 2),
    ("fhp3", "2x2", 2, False, 1), ("fhp3", "2x2x2", 2, True, 2),
    ("bml", "2x2", 4, False, 4), ("bml", "2x2x2", 1, True, 1),
    ("fhp2", "2x2x2", 4, False, 2)])
def test_ensemble_run_on_mesh_matches_reference(variant, mesh, depth,
                                                overlap, k):
    w, want, wm = reference(variant)
    m, y_axes = cpu_mesh(mesh)
    run, sharding = distributed.make_ensemble_run(
        m, STEPS, variant=variant, p_force=p_force(variant), depth=depth,
        steps_per_launch=min(depth, 2), overlap=overlap, y_axes=y_axes,
        moments_every=k)
    assert (sharding.ny, sharding.nx) == (4 if mesh == "2x2x2" else 2, 2)
    got = run(carry.planes_from_reference(w, CPU), T0)
    if k:
        got, gm = got
        assert gm.shape == (2, STEPS // k, wm.shape[-1])
        assert np.array_equal(wm[:, k - 1::k], carry.moments_to_reference(gm))
    assert np.array_equal(want, carry.planes_to_reference(got))


@pytest.mark.parametrize("variant,mesh,depth,overlap,k", [
    ("fhp2", "2x2", 4, False, 4), ("fhp3", "2x2", 2, True, 1),
    ("fhp2", "2x2x2", 2, True, 0)])
def test_static_solid_run_matches_reference(variant, mesh, depth, overlap,
                                            k):
    # The lanes share their geometry; the dynamic stack's moments drop
    # the solid row.
    w, want, wm = reference(variant)
    assert (w[:, 7] == w[0, 7]).all()
    m, y_axes = cpu_mesh(mesh)
    run = distributed.make_run(m, STEPS, y_axes=y_axes,
                               p_force=p_force(variant), depth=depth,
                               overlap=overlap, batched=True,
                               static_solid=True, variant=variant,
                               steps_per_launch=2, moments_every=k)
    got = run(carry.planes_from_reference(w, CPU), T0)
    if k:
        got, gm = got
        keep = [r for r, n in enumerate(jrulespec.moment_spec(
            jrulespec.get_rule(variant)).names) if n != "solid"]
        assert np.array_equal(wm[:, k - 1::k][..., keep],
                              carry.moments_to_reference(gm))
    assert np.array_equal(want, carry.planes_to_reference(got))


def test_unbatched_sharded_run_stays_sharded():
    # A (P, H, Wd) stack placed by hand: the result stays on the mesh.
    w = lanes("fhp2", seed=3, b=1)[0]
    m, y_axes = cpu_mesh("2x2x2")
    sharding = distributed.lattice_spec(m, y_axes, "model")
    placed = sharding.place(carry.planes_from_reference(w, CPU))
    assert placed.tiles[3][1].shape == (8, 8, 4)
    run = distributed.make_run(m, 6, y_axes=y_axes, p_force=0.05, depth=3)
    out = run(placed, 4)
    assert isinstance(out, distributed.ShardedPlanes)
    spec = jrulespec.get_rule("fhp2")
    want = jrulespec.run_planes_rule(jnp.asarray(w), 6, spec, p_force=0.05,
                                     t0=4)
    assert np.array_equal(np.asarray(want),
                          carry.planes_to_reference(out.gather()))


def test_mesh_slots_and_placement():
    devs = [torch.device("cuda", i) for i in range(8)]
    m = distributed.make_mesh((2, 2, 2), ("pod", "data", "model"), devs)
    assert m.size == 8 and m.shape == {"pod": 2, "data": 2, "model": 2}
    sh = distributed.lattice_spec(m, ("pod", "data"), "model")
    # The y index runs over (pod, data), pod major, as lax.axis_index.
    assert [[d.index for d in row] for row in sh.devices] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    sh = distributed.lattice_spec(m, ("data", "pod"), "model")
    assert [row[0].index for row in sh.devices] == [0, 4, 2, 6]
    x = torch.arange(2 * 8 * 8 * 6, dtype=torch.int32).reshape(2, 8, 8, 6)
    placed = distributed.lattice_spec(cpu_mesh("2x2")[0]).place(x)
    assert torch.equal(placed.gather(), x)
    assert torch.equal(placed.tiles[1][0], x[..., 4:, :3])


def test_mesh_refusals():
    if torch.cuda.device_count() != 4:       # never the CPU by default
        with pytest.raises(ValueError, match="devices="):
            distributed.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="3 devices"):
        distributed.make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    m, _ = cpu_mesh("2x2")
    with pytest.raises(ValueError, match="every axis"):
        distributed.lattice_spec(m, ("data",), "pod")
    with pytest.raises(ValueError, match="split"):
        distributed.lattice_spec(m).place(torch.zeros((8, 7, 4),
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="depth=32"):
        distributed.make_sharded_stepper(m, depth=32)
    with pytest.raises(ValueError, match="divide"):
        distributed.make_sharded_stepper(m, depth=4, moments_every=3)
    with pytest.raises(ValueError, match="no solid plane"):
        distributed.make_sharded_stepper(m, variant="bml", static_solid=True)
    with pytest.raises(ValueError, match="multiple of depth"):
        distributed.make_run(m, 6, depth=4)
    run = distributed.make_run(m, 8, depth=8)
    with pytest.raises(ValueError, match="local rows"):
        run(torch.zeros((8, 8, 4), dtype=torch.int32), 0)


def test_distributed_example_is_bit_exact():
    got = fhp_distributed.main(["--device", "cpu", "--height", "64",
                                "--width", "256", "--steps", "8"])
    assert got == {1: True, 2: True, 4: True, 8: True, "cylinder": True}
