"""The port's plain stepping tiers and its Poiseuille example against the
JAX reference.

Random states made from a numpy seed go through ``repro.core``'s
``stream_planes`` / ``collide`` / ``step_planes`` / ``run_planes`` /
``run_bytes`` / ``velocity_profile`` and the port's, over fhp2 and fhp3,
batch axes, ``y0``/``xw0`` offsets (odd rows included) and ``chi`` /
``accel`` overrides.  Plane and byte states must be bit-equal; the
float32 velocity profile must agree within atol 1e-6.  The port's
``run_planes`` is held bit-equal to the kernel entry point's plain path
on the ``poiseuille`` scenario, and the Poiseuille profile to the
reference example's procedure at a short run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import bitplane as jbitplane
from repro.core import byte_step as jbyte
from repro_torch import scenarios
from repro_torch.core import bitplane, byte_step, carry
from repro_torch.examples import poiseuille
from repro_torch.kernels.fhp_step import ops

CPU = torch.device("cpu")
PROFILE_ATOL = 1e-6


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


def to_t(a):
    return carry.planes_from_reference(np.asarray(a), CPU)


def to_np(t):
    return carry.planes_to_reference(t)


def channel_bytes(seed, h=16, w=64):
    return byte_step.make_channel(h, w, density=0.3, seed=seed)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("row0", [0, 1, 6, 7])
def test_stream_planes_matches_reference(lead, row0):
    w = words(row0 + len(lead), lead + (8, 12, 5))
    want = np.asarray(jbitplane.stream_planes(jnp.asarray(w), row0=row0))
    assert np.array_equal(to_np(bitplane.stream_planes(to_t(w), row0=row0)),
                          want)


@pytest.mark.parametrize("variant", ["fhp2", "fhp3"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_collide_matches_reference(variant, lead):
    w = words(7, lead + (8, 10, 4))
    chi = words(8, (10, 4))
    want = np.asarray(jbitplane.collide(jnp.asarray(w), jnp.asarray(chi),
                                        variant))
    assert np.array_equal(
        to_np(bitplane.collide(to_t(w), to_t(chi), variant)), want)


@pytest.mark.parametrize("variant", ["fhp2", "fhp3"])
@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("t,p_force,y0,xw0", [
    (0, 0.0, 0, 0), (5, 0.05, 0, 0), (3, 0.03, 7, 2), (11, 0.5, 13, 5),
    (2 ** 20 + 3, 0.05, 1, 1023)])
def test_step_planes_matches_reference(variant, lead, t, p_force, y0, xw0):
    w = words(t % 97 + y0, lead + (8, 14, 6))
    want = np.asarray(jbitplane.step_planes(
        jnp.asarray(w), t, p_force, y0, xw0, variant=variant))
    got = bitplane.step_planes(to_t(w), t, p_force, y0, xw0,
                               variant=variant)
    assert np.array_equal(to_np(got), want)


@pytest.mark.parametrize("variant", ["fhp2", "fhp3"])
def test_step_planes_overrides_match_reference(variant):
    w, chi, accel = words(1, (2, 8, 9, 3)), words(2, (9, 3)), words(3, (9, 3))
    want = np.asarray(jbitplane.step_planes(
        jnp.asarray(w), 4, 0.0, 3, 1, chi=jnp.asarray(chi),
        accel=jnp.asarray(accel), variant=variant))
    got = bitplane.step_planes(to_t(w), 4, 0.0, 3, 1, chi=to_t(chi),
                               accel=to_t(accel), variant=variant)
    assert np.array_equal(to_np(got), want)
    # chi alone, no force
    want = np.asarray(jbitplane.step_planes(
        jnp.asarray(w), 4, chi=jnp.asarray(chi), variant=variant))
    got = bitplane.step_planes(to_t(w), 4, chi=to_t(chi), variant=variant)
    assert np.array_equal(to_np(got), want)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("steps,p_force,t0", [(6, 0.0, 0), (9, 0.05, 17)])
def test_run_planes_matches_reference(lead, steps, p_force, t0):
    w = np.stack([np.asarray(jbitplane.pack(jnp.asarray(channel_bytes(s))))
                  for s in range(int(np.prod(lead)) if lead else 1)])
    w = w.reshape(lead + w.shape[1:])
    want = np.asarray(jbitplane.run_planes(jnp.asarray(w), steps, p_force,
                                           t0))
    got = bitplane.run_planes(to_t(w), steps, p_force, t0)
    assert np.array_equal(to_np(got), want)


@pytest.mark.parametrize("steps,p_force,t0", [(5, 0.0, 0), (8, 0.05, 9),
                                              (4, 0.3, 2 ** 16)])
def test_run_bytes_matches_reference(steps, p_force, t0):
    s = channel_bytes(steps, h=12, w=40)
    want = np.asarray(jbyte.run_bytes(jnp.asarray(s), steps, p_force, t0))
    got = byte_step.run_bytes(torch.from_numpy(s), steps, p_force, t0)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_velocity_profile_matches_reference(seed):
    s = channel_bytes(seed, h=20, w=96)
    s = np.array(jbyte.run_bytes(jnp.asarray(s), 10, 0.1))
    want = np.asarray(jbyte.velocity_profile(jnp.asarray(s)))
    got = byte_step.velocity_profile(torch.from_numpy(s)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PROFILE_ATOL)


def test_run_planes_matches_entry_point_plain_path():
    sc = scenarios.get("poiseuille", height=32, width=256, p_force=0.02)
    planes = sc.initial_planes(device=CPU)[None]
    want = ops.run_cuda(planes, 21, p_force=sc.p_force, t0=5,
                        steps_per_launch=8)
    got = bitplane.run_planes(planes, 21, sc.p_force, 5)
    assert torch.equal(got, want)


def _reference_profile(sc, steps):
    """The reference example's procedure (examples/poiseuille.py) at
    ``steps``: warm 3/4 of the run, then 50-step chunks averaged."""
    planes = sc.initial_planes()
    warm = steps * 3 // 4
    planes = jbitplane.run_planes(planes, warm, p_force=sc.p_force)
    n = max((steps - warm) // 50, 1)
    acc = jnp.zeros((sc.height,), jnp.float32)
    t = warm
    for _ in range(n):
        planes = jbitplane.run_planes(planes, 50, p_force=sc.p_force, t0=t)
        t += 50
        acc = acc + jbitplane.row_velocity(planes)
    return np.asarray(acc / n), planes


@pytest.mark.parametrize("plain", [False, True])
def test_poiseuille_profile_matches_reference(plain):
    kw = dict(height=32, width=256, p_force=0.02)
    want, want_planes = _reference_profile(jscenarios.get("poiseuille", **kw),
                                           300)
    _, planes, prof = poiseuille.simulate(
        scenarios.get("poiseuille", **kw), 300, device=CPU, plain=plain)
    assert np.array_equal(to_np(planes), np.asarray(want_planes))
    np.testing.assert_allclose(prof, want, rtol=0, atol=PROFILE_ATOL)


def test_poiseuille_fit_matches_reference_formula():
    ys = np.arange(64, dtype=np.float64)
    prof = (-(ys - 31.5) ** 2 + 1000.0) * 1e-4
    r2, coef = poiseuille.fit(prof.astype(np.float32))
    assert r2 > 0.999 and coef[0] < 0


def test_poiseuille_example_cpu_ends_ok(capsys):
    r2, coef = poiseuille.main(["--device", "cpu", "--height", "32",
                                "--width", "256", "--steps", "1200",
                                "--p-force", "0.05"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK: Poiseuille flow reproduced")
    assert r2 > 0.9 and coef[0] < 0
