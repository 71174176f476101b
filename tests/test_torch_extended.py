"""The fused-step module's extended-shard (K5, K6's extended half) and
precomputed-RNG (K2) modes on the CPU, where ``ops`` takes the plain
version: ``run_extended`` against the reference's ``run_extended`` in
interpret mode on the validity window, ``run_extended_split`` against
``run_extended``, ``fhp_step_cuda(rng_in_kernel=False)`` against
``fhp_step_pallas(rng_in_kernel=False)``, and the card's extended and K2
sweeps at a tiny size.  Everything compares bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fhp_step import ops as jops
from repro_torch.core import carry, rulespec
from repro_torch.kernels.fhp_step import check, ops

CPU = torch.device("cpu")


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


# (variant, T, steps, he, wde, static solid, moments every, offset):
# interpret mode traces every launch (recording ones most), so the arrays
# stay at h <= 16 rows, T <= 2.  The T = 2 cases have a remainder launch;
# the first has a shard the split does not fall back on (hl = 10 > 2 * 3,
# wdl = 3 > 2).
EXTENDED_CASES = [("fhp2", 2, 3, 16, 5, False, 3, 0),
                  ("fhp3", 1, 2, 16, 4, True, 1, 0),
                  ("bml", 2, 3, 16, 4, False, 2, 1),
                  ("fhp2", 1, 2, 12, 4, False, 1, 0)]


@pytest.mark.parametrize("variant,T,steps,he,wde,static,k,offset",
                         EXTENDED_CASES)
def test_run_extended_matches_reference(variant, T, steps, he, wde, static,
                                        k, offset):
    spec = rulespec.get_rule(variant)
    w = words(T + steps + he, (2, spec.n_planes, he, wde))
    solid = None
    if static:
        solid, w = w[0, spec.solid_plane], w[:, :spec.solid_plane]
    # Shard 0: the apron corner sits one word and `steps` rows before the
    # origin of a lattice larger than the array.
    kw = dict(t0=5, p_force=0.0 if variant == "bml" else 0.05, y0=-steps,
              xw0=-1, hg=2 * he + 4, wdg=wde + 3, steps_per_launch=T,
              variant=variant, moments_every=k, moments_offset=offset)
    want, wm = jops.run_extended(
        jnp.asarray(w), steps,
        solid_ext=None if solid is None else jnp.asarray(solid), **kw)
    want, wm = np.asarray(want), np.asarray(wm)
    x = carry.planes_from_reference(w, CPU)
    se = None if solid is None else carry.planes_from_reference(solid, CPU)
    win = (..., slice(steps, he - steps), slice(1, wde - 1))
    for fn in (ops.run_extended, ops.run_extended_split):
        got, gm = fn(x, steps, solid_ext=se, **kw)
        assert got.shape == x.shape and gm.shape == wm.shape
        assert np.array_equal(want[win], carry.planes_to_reference(got)[win])
        assert np.array_equal(wm, carry.moments_to_reference(gm))


@pytest.mark.parametrize("variant,depth,T,k,static", [
    ("fhp2", 4, 3, 2, False), ("fhp3", 3, 3, 1, True), ("bml", 2, 1, 2, False),
    ("fhp2", 5, 2, 5, True)])
def test_run_extended_split_matches_run_extended(variant, depth, T, k,
                                                 static):
    # Interior plus four boundary pieces against one serial run, on the
    # window, with the moments of the five pieces summed.
    spec = rulespec.get_rule(variant)
    hl, wdl = 4 * depth, 6
    he, wde = hl + 2 * depth, wdl + 2
    x = carry.planes_from_reference(
        words(depth, (3, spec.n_planes, he, wde)), CPU)
    se = None
    if static:
        se, x = x[0, spec.solid_plane].clone(), x[:, :spec.solid_plane]
    kw = dict(t0=9, p_force=0.0 if variant == "bml" else 0.1, y0=hl - depth,
              xw0=wdl - 1, hg=2 * hl, wdg=2 * wdl, steps_per_launch=T,
              variant=variant, moments_every=k, solid_ext=se)
    want, wm = ops.run_extended(x, depth, **kw)
    got, gm = ops.run_extended_split(x, depth, **kw)
    win = (..., slice(depth, he - depth), slice(1, wde - 1))
    assert torch.equal(got[win], want[win]) and torch.equal(gm, wm)
    # The apron that the split does not compute is zero.
    assert not got[..., :depth, :].any() and not got[..., :, 0].any()
    assert wm.shape[-2] == depth // k


@pytest.mark.parametrize("variant,p_force,y0,xw0", [
    ("fhp2", 0.05, 3, 2), ("fhp3", 0.0, 0, 0), ("bml", 0.0, 5, 1)])
def test_precomputed_rng_matches_reference(variant, p_force, y0, xw0):
    spec = rulespec.get_rule(variant)
    w = words(len(variant), (2, spec.n_planes, 16, 4))
    kw = dict(p_force=p_force, y0=y0, xw0=xw0, variant=variant,
              rng_in_kernel=False)
    want = jops.fhp_step_pallas(jnp.asarray(w), 7, **kw)
    got = ops.fhp_step_cuda(carry.planes_from_reference(w, CPU), 7, **kw)
    assert np.array_equal(np.asarray(want), carry.planes_to_reference(got))
    # ... and the same step with the random words hashed in the kernel.
    fused = ops.fhp_step_cuda(carry.planes_from_reference(w, CPU), 7,
                              **dict(kw, rng_in_kernel=True))
    assert torch.equal(fused, got)
    # ... and the same step on planes drawn once, outside the wrapper.
    x = carry.planes_from_reference(w, CPU)
    given = ops.rng_words(x.shape[-2:], 7, p_force=p_force, y0=y0, xw0=xw0,
                          variant=variant, device=CPU)
    assert torch.equal(ops.fhp_step_cuda(x, 7, rng_planes=given, **kw), got)


def test_rng_planes_checks():
    x = torch.zeros((1, 8, 16, 4), dtype=torch.int32)
    chi, acc = ops.rng_words((16, 4), 0, p_force=0.05)
    assert chi.shape == acc.shape == (16, 4)
    assert ops.rng_words((16, 4), 0, variant="bml") == (None, None)
    with pytest.raises(ValueError, match="rng_in_kernel=False"):
        ops.fhp_step_cuda(x, 0, p_force=0.05, rng_planes=(chi, acc))
    with pytest.raises(ValueError, match="rng_planes must be"):
        ops.fhp_step_cuda(x, 0, p_force=0.05, rng_in_kernel=False,
                          rng_planes=(chi[:8], acc))


@pytest.mark.parametrize("case", [check.Case("fhp2", 2, 1, 0.05),
                                  check.Case("fhp3", 1, 3, 0.0),
                                  check.Case("bml", 3, 1, 0.0)], ids=str)
def test_extended_and_k2_sweep_cases_on_cpu(case):
    # The card's sweeps: run_extended's launch schedule against one plain
    # step per call; K2 against the hashed plain step.
    assert check.run_extended_case(case, CPU, h=30, wd=15) == []
    assert check.run_k2_case(case._replace(steps_per_launch=1), CPU, h=30,
                             wd=15) == []


def test_extended_dispatch_and_checks():
    meta = torch.empty((2, 8, 64, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.run_extended(meta, 4, hg=128, wdg=64, moments_every=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fhp_step_cuda(meta, 0, rng_in_kernel=False)
    x = torch.zeros((1, 7, 16, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="solid_ext"):
        ops.run_extended(x, 2, hg=32, wdg=12, solid_ext=x[0, 0, :8])
    # Moment headroom counts the global lattice in extended mode.
    big = torch.empty((1, 8, 64, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="overflow"):
        ops.fhp_step_cuda(big, 0, extended=True, hg=2 ** 14, wdg=2 ** 9,
                          record_steps=(0,))
