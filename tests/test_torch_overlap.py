"""The overlapped round's pieces on the CPU, where ``ops`` takes the plain
version: the interior half on the bare shard and the boundary half on its
four slices, composed in place, against the reference's
``run_extended_split`` in interpret mode (as ``tests/test_overlap.py``
runs it) on the validity window, planes and int32 moments, bit for bit;
the boundary-only exchange against the slices of the whole one; shards
with no interior on the serial path; and the overlapped stepper's static
solid pieces.  The overlapped stepper on 2 x 2 and (2, 2, 2) meshes of
CPU slots is held against the reference's single-device run in
``tests/test_torch_mesh.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.fhp_step import ops as jops
from repro_torch.core import carry, distributed, rulespec
from repro_torch.kernels.fhp_step import ops

CPU = torch.device("cpu")


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


# (variant, hl, wdl, depth, T, block_rows, block_words, static solid,
# moments every): odd shard heights, depth % T != 0, a narrow x-blocked
# tile, static solid.  Interpret mode compiles each shape once (~15 s), so
# the shapes stay few and small (h <= 16, T <= 2); hypothesis varies the
# words, the step and the shard's place in the lattice.
SPLIT_CASES = [("fhp2", 9, 4, 3, 2, 0, 0, False, 3),
               ("fhp3", 10, 3, 2, 2, 0, 0, True, 2),
               ("bml", 11, 4, 2, 1, 0, 0, False, 1),
               ("fhp2", 10, 5, 2, 2, 4, 2, False, 2)]


@pytest.mark.parametrize("variant,hl,wdl,d,T,bh,bw,static,k", SPLIT_CASES)
@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2 ** 16), t0=st.integers(0, 1000),
       iy=st.integers(0, 3), ix=st.integers(0, 2))
def test_halves_composed_match_reference_split(variant, hl, wdl, d, T, bh,
                                               bw, static, k, seed, t0, iy,
                                               ix):
    spec = rulespec.get_rule(variant)
    he, wde = hl + 2 * d, wdl + 2
    w = words(seed, (2, spec.n_planes, he, wde))
    solid = None
    if static:
        solid, w = w[0, spec.solid_plane], w[:, :spec.solid_plane]
    # Shard (iy, ix) of a 4 x 3 grid: its apron corner at (iy*hl - d,
    # ix*wdl - 1) of the global lattice.
    kw = dict(t0=t0, p_force=0.0 if variant == "bml" else 0.05,
              hg=4 * hl + 4 * (hl % 2), wdg=3 * wdl, steps_per_launch=T,
              block_rows=bh, block_words=bw, variant=variant,
              moments_every=k)
    y0, xw0 = iy * hl - d, ix * wdl - 1
    want, wm = jops.run_extended_split(
        jnp.asarray(w), d, y0=y0, xw0=xw0,
        solid_ext=None if solid is None else jnp.asarray(solid), **kw)
    win = (..., slice(d, he - d), slice(1, wde - 1))
    want = np.asarray(want)[win]

    x = carry.planes_from_reference(w, CPU)
    se = None if solid is None else carry.planes_from_reference(solid, CPU)
    tile, m = ops.run_extended_interior(
        x[win].contiguous(), d, y0=y0 + d, xw0=xw0 + 1,
        solid=None if se is None else se[win].contiguous(), **kw)
    pieces, mb = ops.run_extended_boundary(
        ops.boundary_slices(x, d), d, y0=y0 + d, xw0=xw0 + 1,
        solid=None if se is None else ops.boundary_slices(se, d), **kw)
    got = ops.compose_split(tile, pieces)
    assert got.data_ptr() == tile.data_ptr()        # composed in place
    assert np.array_equal(want, carry.planes_to_reference(got))
    assert np.array_equal(np.asarray(wm), carry.moments_to_reference(m + mb))
    # ... and the composition as one call, with the reference's zero apron.
    out, om = ops.run_extended_split(x, d, y0=y0, xw0=xw0, solid_ext=se,
                                     **kw)
    assert torch.equal(out[win], got) and torch.equal(om, m + mb)
    assert not out[..., :d, :].any() and not out[..., :, 0].any()


@pytest.mark.parametrize("hl,wdl,d", [(8, 6, 4), (6, 6, 4), (16, 2, 4),
                                      (16, 1, 2)])
def test_shards_without_interior_take_the_serial_path(hl, wdl, d):
    x = carry.planes_from_reference(words(hl + wdl, (2, 8, hl + 2 * d,
                                                     wdl + 2)), CPU)
    kw = dict(t0=4, p_force=0.05, y0=-d, xw0=-1, hg=4 * hl, wdg=2 * wdl,
              steps_per_launch=2, moments_every=2)
    got, gm = ops.run_extended_split(x, d, **kw)
    want, wm = ops.run_extended(x, d, **kw)
    assert torch.equal(got, want) and torch.equal(gm, wm)
    # The stepper's overlapped round on such shards is the serial round.
    mesh = distributed.make_mesh((2, 2), ("data", "model"), CPU)
    placed = distributed.lattice_spec(mesh).place(
        carry.planes_from_reference(words(d, (8, 2 * hl, 2 * wdl)), CPU))
    rounds = [distributed.make_sharded_stepper(
        mesh, depth=d, steps_per_launch=2, p_force=0.05, overlap=ov,
        moments_every=2)(placed, 3) for ov in (False, True)]
    assert torch.equal(rounds[0][0].gather(), rounds[1][0].gather())
    assert torch.equal(rounds[0][1], rounds[1][1])


@pytest.mark.parametrize("shape,d", [((2, 2), 3), ((4, 1), 2), ((1, 3), 1)])
def test_boundary_exchange_builds_the_halo_slices(shape, d):
    # The overlapped round's exchange builds only the four slices of each
    # extended shard that its boundary launches read, and they equal the
    # same slices of the whole exchanged shard (corners included).
    mesh = distributed.make_mesh(shape, ("data", "model"), CPU)
    x = torch.from_numpy(words(sum(shape) + d, (2, 3, 8 * shape[0],
                                                5 * shape[1])).view(np.int32))
    placed = distributed.lattice_spec(mesh).place(x)
    devs = placed.sharding.devices
    whole = distributed._exchange_halo(placed.tiles, d, devs)
    parts = distributed._exchange_boundary(placed.tiles, d, devs)
    for row, prow in zip(whole, parts):
        for ext, got in zip(row, prow):
            want = ops.boundary_slices(ext, d)
            assert [g.shape for g in got] == [w.shape for w in want]
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_solid_cache_pieces():
    # make_solid_cache keeps each launch's contiguous solid beside the
    # extended tiles, which the overlapped stepper reads; it refuses a
    # plain ShardedPlanes of extended tiles and a cache of another depth.
    d = 2
    mesh = distributed.make_mesh((2, 2), ("data", "model"), CPU)
    w = words(7, (2, 8, 24, 12))
    w[1, 7] = w[0, 7]
    x = carry.planes_from_reference(w, CPU)
    sharding = distributed.lattice_spec(mesh)
    cache = distributed.make_solid_cache(mesh, depth=d)(x[0, 7])
    assert isinstance(cache, distributed.SolidCache)
    for row, prow in zip(cache.tiles, cache.pieces):
        for ext, pieces in zip(row, prow):
            want = (ext[d:-d, 1:-1],) + ops.boundary_slices(ext, d)
            assert all(p.is_contiguous() and torch.equal(p, q)
                       for p, q in zip(pieces, want))
    plain = distributed.ShardedPlanes(cache.sharding, cache.tiles)
    dyn = sharding.place(x[:, :7])
    step = distributed.make_sharded_stepper(
        mesh, depth=d, steps_per_launch=1, p_force=0.05, static_solid=True,
        overlap=True, moments_every=1)
    a, am = step(dyn, cache, 5)
    serial, sm = distributed.make_sharded_stepper(
        mesh, depth=d, steps_per_launch=1, p_force=0.05, static_solid=True,
        moments_every=1)(dyn, plain, 5)
    assert torch.equal(a.gather(), serial.gather()) and torch.equal(am, sm)
    with pytest.raises(ValueError, match="SolidCache"):
        step(dyn, plain, 5)
    with pytest.raises(ValueError, match="not of depth"):
        step(dyn, distributed.make_solid_cache(mesh, depth=1)(x[0, 7]), 5)
