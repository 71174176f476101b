"""Distributed FHP stepping: explicit domain decomposition over a mesh of
device slots held by one process.

The counterpart of ``repro/core/distributed.py``.  There a ``shard_map``
over a ``jax.sharding.Mesh`` runs every shard from one controller and each
``lax.ppermute`` ring moves halo slices between devices.  Here a
:class:`Mesh` is a grid of device slots (two slots may name the same
device), a lattice is placed on it as a grid of per-slot tensors
(:class:`ShardedPlanes`), and each ring is a copy of the edge slice onto
the neighbour slot's device.  On one card a 2x2 mesh runs four real
shards with real exchanges; on several cards the same code makes peer
copies; on the CPU the tests use a mesh of CPU slots.

Rows are split over the ``y_axes`` (the shard's y index is the linear
index over those axes, first axis major, as ``lax.axis_index`` gives it)
and words over ``x_axis``.  Each round exchanges a depth-``d`` halo -- the
x halo (one word each side) first, then the y halo on the x-extended
shards, so the corners ride along -- and advances every shard ``d`` steps
with ``kernels.fhp_step.ops.run_extended`` (or ``run_extended_split`` with
``overlap``): the kernel's extended-shard mode on a CUDA slot, its plain
version on a CPU slot.  The counter RNG hashes global coordinates mod the
global extents, so every scheme is bit-identical to the single-device
run.  ``make_solid_cache`` exchanges a static solid plane's apron once per
geometry, and the ``static_solid`` stepper then moves 7 dynamic planes
per round against the cached tile.

Every mesh axis is one of ``y_axes`` or ``x_axis``: shards are not
replicated over a spare axis.  ``make_gspmd_run`` has no counterpart: it
is the reference's XLA (GSPMD) baseline, and PyTorch has no partitioner
to compare against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng, rulespec
from repro_torch.kernels.fhp_step import ops

Axes = Union[str, Tuple[str, ...]]
Grid = Tuple[Tuple[torch.Tensor, ...], ...]     # grid[iy][ix]


class Mesh:
    """A grid of device slots, one per mesh coordinate.

    ``shape[name]`` is the extent of axis ``name`` (as on a JAX mesh) and
    ``devices`` the ``torch.device`` of each slot, a numpy object array of
    the mesh's shape."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        self.axis_names = tuple(axis_names)
        dims = tuple(int(n) for n in shape)
        if len(dims) != len(self.axis_names) or min(dims, default=0) < 1:
            raise ValueError(f"mesh shape {dims} does not fit axis names "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        self.shape = dict(zip(self.axis_names, dims))
        self.devices = np.empty(dims, dtype=object)
        if len(devices) != self.devices.size:
            raise ValueError(f"{len(devices)} devices for a mesh of "
                             f"{self.devices.size} slots")
        for i, dev in enumerate(devices):
            self.devices.flat[i] = dev

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A :class:`Mesh` of ``prod(shape)`` slots, row-major over
    ``axis_names``.  ``devices`` is one device per slot, or one device that
    every slot shares; by default the visible CUDA devices, when there are
    exactly as many as slots (otherwise this raises: the default is never
    the CPU)."""
    n = math.prod(int(s) for s in shape)
    if devices is None:
        count = torch.cuda.device_count()
        if count != n:
            raise ValueError(
                f"a mesh of {n} slots needs devices=: {count} CUDA devices "
                f"are visible (pass one device for every slot to share, or "
                f"one per slot)")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
    return Mesh(shape, axis_names, devs)


def _axes(y_axes: Axes) -> Tuple[str, ...]:
    return (y_axes,) if isinstance(y_axes, str) else tuple(y_axes)


class LatticeSharding:
    """How a ``(..., P, H, Wd)`` plane stack lies on a mesh: rows split
    over ``y_axes``, words over ``x_axis``, the leading axes (planes,
    ensemble lanes) whole in every shard -- the counterpart of
    ``NamedSharding(mesh, lattice_spec(y_axes, x_axis, batched))``, for
    batched stacks or not.  ``devices[iy][ix]`` is the device of shard
    ``(iy, ix)``."""

    def __init__(self, mesh: Mesh, y_axes: Axes = ("data",),
                 x_axis: str = "model"):
        ys = _axes(y_axes)
        if x_axis in ys or sorted(ys + (x_axis,)) != sorted(mesh.axis_names):
            raise ValueError(
                f"y_axes {ys} and x_axis {x_axis!r} must name every axis of "
                f"the mesh {mesh.axis_names} once")
        self.mesh, self.y_axes, self.x_axis = mesh, ys, x_axis
        self.ny = math.prod(mesh.shape[a] for a in ys)
        self.nx = mesh.shape[x_axis]
        self.devices = tuple(tuple(self._device(iy, ix)
                                   for ix in range(self.nx))
                             for iy in range(self.ny))

    def _device(self, iy: int, ix: int) -> torch.device:
        coord = {self.x_axis: ix}
        for a in reversed(self.y_axes):       # first y axis major
            iy, coord[a] = divmod(iy, self.mesh.shape[a])
        return self.mesh.devices[tuple(coord[a]
                                       for a in self.mesh.axis_names)]

    def place(self, planes: torch.Tensor) -> "ShardedPlanes":
        """Split ``planes`` into its shards, each on its slot's device."""
        h, wd = planes.shape[-2:]
        if h % self.ny or wd % self.nx:
            raise ValueError(f"lattice {(h, wd)} (rows, words) does not "
                             f"split into {self.ny} x {self.nx} shards")
        hl, wdl = h // self.ny, wd // self.nx
        return ShardedPlanes(self, tuple(
            tuple(planes[..., iy * hl:(iy + 1) * hl, ix * wdl:(ix + 1) * wdl]
                  .to(dev).contiguous() for ix, dev in enumerate(row))
            for iy, row in enumerate(self.devices)))


def lattice_spec(mesh: Mesh, y_axes: Axes = ("data",),
                 x_axis: str = "model") -> LatticeSharding:
    """The :class:`LatticeSharding` of a ``(P, H, Wd)`` stack or of a
    ``(B, P, H, Wd)`` ensemble stack."""
    return LatticeSharding(mesh, y_axes, x_axis)


@dataclasses.dataclass(frozen=True)
class ShardedPlanes:
    """A lattice placed on a mesh: ``tiles[iy][ix]`` is shard ``(iy, ix)``
    on its slot's device."""

    sharding: LatticeSharding
    tiles: Grid

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole lattice's shape."""
        t = self.tiles[0][0]
        return tuple(t.shape[:-2]) + (t.shape[-2] * self.sharding.ny,
                                      t.shape[-1] * self.sharding.nx)

    def map(self, fn: Callable, *others: "ShardedPlanes") -> "ShardedPlanes":
        """``fn`` applied to every shard (and the same shard of each of
        ``others``)."""
        return ShardedPlanes(self.sharding, tuple(
            tuple(fn(*ts) for ts in zip(*rows))
            for rows in zip(self.tiles, *(o.tiles for o in others))))

    def gather(self, device=None) -> torch.Tensor:
        """The whole lattice on ``device`` (default: shard (0, 0)'s)."""
        dev = device or self.tiles[0][0].device
        return torch.cat([torch.cat([t.to(dev) for t in row], dim=-1)
                          for row in self.tiles], dim=-2)

    def read_lane(self, lane: int, device=None) -> torch.Tensor:
        """Ensemble lane ``lane`` of a batched stack, whole, on ``device``
        (default: shard (0, 0)'s)."""
        dev = device or self.tiles[0][0].device
        return torch.cat([torch.cat([t[lane].to(dev) for t in row], dim=-1)
                          for row in self.tiles], dim=-2)

    def write_lane(self, lane: int, planes) -> None:
        """Overwrite ensemble lane ``lane`` of every shard in place with
        its part of the whole ``(P, H, Wd)`` lattice ``planes`` (a
        tensor, or a number every word takes)."""
        hl, wdl = self.tiles[0][0].shape[-2:]
        for iy, row in enumerate(self.tiles):
            for ix, t in enumerate(row):
                if isinstance(planes, torch.Tensor):
                    t[lane] = planes[..., iy * hl:(iy + 1) * hl,
                                     ix * wdl:(ix + 1) * wdl].to(t.device)
                else:
                    t[lane] = planes


def _ring(n: int, up: bool):
    return [(k, (k + 1) % n) for k in range(n)] if up else \
           [(k, (k - 1) % n) for k in range(n)]


def _ppermute(parts: Grid, axis: int, perm, devices) -> list:
    """``lax.ppermute`` along one axis of the shard grid (0: y, 1: x):
    for each ``(src, dst)`` of ``perm`` the part at index ``src`` moves to
    index ``dst``, onto that slot's device."""
    out = [list(row) for row in parts]
    for src, dst in perm:
        for k in range(len(parts[0]) if axis == 0 else len(parts)):
            (sy, sx), (dy, dx) = (((src, k), (dst, k)) if axis == 0
                                  else ((k, src), (k, dst)))
            out[dy][dx] = parts[sy][sx].to(devices[dy][dx])
    return out


def _exchange_halo(tiles: Grid, d: int, devices) -> Grid:
    """x halo first (one word each side), then y halo on the x-extended
    shards -- the corner words ride along with the y rows."""
    ny, nx = len(tiles), len(tiles[0])
    left = _ppermute([[t[..., -1:] for t in row] for row in tiles], 1,
                     _ring(nx, up=True), devices)
    right = _ppermute([[t[..., :1] for t in row] for row in tiles], 1,
                      _ring(nx, up=False), devices)
    ext = [[torch.cat([a, t, b], dim=-1) for a, t, b in zip(*rows)]
           for rows in zip(left, tiles, right)]
    top = _ppermute([[e[..., -d:, :] for e in row] for row in ext], 0,
                    _ring(ny, up=True), devices)
    bot = _ppermute([[e[..., :d, :] for e in row] for row in ext], 0,
                    _ring(ny, up=False), devices)
    return tuple(tuple(torch.cat([a, e, b], dim=-2) for a, e, b in zip(*rows))
                 for rows in zip(top, ext, bot))


def _psum(parts, device) -> torch.Tensor:
    """The int32 sum of per-shard moments (wrapping like ``lax.psum``)."""
    return prng.wrap_i32(sum(m.to(device, torch.int64) for m in parts))


def make_solid_cache(mesh: Mesh, *, y_axes: Axes = ("data",),
                     x_axis: str = "model", depth: int = 1):
    """Build ``extend(solid) -> solid_ext``: the one-per-geometry halo
    exchange of the static solid plane.

    ``solid`` is the ``(H, Wd)`` packed solid plane (a tensor, or already
    placed); the result holds each shard's ``(hl + 2*depth, wdl + 2)``
    extended tile.  The solid never changes, so the apron stays exact for
    the geometry's lifetime: rebuild only when the geometry changes."""
    sharding = lattice_spec(mesh, y_axes, x_axis)

    def extend(solid) -> ShardedPlanes:
        placed = solid if isinstance(solid, ShardedPlanes) \
            else sharding.place(solid)
        hl = placed.tiles[0][0].shape[-2]
        if depth > hl:
            raise ValueError(f"depth={depth} > local rows {hl}")
        return ShardedPlanes(placed.sharding, _exchange_halo(
            placed.tiles, depth, placed.sharding.devices))

    return extend


def make_sharded_stepper(mesh: Mesh, *, y_axes: Axes = ("data",),
                         x_axis: str = "model", p_force: float = 0.0,
                         depth: int = 1,
                         steps_per_launch: int | None = None,
                         block_rows: int = 0, block_words: int = 0,
                         static_solid: bool = False, overlap: bool = False,
                         variant: str = "fhp2", moments_every: int = 0):
    """Build ``step(planes, t) -> planes`` advancing ``depth`` global steps
    per halo exchange on the :class:`ShardedPlanes` ``planes``.

    Each shard runs ``ops.run_extended`` (``overlap``: its interior /
    boundary split ``run_extended_split``, launched in order) on its
    exchanged extended shard, with ``steps_per_launch`` = T steps per
    launch (default ``min(depth, 8)``) and ``block_rows``/``block_words``
    as the tile (0 = ``ops.pick_tile``'s).  ``planes`` may carry leading
    ensemble-lane axes.

    ``static_solid`` returns ``step(dyn, solid_ext, t) -> dyn`` instead:
    ``dyn`` holds the dynamic planes and ``solid_ext`` is the cached
    extended solid from ``make_solid_cache`` (same depth).

    ``moments_every`` = k > 0 (k must divide ``depth``) makes the stepper
    return ``(planes, moments)``: the rule's ``MomentSpec`` recorded
    in-kernel every k-th step of the round on each shard's own block and
    summed over every shard in int32 -- ``(..., depth // k, n_moments)``
    on shard (0, 0)'s device."""
    if not 1 <= depth <= 31:
        raise ValueError(f"depth={depth}: the x halo is one 32-node word, "
                         f"so 1 <= depth <= 31")
    rule = rulespec.get_rule(variant)
    if static_solid and rule.solid_plane is None:
        raise ValueError(f"rule {variant!r} has no solid plane: "
                         f"static_solid unavailable")
    if p_force and rule.force is None:
        raise ValueError(f"rule {variant!r} has no force pass: p_force=0")
    k = int(moments_every)
    if k and depth % k:
        raise ValueError(f"moments_every={k} must divide depth={depth}")
    sharding = lattice_spec(mesh, y_axes, x_axis)
    ny, nx = sharding.ny, sharding.nx
    advance = ops.run_extended_split if overlap else ops.run_extended

    def chunk(planes: ShardedPlanes, solid_ext, t: int):
        hl, wdl = planes.tiles[0][0].shape[-2:]
        d = depth
        # The ring reaches nearest neighbours only: a depth-d apron must
        # fit in one shard's rows.
        if d > hl:
            raise ValueError(f"depth={d} > local rows hl={hl}: the halo "
                             f"would need rows beyond the nearest shard")
        ext = _exchange_halo(planes.tiles, d, sharding.devices)
        rows, moms = [], []
        for iy in range(ny):
            row = []
            for ix in range(nx):
                sol = solid_ext.tiles[iy][ix] if static_solid else None
                if sol is not None and tuple(sol.shape) != (hl + 2 * d,
                                                            wdl + 2):
                    raise ValueError(f"solid_ext tile {tuple(sol.shape)} "
                                     f"is not of depth {d}")
                out = advance(ext[iy][ix], d, t0=t, p_force=p_force,
                              y0=iy * hl - d, xw0=ix * wdl - 1,
                              hg=ny * hl, wdg=nx * wdl,
                              steps_per_launch=steps_per_launch,
                              block_rows=block_rows, block_words=block_words,
                              solid_ext=sol, variant=variant,
                              moments_every=k)
                if k:
                    out, m = out
                    moms.append(m)
                row.append(out[..., d:d + hl, 1:1 + wdl])
            rows.append(tuple(row))
        out = ShardedPlanes(sharding, tuple(rows))
        if k:
            return out, _psum(moms, sharding.devices[0][0])
        return out

    if static_solid:
        return chunk
    return lambda planes, t: chunk(planes, None, t)


def make_run(mesh: Mesh, steps: int, *, batched: bool = False, **kw):
    """``run(planes, t0)`` advancing ``steps`` global steps in rounds of
    ``depth`` (``kw`` as ``make_sharded_stepper``'s); ``batched`` marks a
    ``(B, P, H, Wd)`` ensemble stack.

    ``planes`` is a tensor (placed on the mesh, and the result gathered
    back onto its device) or :class:`ShardedPlanes` (the result stays
    sharded).  With ``static_solid=True`` the caller still passes the full
    stack: the solid plane is split off, its apron exchanged once
    (``make_solid_cache``), the rounds advance the dynamic planes against
    the cached tile, and the unchanged solid plane is put back.  Batched
    stacks share lane 0's geometry.

    With ``moments_every`` = k (must divide ``depth``) the result is
    ``(planes, moments)``, ``moments`` ``(..., steps // k, n_moments)``
    int32 on the device of the result (of shard (0, 0) when sharded)."""
    depth = kw.get("depth", 1)
    static_solid = kw.get("static_solid", False)
    rule = rulespec.get_rule(kw.get("variant", "fhp2"))
    sp = rule.solid_plane
    k = int(kw.get("moments_every", 0))
    if steps % depth:
        raise ValueError(f"steps={steps} is not a multiple of depth={depth}")
    stepper = make_sharded_stepper(mesh, **kw)
    sharding = lattice_spec(mesh, kw.get("y_axes", ("data",)),
                            kw.get("x_axis", "model"))
    if k:
        mspec = rulespec.moment_spec(
            rule, stack_planes=rule.n_planes - 1 if static_solid else None)

    def loop(state: ShardedPlanes, step_round):
        moms = []
        for i in range(steps // depth):
            state = step_round(i, state)
            if k:
                state, m = state
                moms.append(m)
        if not k:
            return state
        lead = state.tiles[0][0].shape[:-3]
        mom = (torch.cat(moms, dim=-2) if moms else torch.zeros(
            lead + (0, mspec.n_moments), dtype=torch.int32,
            device=sharding.devices[0][0]))
        return state, mom

    if static_solid:
        cache = make_solid_cache(mesh, y_axes=kw.get("y_axes", ("data",)),
                                 x_axis=kw.get("x_axis", "model"),
                                 depth=depth)

    def run(planes, t0: int = 0):
        sharded = isinstance(planes, ShardedPlanes)
        placed = planes if sharded else sharding.place(planes)
        if not static_solid:
            out = loop(placed, lambda i, s: stepper(s, t0 + i * depth))
        else:
            dyn = placed.map(lambda x: x[..., :sp, :, :])
            solid = placed.map(lambda x: x[..., sp, :, :])
            if batched:
                solid = solid.map(lambda x: x[0])   # lanes share the geometry
            solid_ext = cache(solid)                # one exchange per geometry
            out = loop(dyn, lambda i, s: stepper(s, solid_ext,
                                                 t0 + i * depth))
            dyn_out = out[0] if k else out
            whole = dyn_out.map(lambda a, b: torch.cat(
                [a, b[..., sp:, :, :]], dim=-3), placed)
            out = (whole, out[1]) if k else whole
        if sharded:
            return out
        if k:
            return out[0].gather(planes.device), out[1].to(planes.device)
        return out.gather(planes.device)

    return run


def make_ensemble_run(mesh, steps: int, *, variant: str = "fhp2",
                      p_force: float = 0.0, depth: int = 1,
                      steps_per_launch: int | None = None,
                      block_rows: int = 0, block_words: int = 0,
                      overlap: bool = False, y_axes: Axes = ("data",),
                      x_axis: str = "model", moments_every: int = 0):
    """``(run, sharding)`` for a batched ``(B, n_planes, H, Wd)`` ensemble:
    the serve engine's one entry point for advancing a lane group.

    ``run(planes, t0)`` advances every lane ``steps`` steps under
    ``variant``.  Lanes are independent and the RNG counters carry no lane
    index, so each lane is bit-identical to the unbatched reference at the
    same ``t`` window.

    ``mesh=None`` is the single-device path (``sharding`` is None): every
    step through ``ops.run_cuda`` -- on a CUDA tensor the fused kernel, on
    a CPU tensor its plain version (``depth`` and ``overlap`` do not
    apply).  With a :class:`Mesh`, ``make_run``'s sharded halo-exchange
    stepper runs with the given ``(depth, T, tile, overlap)`` point and
    ``sharding`` is the :class:`LatticeSharding` to place states
    with (``run`` takes a tensor or :class:`ShardedPlanes`).

    ``moments_every`` = k > 0 makes ``run`` return ``(planes, moments)``
    with ``moments`` the per-lane ``(B, steps // k, n_moments)`` int32
    ``MomentSpec`` time series (``rulespec.moment_spec(rule)``); on a mesh
    k must divide ``depth``."""
    k = int(moments_every)
    if mesh is None:
        def run(planes, t0: int = 0):
            return ops.run_cuda(planes, steps, p_force=p_force, t0=t0,
                                steps_per_launch=steps_per_launch or 1,
                                block_rows=block_rows,
                                block_words=block_words, variant=variant,
                                moments_every=k)

        return run, None
    run = make_run(mesh, steps, y_axes=y_axes, x_axis=x_axis,
                   p_force=p_force, depth=depth, batched=True,
                   steps_per_launch=steps_per_launch, block_rows=block_rows,
                   block_words=block_words, overlap=overlap,
                   variant=variant, moments_every=k)
    return run, lattice_spec(mesh, y_axes, x_axis)
