"""Pluggable bit-sliced CA rule specs: one blocked substrate, many automata.

A :class:`RuleSpec` captures the per-rule residue of the blocked stepper:

* ``n_planes``     -- how many bit planes one node carries;
* ``taps``         -- the streaming stencil: which plane moves where, with
                      the row-parity-dependent x offsets of the triangular
                      lattice (``|dx| <= 1``, ``|dy| <= 1``);
* ``collide``      -- the pointwise boolean collision pass over the
                      streamed taps (FHP: generated from ``core.rules``;
                      BML: two alternating deterministic sub-steps);
* ``needs_rng``    -- whether the circuit consumes chirality bits;
* ``n_substeps``   -- the sub-step schedule length (BML alternates 2);
* ``solid_plane``  -- index of the static geometry plane, or None;
* ``force``        -- the optional body-force pass (FHP only).

Registered rules: ``fhp2``, ``fhp3`` (8 planes, RNG, solid plane 7) and
``bml`` (2 planes, no RNG, east cars move on even t, north cars on odd t).
Every spec carries its byte oracle (``oracle_step``), a seeded byte
initial state (``init_bytes``) and the same fill straight into packed
words, drawn in row chunks (``init_planes``).

The circuits are plain functions of operands that support ``& | ^ ~``, so
the same code runs on torch int32 tensors and on the symbolic words from
which ``kernels/fhp_step/codegen.py`` emits the CUDA circuits.  The step
``t`` is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitplane, boolean, prng, rules

WORD = 32


@dataclasses.dataclass(frozen=True)
class Tap:
    """One streaming read: ``plane`` moves by ``offsets[parity]``,
    ``((dx_even, dy), (dx_odd, dy))`` with ``|dx|, |dy| <= 1``."""

    plane: int
    offsets: Tuple[Tuple[int, int], Tuple[int, int]]

    def __post_init__(self):
        (dx0, dy0), (dx1, dy1) = self.offsets
        if dy0 != dy1:
            raise ValueError("the y offset may not depend on row parity")
        if not all(abs(d) <= 1 for d in (dx0, dx1, dy0)):
            raise ValueError(f"tap offsets exceed one node: {self.offsets}")


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    """A complete bit-sliced CA rule (see module docstring).

    ``collide(streamed, chi, t)`` maps the streamed tap list to the
    ``n_planes`` output planes; ``chi`` is None when ``needs_rng`` is
    False.  ``mass_planes`` are the planes whose popcount sum is the
    conserved particle count; ``per_plane_conserved`` claims each is
    separately conserved; ``exclusive_planes`` may never overlap."""

    name: str
    n_planes: int
    taps: Tuple[Tap, ...]
    collide: Callable
    needs_rng: bool
    oracle_step: Callable
    init_bytes: Callable[[int, int, float, int], np.ndarray]
    init_planes: Callable[[int, int, float, int, int], np.ndarray]
    n_substeps: int = 1
    solid_plane: Optional[int] = None
    force: Optional[Callable] = None
    conserves_mass: bool = True
    conserves_momentum: bool = False
    mass_planes: Tuple[int, ...] = ()
    per_plane_conserved: bool = False
    exclusive_planes: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.n_planes < 1 or any(not 0 <= tap.plane < self.n_planes
                                    for tap in self.taps):
            raise ValueError(f"rule {self.name!r}: taps outside the planes")
        if self.solid_plane is not None and \
                self.solid_plane != self.n_planes - 1:
            raise ValueError("the solid plane must be the last plane "
                             "(static-solid layout)")

    def byte_mask(self) -> int:
        """Mask of the state bits this rule uses in the byte encoding."""
        return (1 << self.n_planes) - 1


_REGISTRY: Dict[str, RuleSpec] = {}


def register_rule(spec: RuleSpec) -> RuleSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"rule {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_rule(name: str) -> RuleSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown rule {name!r}; "
                         f"registered: {sorted(_REGISTRY)}") from None


def rule_names() -> List[str]:
    return sorted(_REGISTRY)


def _pack_rows(bits: np.ndarray) -> np.ndarray:
    """(rows, W) bool -> (rows, W//32) uint32, bit b of word w = node 32w+b."""
    packed = np.packbits(bits, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4")


def _row_chunks(h: int, rows: int):
    for y0 in range(0, h, rows):
        yield y0, min(h, y0 + rows)


# ---------------------------------------------------------------------------
# FHP-II / FHP-III.
# ---------------------------------------------------------------------------

def _fhp_taps() -> Tuple[Tap, ...]:
    taps = [Tap(k, rules.OFFSETS[k]) for k in range(rules.N_DIR)]
    stay = ((0, 0), (0, 0))
    taps.append(Tap(rules.REST_BIT, stay))
    taps.append(Tap(rules.SOLID_BIT, stay))
    return tuple(taps)


def _fhp_spec(variant: str) -> RuleSpec:
    def collide(streamed, chi, t):
        return boolean.collide_planes(streamed, chi, variant)

    def oracle_step(state, t, chi=None):
        from repro_torch.core import byte_step
        return byte_step.step_bytes(state, t, chi=chi, variant=variant)

    def init_bytes(h, w, density, seed):
        rng = np.random.default_rng(seed)
        occ = (rng.random((7, h, w)) < density).astype(np.uint8)
        state = np.zeros((h, w), dtype=np.uint8)
        for i in range(7):
            state |= occ[i] << i
        return state

    def init_planes(h, w, density, seed, rows):
        # The same stream as ``init_bytes``: one (7, h, w) draw is plane
        # after plane, row after row, so row chunks reproduce it exactly.
        rng = np.random.default_rng(seed)
        out = np.zeros((8, h, w // WORD), np.uint32)
        for i in range(7):
            for a, b in _row_chunks(h, rows):
                out[i, a:b] = _pack_rows(rng.random((b - a, w)) < density)
        return out

    return RuleSpec(
        name=variant, n_planes=8, taps=_fhp_taps(), collide=collide,
        needs_rng=True, oracle_step=oracle_step, init_bytes=init_bytes,
        init_planes=init_planes, n_substeps=1, solid_plane=rules.SOLID_BIT,
        force=boolean.force_planes,
        conserves_mass=True, conserves_momentum=True,
        mass_planes=tuple(range(7)), per_plane_conserved=False)


# ---------------------------------------------------------------------------
# BML traffic (Biham--Middleton--Levine): plane 0 = east-bound cars, plane
# 1 = north-bound cars.  To *read* the neighbour at x+1 a tap moves the
# plane by dx=-1 (the streamed value at x is the source at x-dx).
# ---------------------------------------------------------------------------

_BML_TAPS = (
    Tap(0, ((1, 0), (1, 0))),      # E arriving from x-1
    Tap(0, ((0, 0), (0, 0))),      # E in place
    Tap(0, ((-1, 0), (-1, 0))),    # E at x+1  (east-bound occupancy ahead)
    Tap(0, ((0, -1), (0, -1))),    # E at y+1  (north-bound occupancy ahead)
    Tap(1, ((0, 0), (0, 0))),      # N in place
    Tap(1, ((-1, 0), (-1, 0))),    # N at x+1
    Tap(1, ((0, 1), (0, 1))),      # N arriving from y-1
    Tap(1, ((0, -1), (0, -1))),    # N at y+1
)


def _bml_collide(streamed, chi, t: int):
    """One BML sub-step: even t moves east cars, odd t moves north cars.
    A car advances iff its destination cell was empty before the sub-step;
    the other species is frozen.  ``t`` is a Python int, so the sub-step
    is picked here instead of selected per word."""
    eW, e0, eE, eU, n0, nE, nS, nU = streamed
    occ0 = e0 | n0                  # own cell, pre-move
    if int(t) % 2 == 0:
        occ_x1 = eE | nE            # cell at x+1, pre-move
        return [(e0 & occ_x1) | (eW & ~occ0), n0]
    occ_y1 = eU | nU                # cell at y+1, pre-move
    return [e0, (n0 & occ_y1) | (nS & ~occ0)]


def bml_step_bytes(state: torch.Tensor, t: int, chi=None) -> torch.Tensor:
    """Byte oracle for one BML sub-step on a (H, W) uint8 torus (bit 0 =
    east-bound car, bit 1 = north-bound car; ``chi`` is ignored)."""
    s = state.to(torch.uint8)
    e = (s & 1) != 0
    n = (s & 2) != 0
    occ = e | n
    if int(t) % 2 == 0:
        move_e = e & ~torch.roll(occ, -1, dims=-1)
        e = (e & ~move_e) | torch.roll(move_e, 1, dims=-1)
    else:
        move_n = n & ~torch.roll(occ, -1, dims=-2)
        n = (n & ~move_n) | torch.roll(move_n, 1, dims=-2)
    return e.to(torch.uint8) | (n.to(torch.uint8) << 1)


def bml_init_bytes(h: int, w: int, density: float, seed: int) -> np.ndarray:
    """Seeded exclusive fill: each cell holds one east car (prob rho/2),
    one north car (prob rho/2), or nothing."""
    rng = np.random.default_rng(seed)
    u = rng.random((h, w))
    return np.where(u < density / 2, np.uint8(1),
                    np.where(u < density, np.uint8(2), np.uint8(0)))


def bml_init_planes(h: int, w: int, density: float, seed: int,
                    rows: int) -> np.ndarray:
    """``bml_init_bytes`` packed, drawn in row chunks of the same stream."""
    rng = np.random.default_rng(seed)
    out = np.zeros((2, h, w // WORD), np.uint32)
    for a, b in _row_chunks(h, rows):
        u = rng.random((b - a, w))
        out[0, a:b] = _pack_rows(u < density / 2)
        out[1, a:b] = _pack_rows((u >= density / 2) & (u < density))
    return out


register_rule(_fhp_spec("fhp2"))
register_rule(_fhp_spec("fhp3"))
register_rule(RuleSpec(
    name="bml", n_planes=2, taps=_BML_TAPS, collide=_bml_collide,
    needs_rng=False, oracle_step=bml_step_bytes, init_bytes=bml_init_bytes,
    init_planes=bml_init_planes, n_substeps=2, solid_plane=None, force=None,
    conserves_mass=True, conserves_momentum=False,
    mass_planes=(0, 1), per_plane_conserved=True,
    exclusive_planes=(0, 1)))


# ---------------------------------------------------------------------------
# Generic periodic bit-plane stepper (the plain version the kernel is held
# against).
# ---------------------------------------------------------------------------

def stream_taps(planes: torch.Tensor, taps: Sequence[Tap],
                row0: int = 0) -> List[torch.Tensor]:
    """Streamed tap values on packed planes (periodic both axes).

    Destination-centric: result[i] at (y, x) is ``taps[i].plane`` at
    (y - dy, x - dx) with dx selected by the *source* row parity (``row0``
    = global row of local row 0)."""
    h = planes.shape[-2]
    rows = torch.arange(h, device=planes.device) + int(row0)
    even = ((rows & 1) == 0)[:, None]
    out = []
    for tap in taps:
        p = planes[..., tap.plane, :, :]
        (dx0, dy), (dx1, _) = tap.offsets
        if dx0 == dx1:
            moved = bitplane.shift_x(p, dx0)
        else:
            moved = torch.where(even, bitplane.shift_x(p, dx0),
                                bitplane.shift_x(p, dx1))
        out.append(torch.roll(moved, dy, dims=-2) if dy else moved)
    return out


def step_planes_rule(planes: torch.Tensor, t: int, spec: RuleSpec,
                     p_force: float = 0.0, y0: int = 0, xw0: int = 0, *,
                     chi=None, accel=None) -> torch.Tensor:
    """One fused update of ``spec`` on packed ``(..., n_planes, H, Wd)``
    planes: stream the taps, run the collision circuit, apply the
    optional force pass."""
    if planes.shape[-3] != spec.n_planes:
        raise ValueError(f"{tuple(planes.shape)}: rule {spec.name!r} "
                         f"has {spec.n_planes} planes")
    shape_words = planes.shape[-2:]
    streamed = stream_taps(planes, spec.taps, row0=y0)
    if spec.needs_rng and chi is None:
        chi = prng.chirality_words(shape_words, t, y0=y0, xw0=xw0,
                                   device=planes.device)
    out = spec.collide(streamed, chi if spec.needs_rng else None, t)
    if p_force or accel is not None:
        if spec.force is None:
            raise ValueError(f"rule {spec.name!r} has no force pass")
        if accel is None:
            accel = prng.bernoulli_words(shape_words, t, p_force, y0=y0,
                                         xw0=xw0, device=planes.device)
        out = spec.force(out, accel)
    return torch.stack(out, dim=-3)


def run_planes_rule(planes: torch.Tensor, steps: int, spec: RuleSpec,
                    p_force: float = 0.0, t0: int = 0) -> torch.Tensor:
    for i in range(int(steps)):
        planes = step_planes_rule(planes, t0 + i, spec, p_force)
    return planes


# ---------------------------------------------------------------------------
# Invariant audits: exact conservation laws checked by popcount reductions.
# ---------------------------------------------------------------------------

def _pop(p: torch.Tensor) -> torch.Tensor:
    return bitplane.popcount(p).sum(dim=(-2, -1), dtype=torch.int64)


def invariants(spec: RuleSpec, planes: torch.Tensor, *,
               with_momentum: bool = False) -> Dict[str, torch.Tensor]:
    """Per-lane conserved quantities of ``spec`` on packed planes: ``mass``,
    ``plane{i}`` (per-plane conserved rules), ``solid``, and ``px2``/``py``
    when ``with_momentum`` (only an invariant on a free, unforced torus)."""
    if planes.shape[-3] != spec.n_planes:
        raise ValueError(f"{tuple(planes.shape)}: rule {spec.name!r}")
    out: Dict[str, torch.Tensor] = {}
    if spec.conserves_mass and spec.mass_planes:
        counts = [_pop(planes[..., i, :, :]) for i in spec.mass_planes]
        out["mass"] = sum(counts[1:], counts[0])
        if spec.per_plane_conserved:
            for i, c in zip(spec.mass_planes, counts):
                out[f"plane{i}"] = c
    if spec.solid_plane is not None:
        out["solid"] = _pop(planes[..., spec.solid_plane, :, :])
    if with_momentum and spec.conserves_momentum:
        px2 = torch.zeros(planes.shape[:-3], dtype=torch.int64,
                          device=planes.device)
        py = torch.zeros_like(px2)
        for i in range(rules.N_DIR):
            c = _pop(planes[..., i, :, :])
            px2 = px2 + c * int(rules.CX2[i])
            py = py + c * int(rules.CY[i])
        out["px2"], out["py"] = px2, py
    return out


def integrity_ok(spec: RuleSpec, planes: torch.Tensor) -> torch.Tensor:
    """Per-lane boolean: no cell carries two ``exclusive_planes`` species."""
    ok = torch.ones(planes.shape[:-3], dtype=torch.bool, device=planes.device)
    exc = spec.exclusive_planes
    for a in range(len(exc)):
        for b in range(a + 1, len(exc)):
            overlap = planes[..., exc[a], :, :] & planes[..., exc[b], :, :]
            ok = ok & (_pop(overlap) == 0)
    return ok


def audit(spec: RuleSpec, planes: torch.Tensor, expected: Dict[str, object],
          *, with_momentum: bool = False) -> Dict[str, Tuple]:
    """``{name: (expected, found)}`` for every violated invariant (empty
    dict == clean); ``integrity`` appears when a structural check fails."""
    found = invariants(spec, planes, with_momentum=with_momentum)
    bad = {}
    for name, want in expected.items():
        if name not in found:
            continue
        got = found[name].cpu()
        want_t = torch.as_tensor(np.asarray(want), dtype=got.dtype)
        if not bool((got == want_t).all()):
            bad[name] = (np.asarray(want).tolist(), got.tolist())
    if not bool(integrity_ok(spec, planes).all()):
        bad["integrity"] = (True, False)
    return bad


# ---------------------------------------------------------------------------
# Moments: ``moments = coeffs @ popcount(terms)``, the layout the kernel
# accumulates in-block and the serve engine's audits read.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MomentSpec:
    """Static moment layout: ``names[r]`` labels row ``r``; ``terms[t]`` is
    ``(p,)`` (plane popcount) or ``(a, b)`` (pairwise-AND popcount);
    ``coeffs[r][t]`` the int weight of term ``t`` in row ``r``."""

    names: Tuple[str, ...]
    terms: Tuple[Tuple[int, ...], ...]
    coeffs: Tuple[Tuple[int, ...], ...]

    @property
    def n_moments(self) -> int:
        return len(self.names)

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    def row(self, name: str) -> int:
        return self.names.index(name)


def moment_spec(spec: RuleSpec,
                stack_planes: Optional[int] = None) -> MomentSpec:
    """The :class:`MomentSpec` of ``spec`` on a ``stack_planes``-plane
    stack (default ``spec.n_planes``; ``n_planes - 1`` is the static-solid
    dynamic stack, which drops the ``solid`` row)."""
    np_ = spec.n_planes if stack_planes is None else stack_planes
    terms: List[Tuple[int, ...]] = []

    def term(t: Tuple[int, ...]) -> int:
        if t not in terms:
            terms.append(t)
        return terms.index(t)

    rows: List[Tuple[str, Dict[int, int]]] = []
    if spec.conserves_mass and spec.mass_planes:
        rows.append(("mass", {term((p,)): 1 for p in spec.mass_planes}))
        if spec.per_plane_conserved:
            for p in spec.mass_planes:
                rows.append((f"plane{p}", {term((p,)): 1}))
    if spec.solid_plane is not None and spec.solid_plane < np_:
        rows.append(("solid", {term((spec.solid_plane,)): 1}))
    if spec.conserves_momentum:
        rows.append(("px2", {term((i,)): int(rules.CX2[i])
                             for i in range(rules.N_DIR)}))
        rows.append(("py", {term((i,)): int(rules.CY[i])
                            for i in range(rules.N_DIR)}))
    exc = spec.exclusive_planes
    for a in range(len(exc)):
        for b in range(a + 1, len(exc)):
            rows.append((f"excl{exc[a]}_{exc[b]}",
                         {term((exc[a], exc[b])): 1}))
    if any(p >= np_ for t in terms for p in t):
        raise ValueError(f"rule {spec.name!r}: moment terms {terms} "
                         f"need more than {np_} planes")
    coeffs = tuple(tuple(row.get(ti, 0) for ti in range(len(terms)))
                   for _, row in rows)
    return MomentSpec(names=tuple(n for n, _ in rows),
                      terms=tuple(terms), coeffs=coeffs)


def compute_moments(planes: torch.Tensor, ms: MomentSpec) -> torch.Tensor:
    """The moments of packed ``(..., P, H, Wd)`` planes as ``(...,
    n_moments)`` int32 -- int32 wrap-around like the kernel's native
    accumulator (``require_moment_headroom`` guards overflow)."""
    vals = []
    for t in ms.terms:
        p = planes[..., t[0], :, :]
        if len(t) == 2:
            p = p & planes[..., t[1], :, :]
        vals.append(_pop(p))
    tv = torch.stack(vals, dim=-1)                              # (..., terms)
    c = torch.tensor(ms.coeffs, dtype=torch.int64, device=planes.device)
    return prng.wrap_i32((tv[..., None, :] * c).sum(dim=-1))


def moments_dict(ms: MomentSpec, values) -> Dict[str, object]:
    """``{name: values[..., r]}`` view of a moments array/record."""
    return {name: values[..., r] for r, name in enumerate(ms.names)}


def moment_headroom(ms: MomentSpec, n_sites: int) -> int:
    """Worst-case |moment| on an ``n_sites``-node lattice."""
    return max((sum(abs(c) for c in row) for row in ms.coeffs), default=0) \
        * n_sites


def require_moment_headroom(ms: MomentSpec, n_sites: int) -> None:
    """Refuse moment accumulation that could overflow int32."""
    worst = moment_headroom(ms, n_sites)
    if worst >= 2 ** 31:
        raise ValueError(
            f"moment accumulator overflow: worst-case |moment| {worst} "
            f">= 2**31 on a {n_sites}-site lattice (int32 in-kernel "
            f"accumulation); use the post-hoc invariants path")


def oracle_run(state: torch.Tensor, steps: int, spec: RuleSpec,
               t0: int = 0) -> torch.Tensor:
    """Advance the byte oracle ``steps`` steps, drawing the *word-RNG*
    chirality stream (expanded to bytes) for rules that need it."""
    s = state
    h, w = s.shape[-2:]
    shifts = torch.arange(WORD, dtype=torch.int32, device=s.device)
    for k in range(int(steps)):
        chi = None
        if spec.needs_rng:
            chi_w = prng.chirality_words((h, w // WORD), t0 + k,
                                         device=s.device)
            chi = ((chi_w[..., None] >> shifts) & 1).to(torch.uint8)
            chi = chi.reshape(h, w)
        s = spec.oracle_step(s, t0 + k, chi=chi)
    return s
