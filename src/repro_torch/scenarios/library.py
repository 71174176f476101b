"""The built-in scenario library: the classic FHP flows, each scalable
to any (even H, W % 32 == 0) lattice so CI smoke sweeps, examples, and
production runs share one definition.

Obstacle dimensions derive from the lattice shape (radius ~ H/9 etc.),
matching the hand-rolled demos these scenarios replace at their default
sizes.  All geometry rasterizes in global coordinates (shard-exact).
"""
from __future__ import annotations

from repro_torch.geometry import (Disk, Empty, ObstacleArray, PorousMedium,
                            Rectangle, channel_walls)
from repro_torch.scenarios.base import Scenario
from repro_torch.scenarios.registry import register


@register("cylinder")
def cylinder(height: int = 96, width: int = 384, radius: int | None = None,
             density: float = 0.22, p_force: float = 0.03,
             seed: int = 0, variant: str = "fhp2") -> Scenario:
    """Flow past a cylinder: wake deficit + bypass acceleration.
    ``variant`` selects the collision circuit (fhp2 / fhp3)."""
    r = radius if radius is not None else max(2, height // 9)
    disk = Disk(height // 2, width // 4, r)
    return Scenario(
        name="cylinder", height=height, width=width,
        geometry=channel_walls(height) | disk,
        density=density, p_force=p_force, seed=seed, variant=variant,
        description="driven channel with a solid disk (wake behind it)",
        obstacles=(("disk", disk),))


@register("poiseuille")
def poiseuille(height: int = 64, width: int = 512, density: float = 0.2,
               p_force: float = 0.02, seed: int = 1,
               variant: str = "fhp2") -> Scenario:
    """Body-forced channel: parabolic velocity profile."""
    return Scenario(
        name="poiseuille", height=height, width=width,
        geometry=channel_walls(height),
        density=density, p_force=p_force, seed=seed, variant=variant,
        description="plane channel, weak body force, parabolic profile")


@register("backward_step")
def backward_step(height: int = 64, width: int = 512, density: float = 0.2,
                  p_force: float = 0.03, seed: int = 2) -> Scenario:
    """Backward-facing step: the inlet floor is raised to mid-channel
    for the first quarter of the domain, then drops away."""
    step = Rectangle(0, height // 2, 0, width // 4)
    return Scenario(
        name="backward_step", height=height, width=width,
        geometry=channel_walls(height) | step,
        density=density, p_force=p_force, seed=seed,
        description="channel expansion behind a half-height inlet step",
        obstacles=(("step", step),))


@register("porous_plug")
def porous_plug(height: int = 64, width: int = 512, fraction: float = 0.12,
                density: float = 0.2, p_force: float = 0.03,
                seed: int = 3) -> Scenario:
    """Forced flow through a seeded porous plug spanning the channel."""
    plug = PorousMedium(1, height - 1, width // 3, width // 2,
                        fraction=fraction, seed=seed)
    return Scenario(
        name="porous_plug", height=height, width=width,
        geometry=channel_walls(height) | plug,
        density=density, p_force=p_force, seed=seed,
        description="random solid matrix across the channel mid-section",
        obstacles=(("plug", plug),))


@register("cavity")
def cavity(height: int = 64, width: int = 256, density: float = 0.2,
           p_force: float = 0.02, seed: int = 4) -> Scenario:
    """Forced cavity: a closed box (side walls break the x wrap) with
    the global body force playing the lid -- the lid-driven-style
    recirculating workload."""
    box = (channel_walls(height)
           | Rectangle(0, height, 0, 1)
           | Rectangle(0, height, width - 1, width))
    return Scenario(
        name="cavity", height=height, width=width, geometry=box,
        density=density, p_force=p_force, seed=seed,
        description="closed box, body-forced recirculation")


@register("bml_city")
def bml_city(height: int = 128, width: int = 128, density: float = 0.3,
             seed: int = 6) -> Scenario:
    """Biham--Middleton--Levine traffic on an obstacle-free square torus:
    east and north cars at ``density`` total (rho/2 each species).  The
    headline observable is ``observables.jam_fraction`` -- below the
    critical density cars self-organize into free flow (jam fraction
    -> 0); above it a global jam forms.  ``variant="bml"`` routes every
    stepping path through the 2-plane deterministic rule (no RNG, no
    solid plane, no forcing)."""
    return Scenario(
        name="bml_city", height=height, width=width, geometry=Empty(),
        density=density, p_force=0.0, seed=seed, variant="bml",
        description="BML traffic torus: jam/free-flow phase transition")


@register("cylinder_array")
def cylinder_array(height: int = 96, width: int = 384,
                   radius: int | None = None, density: float = 0.22,
                   p_force: float = 0.03, seed: int = 5) -> Scenario:
    """Staggered-pitch array of disks filling the channel interior (a
    tube-bank / heat-exchanger-like obstacle lattice)."""
    r = radius if radius is not None else max(2, height // 12)
    pitch_y = max(8, height // 3)
    pitch_x = max(8, width // 6)
    array = (ObstacleArray(height // 2, width // 8, r, pitch_y, pitch_x)
             & Rectangle(2 * r, height - 2 * r, 0, width))
    return Scenario(
        name="cylinder_array", height=height, width=width,
        geometry=channel_walls(height) | array,
        density=density, p_force=p_force, seed=seed,
        description="periodic disk array in a driven channel",
        obstacles=(("array", array),))
