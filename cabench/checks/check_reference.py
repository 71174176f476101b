"""The plain reference against the program's plain CPU path at small
sizes: the same bits, moments and initial lattices; and its control
differs."""
from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from cabench import harness
from cabench.drivers import ensemble
from cabench.reference import lattice, scenarios

sys.path.insert(0, str(harness.ROOT / "src"))


def _random_planes(n_planes, seed, b=2, h=16, w=128):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-2 ** 31, 2 ** 31, (b, n_planes, h, w // 32),
                      dtype=torch.int64, generator=g).to(torch.int32)
    if n_planes == 8:
        x[:, :7] &= ~x[:, 7:8]
    else:
        x[:, 1] &= ~x[:, 0]
    return x


@pytest.mark.parametrize("rule,p_force,t0", [("fhp2", 0.03, 40),
                                             ("fhp2", 0.0, 3),
                                             ("bml", 0.0, 7)])
def test_reference_matches_the_plain_path(rule, p_force, t0):
    from repro_torch.core import distributed
    x = _random_planes(lattice.N_BITS[rule], t0)
    run, _ = distributed.make_ensemble_run(
        None, 16, variant=rule, p_force=p_force, steps_per_launch=8,
        moments_every=8)
    out, mom = run(x, t0)
    ref, rec = lattice.run(lattice.to_bytes(x), rule, t0, 16,
                           p_force=p_force, record_every=8)
    assert lattice.sites_differing(lattice.to_bytes(out), ref) == 0
    assert torch.equal(mom.to(torch.int64),
                       torch.stack([r for _, r in rec], dim=-2))
    assert torch.equal(lattice.to_planes(ref, x.shape[-3]), out)


def test_control_differs():
    x = _random_planes(8, 5)
    ref, _ = lattice.run(lattice.to_bytes(x), "fhp2", 0, 8, p_force=0.03)
    ctl, _ = lattice.run(lattice.to_bytes(x), "fhp2", 0, 8, p_force=0.03,
                         force_bits=8)
    assert lattice.force_threshold(0.03) == 1966
    assert lattice.force_threshold(0.03, 8) == 8
    assert lattice.sites_differing(ref, ctl) > 0


@pytest.mark.parametrize("name,density", [("cylinder", 0.22),
                                          ("cylinder", 0.4),
                                          ("bml_city", 0.3),
                                          ("bml_city", 0.45)])
def test_initial_lattices_match_the_scenarios(name, density):
    from repro_torch import scenarios as program
    seed = 2 ** 43 + 17
    got = program.get(name, height=36, width=256, seed=seed,
                      density=density).initial_planes(device="cpu",
                                                      chunk_rows=5)
    want = scenarios.initial_state(name, 36, 256, seed, density)
    assert lattice.sites_differing(lattice.to_bytes(got), want) == 0


def test_ensemble_geometry_is_the_cylinder():
    cfg = {"height": 36, "width": 256, "geometry": {"kind": "cylinder",
                                                    "radius_div": 9}}
    solid = lattice.to_bytes(ensemble.solid_words(cfg, "cpu")[None])
    assert np.array_equal(solid.numpy().astype(bool),
                          scenarios.cylinder_solid(36, 256))


def test_table_conserves_and_reverses():
    table = lattice.fhp2_table()
    assert table.shape == (2, 256)
    assert table[0, 0b001001] == 0b010010 and table[1, 0b001001] == 0b100100
    assert table[0, 0x80 | 0b000011] == 0x80 | 0b011000
