"""Closed loop of one caller of the ensemble path: each call advances every
lane ``steps_per_call`` steps through ``make_ensemble_run``'s ``run`` on
the previous call's output, its step counter advancing by as much.

The lanes are made on the device from the seed: each of the 7 particle
bits of every fluid node set with probability ``density``, the geometry's
nodes solid.  Calls are issued back to back, with one call in flight
behind the one being issued, so the host never runs far ahead of the card
and the card never waits for a synchronise.

``correct`` compares the output planes and fused moments of sampled calls
(one drawn from the seed among the first ``check_first_calls`` of the
window, and the window's last) with the plain reference stepped from the
same input.

Hooks: ``make_run`` replaces ``make_ensemble_run`` (faults, the control).
"""
from __future__ import annotations

import random
import time

import torch

from cabench.reference import lattice

LANE_BLOCK = 4
CONFIG_KEYS = ("rule", "lanes", "height", "width", "geometry", "density",
               "p_force", "steps_per_call", "steps_per_launch",
               "moments_every")
TRAFFIC_KEYS = ("warmup_calls", "check_first_calls")


def solid_words(cfg: dict, device) -> torch.Tensor:
    """(H, W/32) int32 solid plane of the configuration's geometry:
    ``none``; ``channel``, the walls (rows 0 and H-1); or ``cylinder``, the
    walls and the disk of radius H // ``radius_div`` at (H/2, W/4) in the
    triangular metric."""
    h, w = cfg["height"], cfg["width"]
    solid = torch.zeros((h, w // 32), dtype=torch.int32, device=device)
    geom = cfg["geometry"]
    if geom["kind"] == "none":
        return solid
    solid[0] = solid[h - 1] = -1
    if geom["kind"] == "cylinder":
        r = max(2, h // geom["radius_div"])
        cy, cx = h // 2, w // 4
        y0, y1 = cy - r - 1, cy + r + 2
        x0, x1 = (cx - r - 2) // 32 * 32, -(-(cx + r + 2) // 32) * 32
        y = torch.arange(y0, y1, device=device)[:, None]
        x = torch.arange(x0, x1, device=device)[None, :]
        dx2 = (2 * x + (y & 1)) - (2 * cx + (cy & 1))
        disk = (3 * (y - cy) ** 2 + dx2 ** 2 <= (2 * r) ** 2).to(torch.uint8)
        solid[y0:y1, x0 // 32:x1 // 32] |= lattice.to_planes(disk, 1)[0]
    elif geom["kind"] != "channel":
        raise ValueError(f"unknown geometry {geom['kind']!r}")
    return solid


def make_lanes(cfg: dict, seed: int, device) -> torch.Tensor:
    """(lanes, planes, H, W/32) int32 lanes drawn from ``seed`` on
    ``device``: FHP, each particle bit of a fluid node with probability
    ``density``; BML, from one uniform u a node, an east car where u <
    density/2 and a north car where density/2 <= u < density."""
    lanes, h, w, rho = cfg["lanes"], cfg["height"], cfg["width"], \
        cfg["density"]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    solid = solid_words(cfg, device)
    n = lattice.N_BITS[cfg["rule"]]
    planes = torch.empty((lanes, n, h, w // 32), dtype=torch.int32,
                         device=device)
    for lane in range(lanes):
        if cfg["rule"] == "bml":
            u = torch.rand((h, w), generator=gen, device=device)
            cars = (u < rho / 2).to(torch.uint8) | (
                (u >= rho / 2) & (u < rho)).to(torch.uint8) << 1
            planes[lane] = lattice.to_planes(cars, 2)
            continue
        for p in range(7):
            bits = (torch.rand((h, w), generator=gen, device=device)
                    < rho).to(torch.uint8)
            planes[lane, p] = lattice.to_planes(bits, 1)[0] & ~solid
        planes[lane, 7] = solid
    return planes


def setup(run):
    from repro_torch.core import distributed
    from repro_torch.kernels.fhp_step import ops
    cfg, tr = run.config, run.traffic
    make = run.hooks.get("make_run", distributed.make_ensemble_run)
    call, _ = make(None, cfg["steps_per_call"], variant=cfg["rule"],
                   p_force=cfg["p_force"],
                   steps_per_launch=cfg["steps_per_launch"],
                   moments_every=cfg["moments_every"])
    x = make_lanes(cfg, run.seed, run.device)
    t = 0
    for _ in range(tr["warmup_calls"]):
        x, _m = call(x, t)
        t += cfg["steps_per_call"]
    _sync(run.device)
    pick = random.Random(run.seed).randrange(tr["check_first_calls"])
    return {"call": call, "x": x, "t": t, "pick": pick, "ops": ops,
            "kept": []}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(run, st):
    cfg = run.config
    call, x, t = st["call"], st["x"], st["t"]
    steps = cfg["steps_per_call"]
    cuda = run.device.type == "cuda"
    launches0 = st["ops"].launches_total()
    pending = None
    calls = 0
    w0 = time.time()
    p0 = time.perf_counter()
    deadline = p0 + run.seconds
    while True:
        with run.spans("ensemble.call"):
            y, m = call(x, t)
        if calls == st["pick"]:
            st["kept"].append((x, t, y, m))
        last = (x, t, y, m)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            if pending is not None:
                with run.spans("ensemble.wait"):
                    pending.synchronize()
            pending = ev
        x, t = y, t + steps
        calls += 1
        if time.perf_counter() >= deadline:
            break
    with run.spans("ensemble.wait"):
        _sync(run.device)
    p1 = time.perf_counter()
    run.window_wall = (w0, w0 + (p1 - p0))
    run.window_s = p1 - p0
    if st["pick"] != calls - 1:
        st["kept"].append(last)
    st["x"] = None
    sites = cfg["lanes"] * cfg["height"] * cfg["width"]
    run.e2e["site_updates_per_s"] = calls * sites * steps / run.window_s
    run.counters.update(calls=calls,
                        launches=st["ops"].launches_total() - launches0)
    run.attempted = calls


def check(run, st):
    cfg = run.config
    steps, every = cfg["steps_per_call"], cfg["moments_every"]
    sites = moments = 0
    for x, t, y, m in st.pop("kept"):
        if m.shape[:-1] != (x.shape[0], steps // every):
            moments += 1
            m = None
        # In blocks of lanes, so that the reference fits beside them.
        for b in range(0, x.shape[0], LANE_BLOCK):
            lanes = slice(b, b + LANE_BLOCK)
            ref, rec = lattice.run(lattice.to_bytes(x[lanes]), cfg["rule"],
                                   t, steps, p_force=cfg["p_force"],
                                   record_every=every)
            sites += lattice.sites_differing(lattice.to_bytes(y[lanes]), ref)
            want = torch.stack([r for _, r in rec], dim=-2)
            if m is not None:
                moments += int((m[lanes].to(torch.int64) != want).sum())
    run.check("sites_differing", sites, 0)
    run.check("moments_differing", moments, 0)
