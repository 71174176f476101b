"""The port's launch cost model, autotuner and exchange-latency probe
(``repro_torch.kernels.fhp_step.ops``, ``repro_torch.roofline.analysis``)
on the CPU: the cost functions against the reference's for the same
constants, exactly; the autotuner's picks against its own candidate set,
the card's shared-memory budget and the tiles ``chip_smoke.py`` times;
``roofline_terms``; and the probe's constant and cache off a multi-card
host.
"""
import importlib.util
import itertools
import os
import time

import pytest
import torch

from repro.kernels.fhp_step import ops as jops
from repro.roofline import analysis as janalysis
from repro_torch.kernels.fhp_step import ops
from repro_torch.roofline import analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke_tiles():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TILES, mod.HEIGHT, mod.WIDTH // 32


@pytest.fixture
def reference_weight(monkeypatch):
    """Both packages' compute weight at the reference's 0.2."""
    monkeypatch.setattr(ops, "COMPUTE_ROW_WEIGHT", 0.2)
    monkeypatch.setattr(jops, "COMPUTE_ROW_WEIGHT", 0.2)


@pytest.mark.parametrize("fn", ["launch_cost", "hbm_bytes_per_site"])
def test_launch_cost_terms_match_reference(reference_weight, fn):
    grid = itertools.product([1, 8, 32, 40], [1, 3, 8], [0, 16, 48, 1024],
                             [0, 64, 1024], [0, 3, 30])
    n = 0
    for bh, T, bw, width, mw in grid:
        got = getattr(ops, fn)(bh, T, bw, width, moments_words=mw)
        want = getattr(jops, fn)(bh, T, bw, width, moments_words=mw)
        assert got == want, (fn, bh, T, bw, width, mw)
        n += 1
    assert n == 4 * 3 * 4 * 3 * 3


def test_sharded_cost_terms_match_reference():
    # sharded_hbm_bytes_per_site at any weight; sharded_launch_cost against
    # the reference's sharded_fhp_traffic given the port's rates, weight
    # and latency.
    grid = itertools.product([(64, 30), (2048, 512)], [2, 8], [1, 4, 8],
                             [(8, 0), (40, 48), (16, 6)], [False, True],
                             [8, 2], [False, True], [3e-6, 3e-4])
    n = 0
    for (hl, wdl), depth, T, (bh, bw), solid, planes, ov, lat in grid:
        if T > min(depth, bh) or (bw and T > bw):
            continue
        assert ops.sharded_hbm_bytes_per_site(
            bh, T, depth, hl, wdl, solid, bw, planes) == \
            jops.sharded_hbm_bytes_per_site(bh, T, depth, hl, wdl, solid, bw,
                                            planes)
        got = ops.sharded_launch_cost(
            bh, T, depth, hl, wdl, static_solid=solid, block_words=bw,
            n_planes=planes, overlap=ov, exchange_latency_s=lat)
        want = janalysis.sharded_fhp_traffic(
            hl, wdl, depth=depth, T=T, block_rows=bh, block_words=bw,
            n_planes=planes, static_solid=solid, overlap=ov,
            compute_row_weight=ops.COMPUTE_ROW_WEIGHT,
            exchange_latency_s=lat, hw=analysis.H100)["total_s_per_site"]
        assert got == want, (hl, wdl, depth, T, bh, bw, solid, planes, ov)
        n += 1
    assert n >= 300


def test_bw_candidates_match_reference():
    for width, div in itertools.product([1, 2, 3, 48, 64, 100, 514, 1024],
                                        [False, True]):
        assert ops._bw_candidates(width, div) == \
            jops._bw_candidates(width, div), (width, div)


@pytest.mark.parametrize("flops,bytes_,coll", [
    (1e12, 1e9, 1e6), (1e15, 1e9, 1e6), (1e9, 1e12, 1e6), (1e9, 1e9, 1e12),
    (0.0, 0.0, 0.0), (9.89e14, 3.35e12, 4.5e11)])
def test_roofline_terms_match_reference(flops, bytes_, coll):
    hw = janalysis.HW(peak_flops=analysis.H100.peak_flops,
                      hbm_bw=analysis.H100.hbm_bw,
                      ici_bw=analysis.H100.ici_bw)
    assert analysis.roofline_terms(flops, bytes_, coll) == \
        janalysis.roofline_terms(flops, bytes_, coll, hw)


def test_compute_weight_is_the_cards():
    # One thread word-step of the [split] fit against a 32-byte word cell
    # at the card's 3.35 TB/s: the weight the model prices apron compute at.
    assert ops.COMPUTE_ROW_WEIGHT == pytest.approx(
        21.1448e-3 / 1e9 / (32 / analysis.H100.hbm_bw), rel=0.01)


def test_candidates_hold_the_timed_tiles():
    tiles, h, wd = chip_smoke_tiles()
    T = 8
    within = set(ops._tile_candidates(h, wd, T))
    assert ops.pick_tile(h, wd, T) in within
    launchable = set(ops._tile_candidates(
        h, wd, T, smem_budget=ops.SMEM_BYTES_PER_BLOCK))
    assert set(tiles) <= launchable
    for bh, bw in tiles:   # the budget decides which of them the tuner sees
        assert ((bh, bw) in within) == (
            ops.smem_bytes(bh, bw, T) <= ops.TILE_SMEM_BYTES)
    for t in range(1, 9):
        assert ops.pick_tile(h, wd, t) in set(ops._tile_candidates(h, wd, t))


@pytest.mark.parametrize("h,wd,planes,static,mw", [
    (4096, 1024, 8, False, 3), (4096, 1024, 8, True, 0), (300, 70, 2, False, 0),
    (64, 5, 8, False, 0)])
def test_single_device_pick_is_the_least_cost(h, wd, planes, static, mw):
    bh, bw, T = ops.autotune_launch(h, wd, n_planes=planes,
                                    static_solid=static, moments_words=mw)
    assert ops._tile_ok(bh, bw, h, wd, T, static, planes)
    assert ops.smem_bytes(bh, bw, T, static, planes) <= ops.TILE_SMEM_BYTES
    best = ops.launch_cost(bh, T, bw, wd, moments_words=mw)
    for t in range(1, ops.MAX_STEPS_PER_LAUNCH + 1):
        for tile in ops._tile_candidates(h, wd, t, static, planes):
            assert best <= ops.launch_cost(tile[0], t, tile[1], wd,
                                           moments_words=mw), (tile, t)


@pytest.mark.parametrize("hl,wdl,max_depth,lat", [
    (2048, 512, 16, 3e-6), (256, 32, 8, 3e-6), (64, 16, 31, 3e-4),
    (40, 2, 8, 3e-6)])
def test_sharded_pick_is_the_least_cost(hl, wdl, max_depth, lat):
    t = time.perf_counter()
    bh, bw, T, depth, ov = ops.autotune_launch(hl, wdl, max_depth=max_depth,
                                               exchange_latency_s=lat)
    assert time.perf_counter() - t < 5.0
    assert isinstance(ov, bool)
    assert T <= depth <= min(max_depth, 31, hl)
    assert ops._tile_ok(bh, bw, hl, wdl + 2, T, False, 8)
    assert ops.smem_bytes(bh, bw, T) <= ops.TILE_SMEM_BYTES

    def cost(bh, bw, T, depth, overlap):
        return ops.sharded_launch_cost(bh, T, depth, hl, wdl, block_words=bw,
                                       overlap=overlap,
                                       exchange_latency_s=lat)

    serial, split = cost(bh, bw, T, depth, False), cost(bh, bw, T, depth,
                                                        True)
    # Overlap only where the model prices it strictly cheaper: ties keep
    # the serial plan (a shard with no interior word always ties).
    assert ov == (split < serial)
    if wdl <= 2:
        assert not ov and split == serial
    best = cost(bh, bw, T, depth, ov)
    for t in range(1, min(ops.MAX_STEPS_PER_LAUNCH, max_depth) + 1):
        for tile in ops._tile_candidates(hl, wdl + 2, t):
            for d in range(t, min(max_depth, 31, hl) + 1, 3):
                assert best <= cost(*tile, t, d, False)
                assert best <= cost(*tile, t, d, True)


@pytest.mark.parametrize("hl,wdl", [(2048, 512), (256, 32), (64, 16)])
def test_costlier_exchange_never_picks_shallower(hl, wdl):
    depth = ops.autotune_launch(hl, wdl, max_depth=31,
                                exchange_latency_s=3e-6)[3]
    deeper = ops.autotune_launch(hl, wdl, max_depth=31,
                                 exchange_latency_s=3e-4)[3]
    assert deeper >= depth


def test_exchange_latency_is_the_constant_and_cached(monkeypatch):
    # Off a multi-card host the probe has no link to time: the constant,
    # cached under this host's fingerprint.  The sharded search takes it
    # when no latency is given.
    if torch.cuda.device_count() >= 2:
        pytest.skip("a multi-card host times the ring (tests/test_torch_gpu)")
    analysis._MEASURED_EXCHANGE_LATENCY.clear()
    lat = analysis.measured_exchange_latency()
    key = analysis._mesh_fingerprint()
    assert lat == analysis.EXCHANGE_LATENCY_S
    assert analysis._MEASURED_EXCHANGE_LATENCY == {key: lat}
    assert analysis.measured_exchange_latency() == lat
    # a foreign fingerprint's entry does not shadow this host's
    analysis._MEASURED_EXCHANGE_LATENCY[("other", 99, "?")] = 123.0
    assert analysis.measured_exchange_latency() == lat
    del analysis._MEASURED_EXCHANGE_LATENCY[("other", 99, "?")]
    # a cached entry is what the model reads, until refreshed
    analysis._MEASURED_EXCHANGE_LATENCY[key] = 3e-4
    assert ops.autotune_launch(256, 32, max_depth=8) == ops.autotune_launch(
        256, 32, max_depth=8, exchange_latency_s=3e-4)
    assert analysis.measured_exchange_latency(refresh=True) == lat
    assert analysis._MEASURED_EXCHANGE_LATENCY[key] == lat
