"""The port's traffic model (``repro_torch.roofline.analysis``) against the
reference's: ``sharded_fhp_traffic`` over a grid of shard shapes, depths,
T, tiles, static-solid, plane counts and overlap, every term exactly equal
when the reference is passed the port's ``HW``; arguments the reference
refuses, the port refuses too."""
import itertools

import pytest

from repro.roofline import analysis as janalysis
from repro_torch.roofline import analysis

GRID = list(itertools.product(
    [(16, 4), (64, 30), (2048, 512)],     # (hl, wdl) of a shard
    [1, 2, 4, 8],                         # depth
    [1, 3, 8],                            # T
    [(8, 0), (64, 0), (16, 6), (128, 48)],  # (block_rows, block_words)
    [False, True],                        # static_solid
    [8, 7, 2],                            # n_planes
    [False, True]))                       # overlap


def test_h100_is_the_default_and_the_datasheet():
    assert analysis.H100 == analysis.HW(peak_flops=989e12, hbm_bw=3.35e12,
                                        ici_bw=450e9)
    a = analysis.sharded_fhp_traffic(64, 30, depth=4, T=4, block_rows=64)
    b = analysis.sharded_fhp_traffic(64, 30, depth=4, T=4, block_rows=64,
                                     hw=analysis.H100)
    assert a == b
    assert (analysis.PLANE_BYTES, analysis.DYN_PLANE_BYTES,
            analysis.WORD_NODES, analysis.EXCHANGE_LATENCY_S) == \
        (janalysis.PLANE_BYTES, janalysis.DYN_PLANE_BYTES,
         janalysis.WORD_NODES, janalysis.EXCHANGE_LATENCY_S)
    for x in (1, 2, 3, 17, 64, 65):
        assert analysis._pow2_ge(x) == janalysis._pow2_ge(x)
        assert analysis._ceil_to(x, 8) == janalysis._ceil_to(x, 8)


@pytest.mark.parametrize("static_solid,overlap", [
    (False, False), (False, True), (True, False), (True, True)])
def test_sharded_fhp_traffic_matches_reference(static_solid, overlap):
    n = 0
    for (hl, wdl), depth, T, (bh, bw), solid, planes, ov in GRID:
        if (solid, ov) != (static_solid, overlap):
            continue
        kw = dict(depth=depth, T=T, block_rows=bh, block_words=bw,
                  static_solid=solid, n_planes=planes, overlap=ov)
        try:
            want = janalysis.sharded_fhp_traffic(hl, wdl, hw=analysis.H100,
                                                 **kw)
        except AssertionError:
            with pytest.raises(ValueError):
                analysis.sharded_fhp_traffic(hl, wdl, **kw)
            continue
        got = analysis.sharded_fhp_traffic(hl, wdl, **kw)
        assert got == want, (hl, wdl, kw)
        n += 1
    assert n >= 200
