"""The roofline's arithmetic, by hand."""
from __future__ import annotations

import pytest

from cabench import roofline


def test_ops_bound_is_the_slowest_pipe():
    words, records = 4 * 4096 * 1024 * 64, 4 * 4096 * 1024 * 8
    secs, pipe = roofline.ops_seconds(words, records)
    rate = roofline.SMS * roofline.MAX_SM_CLOCK_HZ
    per = {k: (words * roofline.STEP[k] + records * roofline.TERMS[k])
           for k in roofline.STEP}
    want = {k: per.get(k, 0) / (n * rate)
            for k, n in roofline.LANES_PER_SM_CLOCK.items()}
    want["issue"] = sum(per.values()) / (128 * rate)
    assert pipe == max(want, key=want.get)
    assert secs == pytest.approx(want[pipe], rel=1e-12)


def test_call_bound_of_the_ensemble_cell():
    secs, by = roofline.call_bound(4, 8, 4096, 1024, 64, 8, 4)
    ops_s, pipe = roofline.ops_seconds(4 * 4096 * 1024 * 64,
                                       4 * 4096 * 1024 * 8)
    bytes_s = 4 * (2 * 4 * 8 * 4096 * 1024 + 4 * 8 * 4) / 3.35e12
    assert bytes_s == pytest.approx(3.2051e-4, rel=1e-4)
    assert (secs, by) == (ops_s, pipe) and ops_s > bytes_s


def test_bytes_bind_when_there_is_little_work():
    secs, by = roofline.call_bound(1, 8, 64, 64, 1, 0, 4)
    assert by == "bytes"
    assert secs == pytest.approx(4 * 2 * 8 * 64 * 64 / 3.35e12)
