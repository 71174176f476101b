"""The port's dry-run cells in subprocesses on a ``fake`` process group
of 8 ranks (the (4, 2) test mesh), smoke configs: the prefill, decode and
long-context cells of ``tests/test_dryrun.py`` (each bound in one of the
three terms, FLOPs > 0, per-device local counts), and the FHP cell at
256 x 2048, memory-bound on the H100's rates."""
import json

import pytest

from _torch_dryrun import run_cell, tail


@pytest.mark.parametrize("arch,shape", [
    ("gemma2-27b", "prefill_32k"),
    ("deepseek-v3-671b", "decode_32k"),
    ("zamba2-2.7b", "long_500k"),
])
def test_dryrun_cells_trace(arch, shape, tmp_path):
    out = tmp_path / "cell.json"
    r = run_cell(["--arch", arch, "--shape", shape, "--test-mesh",
                  "--smoke", "--out", str(out)])
    assert r.returncode == 0, tail(r)
    assert f"DRYRUN OK {arch} x {shape}" in r.stdout
    rec = json.loads(out.read_text())
    assert rec["terms"]["bound"] in ("compute", "memory", "collective")
    assert rec["flops_per_device"] > 0
    assert rec["compile_s"] > 0
    assert rec["scan_cost_correction"] == "depth-knob extrapolation"
    # Per-device: the smoke batch (8 rows) is split over the data axis.
    assert rec["global_batch"] == 8 and rec["mesh"]["data"] == 4


def test_dryrun_fhp_cell(tmp_path):
    out = tmp_path / "fhp.json"
    r = run_cell(["--arch", "fhp-lattice", "--test-mesh", "--fhp-h", "256",
                  "--fhp-w", "2048", "--out", str(out)])
    assert r.returncode == 0, tail(r)
    assert "bound=memory" in r.stdout     # FHP must be memory-bound
    rec = json.loads(out.read_text())
    assert rec["flops_per_device"] == 0
    assert rec["kernel_launches"] == 8             # one launch per shard
    assert rec["collectives"]["collective-permute"]["count"] == 4
    # One device's halo: 2 rows of the x-extended width and 2 words a row
    # of its 64 x 32-word shard, 8 planes of 4 bytes.
    assert rec["collective_bytes_per_device"] == 32 * (2 * 34 + 2 * 64)
    assert 0 < rec["useful_bytes_ratio"] < 1
