"""The port's dry-run (``repro_torch.launch.dryrun``) end to end in
subprocesses on a ``fake`` process group of 8 ranks (the (4, 2) test
mesh), smoke configs: the counterpart of ``tests/test_dryrun.py`` (the
internlm2 cell and the long-context SKIP here; the other cells in
``test_torch_dryrun_cells.py`` and ``test_torch_dryrun_depth.py``).  Also
the depth-knob variants and extrapolation against the reference's, the
report and summary tables on the port's records and on the reference's
record keys, ``run_all`` on the FHP cell, and ``perf --exp
fhp_temporal``.
"""
import json
import os
import sys

import pytest

from _torch_dryrun import ENV, run_cell, tail

# The reference's dry-run module sets XLA_FLAGS (512 host devices) as it
# is imported: keep this process's value.
_flags = os.environ.get("XLA_FLAGS")
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import dryrun, perf, report, run_all  # noqa: E402

KEYS = {"flops_per_device", "bytes_per_device",
        "bytes_xla_prefusion_per_device", "collective_bytes_per_device",
        "collective_wire_bytes_per_device", "collectives", "terms",
        "memory_analysis", "model_flops_global", "model_flops_ratio",
        "roofline_fraction", "terms_measured", "scan_cost_correction",
        "lower_s", "compile_s", "chips", "multi_pod", "mesh", "arch",
        "shape"}


def test_dryrun_internlm2_train_cell_traces(tmp_path):
    out = tmp_path / "cell.json"
    r = run_cell(["--arch", "internlm2-20b", "--shape", "train_4k",
                  "--test-mesh", "--smoke", "--out", str(out)])
    assert r.returncode == 0, tail(r)
    assert r.stdout.strip().splitlines()[-1] == (
        "DRYRUN OK internlm2-20b x train_4k (multi_pod=False) bound="
        + json.loads(out.read_text())["terms"]["bound"])
    rec = json.loads(out.read_text())
    assert KEYS <= set(rec)
    assert rec["terms"]["bound"] in ("compute", "memory", "collective")
    assert rec["flops_per_device"] > 0 and rec["compile_s"] > 0
    assert rec["chips"] == 8 and rec["mesh"] == {"data": 4, "model": 2}
    assert rec["collectives"] and rec["hw"] == "H100"
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0


def test_dryrun_skips_inapplicable_long_context():
    r = run_cell(["--arch", "internlm2-20b", "--shape", "long_500k",
                  "--test-mesh", "--smoke"])
    assert r.returncode == 0, tail(r)
    assert "SKIP" in r.stdout


def test_dryrun_names_the_process_group_a_mesh_needs():
    r = run_cell(["--arch", "internlm2-20b", "--shape", "train_4k",
                  "--smoke"])               # (16, 16) on 8 ranks
    assert r.returncode != 0
    assert "needs a process group of 256 ranks" in r.stderr


@pytest.mark.parametrize("arch", ASSIGNED)
def test_knob_variants_and_extrapolation_match_reference(arch):
    for jcfg, cfg in ((jget_config(arch), get_config(arch)),
                      (jget_smoke(arch), get_smoke(arch))):
        jt, jv = jdryrun._knob_cfgs(jcfg)
        t, v = dryrun._knob_cfgs(cfg)
        assert t == jt and [g for g, _ in v] == [g for g, _ in jv]
        for (_, a), (_, b) in zip(v, jv):
            assert (a.n_layers, a.enc_layers, a.shared_attn_period,
                    a.moe and a.moe.first_dense) == (
                b.n_layers, b.enc_layers, b.shared_attn_period,
                b.moe and b.moe.first_dense)
        costs = {g: {k: 100.0 * (i + 1) + j for j, k in enumerate(
            ("flops", "bytes", "bytes_xla", "coll_op", "coll_wire"))}
            for i, (g, _) in enumerate(v)}
        assert dryrun._extrapolate(cfg, t, costs) == \
            jdryrun._extrapolate(jcfg, jt, costs)


def _record(**kw):
    rec = {"arch": "internlm2-20b", "shape": "train_4k", "multi_pod": False,
           "mesh": {"data": 16, "model": 16}, "chips": 256,
           "terms": {"bound": "memory", "compute_s": 1.0, "memory_s": 2.0,
                     "collective_s": 0.5, "step_s_lower_bound": 2.0},
           "flops_per_device": 1e15, "bytes_per_device": 6.7e12,
           "collective_bytes_per_device": 2.2e11, "model_flops_ratio": 0.5,
           "roofline_fraction": 0.25, "compile_s": 3.0,
           "memory_analysis": {"argument_size_in_bytes": 2 ** 30,
                               "temp_size_in_bytes": 2 ** 30}}
    rec.update(kw)
    return rec


def test_report_and_summary_read_port_and_reference_records(tmp_path):
    (tmp_path / "a__train_4k__sp.json").write_text(json.dumps(_record()))
    # A record with the reference's keys only (no "hw", "trace_s").
    ref = _record(arch="gemma2-27b", terms={"bound": "collective",
                                            "compute_s": 1.0,
                                            "memory_s": 1.0,
                                            "collective_s": 3.0})
    (tmp_path / "b__prefill_32k__sp.json").write_text(json.dumps(ref))
    cells = report.load(str(tmp_path))
    table = report.roofline_table(cells)
    assert "| internlm2-20b × train_4k | memory | 1 | 2 |" in table
    assert "gemma2-27b" in table
    assert "2.00 GiB" in report.dryrun_table(cells)
    notes = report.bottleneck_notes(cells)      # memory- and link-bound
    assert "shared memory" in notes and "NVLink" in notes
    assert "MXU" not in notes and "VMEM" not in notes
    run_all.write_summary(str(tmp_path))
    md = (tmp_path / "summary.md").read_text().splitlines()
    assert len(md) == 4 and md[2].startswith("| a__train_4k__sp | 16x16 |")


def test_run_all_runs_a_cell_on_its_own_process_group(tmp_path):
    import subprocess
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_all", "--archs",
         "fhp-lattice", "--test-mesh", "--single-pod-only", "--results-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=dict(ENV, DRYRUN_DEVICES="512"))    # each cell sets its own
    assert r.returncode == 0, tail(r)
    rec = json.loads((tmp_path / "fhp-lattice__fhp__sp.json").read_text())
    assert rec["chips"] == 8 and rec["terms"]["bound"] == "memory"
    assert "fhp-lattice__fhp__sp" in (tmp_path / "summary.md").read_text()


def test_perf_fhp_temporal_writes_its_json(tmp_path, capsys):
    assert perf.main(["--exp", "fhp_temporal", "--out-dir",
                      str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "fhp_temporal.json").read_text())
    t1, t4 = rec["temporal T=1"], rec["temporal T=4"]
    assert t4["hbm_bytes_per_site_step"] < t1["hbm_bytes_per_site_step"]
    assert rec["autotune"]["speedup_vs_T1_modeled"] > 1
    assert "fhp_temporal.json" in capsys.readouterr().out
