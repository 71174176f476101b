"""The port's dry-run on the multi-pod test mesh, and what its numbers
mean, in subprocesses: the multi-pod smoke cell ends ``DRYRUN OK``; the
depth-knob extrapolation equals a full-depth trace's totals on a smoke
config; and on a (1, 1) mesh the traced FLOPs equal ``FlopCounterMode``'s
count of the same step run unsharded."""
import json
import textwrap

import pytest

from _torch_dryrun import run_cell, run_script, tail

SCRIPT = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import install_fake_group
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.data import make_batch_specs
    from repro_torch.train import make_train_step

    out = {}
    if MODE == "depth":
        install_fake_group(8)
        kw = dict(test_mesh=True, smoke=True)
        out["full"] = dryrun.run_cell("internlm2-20b", "train_4k",
                                      correct_scan_costs=False, **kw)
        out["knobs"] = dryrun.run_cell("internlm2-20b", "train_4k", **kw)
    else:
        install_fake_group(1)
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell("repro-100m", "train_4k", smoke=True,
                              mesh=mesh, correct_scan_costs=False)
        cfg = get_smoke("repro-100m")
        params, _ = lm.abstract_params(cfg)
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        state = dryrun.opt_abstract(params)
        batch, _ = make_batch_specs(cfg, rec["seq_len"], rec["global_batch"])
        with FlopCounterMode(display=False) as fc:
            make_train_step(cfg, opt)(params, state, batch)
        out = {"traced": rec["flops_per_device"],
               "counted": fc.get_total_flops()}
    print("RESULT " + json.dumps(out, default=str))
""")


def result(mode):
    r = run_script(f"MODE = {mode!r}\n" + SCRIPT)
    assert r.returncode == 0, tail(r)
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_dryrun_multipod_traces():
    r = run_cell(["--arch", "qwen2.5-14b", "--shape", "train_4k",
                  "--test-mesh", "--smoke", "--multi-pod"])
    assert r.returncode == 0, tail(r)
    assert "DRYRUN OK qwen2.5-14b x train_4k (multi_pod=True)" in r.stdout


def test_extrapolated_costs_equal_a_full_depth_trace():
    out = result("depth")
    full, knobs = out["full"], out["knobs"]
    assert "scan_cost_correction" not in full
    assert knobs["scan_cost_correction"] == "depth-knob extrapolation"
    for k in ("flops_per_device", "bytes_per_device",
              "bytes_xla_prefusion_per_device",
              "collective_bytes_per_device",
              "collective_wire_bytes_per_device"):
        assert knobs[k] == pytest.approx(full[k], rel=1e-9), k
    assert knobs["terms"]["bound"] == full["terms"]["bound"]
    assert knobs["memory_analysis"]["argument_size_in_bytes"] == \
        full["memory_analysis"]["argument_size_in_bytes"]


def test_one_device_mesh_flops_equal_flop_counter():
    out = result("flops")
    assert out["traced"] > 0 and out["traced"] == out["counted"]
