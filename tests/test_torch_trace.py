"""The roofline trace (``repro_torch.roofline.trace``), the counterpart of
the reference's XLA-HLO parsers, on the CPU.

The reference's HLO fixture (``tests/test_roofline.py``) re-expressed as
functional collectives on a ``fake`` process group of 8 ranks (a (2, 4)
mesh; groups of 4) gives the reference parser's counts, operand and wire
bytes.  The fused-bytes rule counts the step's inputs and outputs and the
major ops, not elementwise chains.  FLOPs are a device's: a replicated
op counts in full on every device, a sharded one its shard.  The FHP
stepper's launches and ring copies reach the recorder, on a mesh of meta
slots, and agree with its own counters and with ``sharded_fhp_traffic``.
The process group lives in a fixture and is destroyed after the module.
"""
import textwrap

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.roofline import collective_bytes as ref_collective_bytes
from repro.roofline.analysis import hbm_bytes_estimate as ref_hbm
from repro_torch.core import distributed
from repro_torch.kernels.fhp_step import ops
from repro_torch.launch.mesh import install_fake_group
from repro_torch.roofline import analysis
from repro_torch.roofline import trace as rt

HLO = textwrap.dedent("""
    HloModule test, num_partitions=8

    %region_0 (a: f32[], b: f32[]) -> f32[] {
      %a = f32[] parameter(0)
      %b = f32[] parameter(1)
      ROOT %add = f32[] add(%a, %b)
    }

    ENTRY %main (x: f32[128,64], w: f32[64,32]) -> f32[128,32] {
      %x = f32[128,64]{1,0} parameter(0)
      %w = f32[64,32]{1,0} parameter(1)
      %dot = f32[128,32]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
      %ar = f32[128,32]{1,0} all-reduce(%dot), channel_id=1, replica_groups=[2,4]<=[8], to_apply=%region_0
      %ag = f32[128,128]{1,0} all-gather(%ar), channel_id=2, replica_groups=[2,4]<=[8], dimensions={1}
      %rs = f32[32,32]{1,0} reduce-scatter(%ag), channel_id=3, replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%region_0
      %cp = f32[128,32]{1,0} collective-permute(%ar), channel_id=4, source_target_pairs={{0,1},{1,0}}
      ROOT %out = f32[128,32]{1,0} add(%cp, %ar)
    }
""")


@pytest.fixture(scope="module")
def mesh():
    install_fake_group(8)
    from torch.distributed.device_mesh import init_device_mesh
    yield init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def fixture_step(mesh, x, w):
    """The fixture's program: dot, then an all-reduce, all-gather,
    reduce-scatter and permute over groups of 4 (the mesh's model dim)."""
    g = (mesh, 1)
    dot = x @ w
    ar = funcol.all_reduce(dot, "sum", g)
    funcol.all_gather_tensor(ar, 0, g)               # 4 x (128, 32)
    funcol.reduce_scatter_tensor(ar, "sum", 0, g)   # (32, 32)
    rt.note_collective("collective-permute", ar.numel() * 4)
    return ar + ar


def test_collectives_match_the_reference_parser_on_its_fixture(mesh):
    with rt.TraceRecorder() as rec:
        fixture_step(mesh, meta(128, 64), meta(64, 32))
    got = rt.collective_bytes(rec)
    want = ref_collective_bytes(HLO)
    for kind in rt.COLL_OPS + ("_total",):
        for key in ("count", "operand_bytes", "wire_bytes"):
            assert got[kind][key] == pytest.approx(want[kind][key]), (kind,
                                                                      key)
    assert {r.group for r in rec.ops if r.collective} == {4, 2}


def test_fused_bytes_count_boundaries_and_major_ops_only(mesh):
    x, w = meta(128, 64), meta(64, 32)
    with rt.TraceRecorder() as rec:
        f = torch.exp(x) * torch.exp(x)          # elementwise: not counted
        out = fixture_step(mesh, f, w)
    boundary = rt.local_bytes((x, w)) + rt.local_bytes(out)
    fused = rt.hbm_bytes_estimate(rec, "fused", boundary_bytes=boundary)
    buffers = (128 * 64 + 64 * 32 + 128 * 32          # x, w, out
               + 128 * 32                             # dot
               + 128 * 32 + 4 * 128 * 32 + 32 * 32     # ar, ag, rs
               + 128 * 32)                            # permute
    assert fused == 2 * 4 * buffers
    # The reference's rule on its fixture counts the same kinds of buffer.
    assert ref_hbm(HLO, "fused") > 0
    every = rt.hbm_bytes_estimate(rec, "all")
    assert every > fused / 2               # the exps' traffic is in "all"
    assert rt.collective_bytes(rec)["_total"]["count"] == 4
    assert rec.peak_live_bytes >= 4 * 128 * 64


def test_flops_are_a_devices_share(mesh):
    x, w = meta(64, 128), meta(128, 256)
    full = 2 * 64 * 128 * 256

    def flops(xp, wp):
        xd = DTensor.from_local(meta(*xp[0]), mesh, xp[1], run_check=False,
                                shape=x.shape, stride=x.stride())
        wd = DTensor.from_local(meta(*wp[0]), mesh, wp[1], run_check=False,
                                shape=w.shape, stride=w.stride())
        with rt.TraceRecorder() as rec:
            torch.einsum("td,df->tf", xd, wd)
        return sum(r.flops for r in rec.ops)

    rep = (Replicate(), Replicate())
    # Replicated: every device computes the whole product.
    assert flops(((64, 128), rep), ((128, 256), rep)) == full
    # Tokens over data (2): half; and the weight's columns over model (4).
    assert flops(((32, 128), (Shard(0), Replicate())),
                 ((128, 256), rep)) == full // 2
    assert flops(((32, 128), (Shard(0), Replicate())),
                 ((128, 64), (Replicate(), Shard(1)))) == full // 8


def test_analyze_trace_has_the_reference_record_keys(mesh):
    x, w = meta(128, 64), meta(64, 32)
    with rt.TraceRecorder() as rec:
        out = fixture_step(mesh, x, w)
    r = rt.analyze_trace(rec, inputs=(x, w), outputs=out,
                         model_flops=2 * 128 * 64 * 32 * 8, chips=8)
    assert set(r) == {
        "flops_per_device", "bytes_per_device",
        "bytes_xla_prefusion_per_device", "collective_bytes_per_device",
        "collective_wire_bytes_per_device", "collectives", "terms",
        "memory_analysis", "model_flops_global", "model_flops_ratio",
        "roofline_fraction"}
    assert r["flops_per_device"] == 2 * 128 * 64 * 32
    assert r["model_flops_ratio"] == 1.0
    assert r["memory_analysis"]["argument_size_in_bytes"] == 4 * (
        128 * 64 + 64 * 32)
    t = r["terms"]
    assert t == analysis.roofline_terms(
        r["flops_per_device"], r["bytes_per_device"],
        r["collective_bytes_per_device"], analysis.H100)
    assert r["roofline_fraction"] == pytest.approx(
        t["compute_s"] / t["step_s_lower_bound"])


def test_fhp_round_reports_launches_and_ring_copies_on_meta_slots():
    slots = distributed.make_mesh((2, 2), ("data", "model"), "meta")
    h, wd, depth = 64, 16, 2
    placed = distributed.lattice_spec(slots).place(
        torch.empty((8, h, wd), dtype=torch.int32, device="meta"))
    run = distributed.make_run(slots, 2 * depth, depth=depth,
                               p_force=0.01, steps_per_launch=depth)
    distributed.EXCHANGE.clear()
    ops.LAUNCHES.clear()
    with rt.TraceRecorder() as rec:
        out = run(placed, 0)
    assert out.tiles[1][1].shape == (8, h // 2, wd // 2)
    assert ops.launches_total() == 0            # meta: nothing launched
    kernels = [r for r in rec.ops if r.name.startswith("fhp_step")]
    assert len(kernels) == 4 * 2                # 4 shards x 2 rounds
    hl, wdl = h // 2, wd // 2
    ext = 8 * 4 * (hl + 2 * depth) * (wdl + 2)
    assert all(r.in_bytes == ext and r.out_bytes == ext for r in kernels)
    cb = rt.collective_bytes(rec)["collective-permute"]
    assert cb["operand_bytes"] == distributed.EXCHANGE["bytes"]
    assert cb["count"] == distributed.EXCHANGE["copies"] == 4 * 2 * 4
    per_shard_round = cb["operand_bytes"] / (4 * 2)
    model = analysis.sharded_fhp_traffic(hl, wdl, depth=depth, T=depth,
                                         block_rows=8)
    assert per_shard_round == model["ici_bytes_per_exchange"]
