"""The port's fused-step module on the CPU: ``fhp_step_cuda`` / ``run_cuda``
(which take the plain version for CPU tensors) against the reference's
``run_pallas`` in interpret mode and ``run_planes_rule``; the kernel's own
per-element body (``csrc/fhp_step.cuh``) compiled with g++ and run
serially against the plain version, in periodic, extended-shard and
precomputed-RNG mode; the generated rule circuits; the card's parity
sweep and the instruction counter on canned input; the argument checks
and the device dispatch.
"""
import ctypes
import itertools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rulespec as jrulespec
from repro.kernels.fhp_step.ops import run_pallas
from repro_torch.core import carry, prng, rulespec
from repro_torch.kernels.fhp_step import build, check, codegen, opcount, ops
from repro_torch.kernels.fhp_step.ref import fhp_step_ref

CPU = torch.device("cpu")


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


def test_generated_header_is_current():
    assert codegen.HEADER.read_text() == codegen.generate()


def test_circuit_op_counts():
    ops_ = {v: codegen.circuit_ops(v) for v in codegen.RULES}
    assert ops_["fhp3"]["collide"] > ops_["fhp2"]["collide"] > 100
    assert ops_["bml"] == {"collide": 6, "force": 0}
    assert ops_["fhp2"]["force"] == 7


# ---------------------------------------------------------------------------
# Against the reference's Pallas kernel (interpret mode, T <= 2 keeps the
# unrolled trace fast) on a 16 x 256-node lattice with two lanes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,T,k", [("fhp2", 1, 2), ("fhp2", 2, 1),
                                         ("fhp3", 2, 3), ("bml", 2, 2),
                                         ("bml", 1, 0)])
def test_run_cuda_matches_run_pallas(variant, T, k):
    spec = rulespec.get_rule(variant)
    w = words(T + k, (2, spec.n_planes, 16, 8))
    kw = dict(p_force=0.0 if variant == "bml" else 0.05, t0=5,
              steps_per_launch=T, moments_every=k, variant=variant, y0=3,
              xw0=2)
    steps = 2 * T + 1                      # full launches + one remainder
    want = run_pallas(jnp.asarray(w), steps, **kw)
    got = ops.run_cuda(carry.planes_from_reference(w, CPU), steps, **kw)
    if k:
        (want, wm), (got, gm) = want, got
        assert gm.dtype == torch.int32 and gm.shape[-2] == steps // k
        assert np.array_equal(np.asarray(wm), carry.moments_to_reference(gm))
    assert np.array_equal(np.asarray(want), carry.planes_to_reference(got))


def test_static_solid_matches_run_pallas():
    w = words(9, (2, 8, 16, 8))
    solid = w[0, 7]
    kw = dict(p_force=0.05, t0=2, steps_per_launch=2, moments_every=2)
    want, wm = run_pallas(jnp.asarray(w[:, :7]), 5, solid=jnp.asarray(solid),
                          **kw)
    got, gm = ops.run_cuda(carry.planes_from_reference(w[:, :7], CPU), 5,
                           solid=carry.planes_from_reference(solid, CPU),
                           **kw)
    assert np.array_equal(np.asarray(want), carry.planes_to_reference(got))
    assert np.array_equal(np.asarray(wm), carry.moments_to_reference(gm))
    # ... and against the 8-plane run with the same solid in every lane
    full = w.copy()
    full[:, 7] = solid
    ref8 = ops.run_cuda(carry.planes_from_reference(full, CPU), 5,
                        p_force=0.05, t0=2, steps_per_launch=2)
    assert torch.equal(ref8[:, :7], got)


@pytest.mark.parametrize("variant", codegen.RULES)
@pytest.mark.parametrize("T", [3, 4, 8])
def test_run_cuda_matches_run_planes_rule(variant, T):
    spec = rulespec.get_rule(variant)
    w = carry.planes_from_reference(words(T, (3, spec.n_planes, 12, 4)), CPU)
    p_force = 0.0 if variant == "bml" else 0.3
    steps = 2 * T + 3
    got, mom = ops.run_cuda(w, steps, p_force=p_force, t0=7,
                            steps_per_launch=T, moments_every=T - 1,
                            variant=variant)
    ms = rulespec.moment_spec(spec)
    s, want_m = w, []
    for i in range(steps):
        s = rulespec.step_planes_rule(s, 7 + i, spec, p_force=p_force)
        if (i + 1) % (T - 1) == 0:
            want_m.append(rulespec.compute_moments(s, ms))
    assert torch.equal(got, s)
    assert torch.equal(mom, torch.stack(want_m, dim=-2))


def test_fhp_step_cuda_unbatched_and_offsets_match_reference():
    spec = jrulespec.get_rule("fhp3")
    w = words(11, (8, 8, 4))
    out = ops.fhp_step_cuda(carry.planes_from_reference(w, CPU), 9,
                            p_force=0.2, y0=5, xw0=3, variant="fhp3",
                            steps_per_launch=3, record_steps=(0, 2))
    s = jnp.asarray(w)
    ms = jrulespec.moment_spec(spec)
    moms = []
    for i in range(3):
        s = jrulespec.step_planes_rule(s, 9 + i, spec, p_force=0.2, y0=5,
                                       xw0=3)
        if i in (0, 2):
            moms.append(jrulespec.compute_moments(s, ms))
    assert np.array_equal(np.asarray(s), carry.planes_to_reference(out[0]))
    assert np.array_equal(np.stack([np.asarray(m) for m in moms]),
                          out[1].numpy())


# ---------------------------------------------------------------------------
# The kernel's per-element body, compiled for the host.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host emulation")
    src = codegen.HEADER.parent / "host_emulate.cpp"
    lib = tmp_path_factory.mktemp("fhp_host") / "libfhp_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.fhp_step_host.argtypes = build.launch_argtypes()
    dll.fhp_step_host.restype = ctypes.c_int
    return dll


def _host_step(dll, planes, t, variant, T, tile, p_force, y0, xw0, solid,
               rs, mode=0, hg=0, wdg=0, bounds=None, chi=None, acc=None):
    b, nps, h, wd = planes.shape
    ms = rulespec.moment_spec(rulespec.get_rule(variant), stack_planes=nps)
    out = torch.empty_like(planes)
    mom = torch.zeros((b, len(rs), ms.n_moments), dtype=torch.int32)
    ptr = [None if a is None else a.data_ptr() for a in (solid, chi, acc)]
    err = dll.fhp_step_host(
        planes.data_ptr(), out.data_ptr(), *ptr,
        mom.data_ptr() if rs else None, codegen.RULES.index(variant), mode,
        b, h, wd, tile[0], tile[1], T, t, y0, xw0, hg, wdg,
        *(bounds or (0, h, 0, wd)), prng.quantize_p(p_force),
        sum(1 << s for s in rs))
    assert err == 0
    return out, mom


@pytest.mark.parametrize("variant,static", [("fhp2", False), ("fhp2", True),
                                            ("fhp3", False), ("fhp3", True),
                                            ("bml", False)])
def test_kernel_body_matches_plain_version(host_kernel, variant, static):
    spec = rulespec.get_rule(variant)
    rng = np.random.default_rng(len(variant) + static)
    n = 0
    for T, tile, p_force in itertools.product(
            (1, 3, 8), ((8, 8), (16, 5), (8, 13), (22, 13)), (0.0, 0.05)):
        if (variant == "bml" and p_force) or T > min(tile):
            continue
        w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                          size=(2, spec.n_planes, 22, 13),
                                          dtype=np.int64).astype(np.int32))
        solid = None
        if static:
            solid = w[0, spec.solid_plane].clone()
            w = w[:, :spec.solid_plane].contiguous()
        rs = tuple(range(T - 1, -1, -2))
        got, gm = _host_step(host_kernel, w, 11, variant, T, tile, p_force,
                             7, 5, solid, rs)
        want, wm = fhp_step_ref(w, 11, p_force=p_force, y0=7, xw0=5,
                                variant=variant, steps_per_launch=T,
                                solid=solid, record_steps=rs)
        assert torch.equal(got, want), (T, tile, p_force)
        assert torch.equal(gm, wm), (T, tile, p_force)
        n += 1
    assert n >= 8


@pytest.mark.parametrize("variant,static", [("fhp2", False), ("fhp3", True),
                                            ("bml", False)])
def test_kernel_body_extended_mode_matches_plain_version(host_kernel,
                                                         variant, static):
    # Shard 0 of a halo-extended array: y0 = -T, xw0 = -1, global extents
    # larger than the array; only the validity window is specified.
    spec = rulespec.get_rule(variant)
    rng = np.random.default_rng(3 + static)
    h, wd = 24, 13
    for T, tile, p_force in itertools.product(
            (1, 3, 8), ((8, 8), (16, 5), (24, 13)), (0.0, 0.05)):
        if (variant == "bml" and p_force) or T > min(tile):
            continue
        w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                          size=(2, spec.n_planes, h, wd),
                                          dtype=np.int64).astype(np.int32))
        solid = None
        if static:
            solid = w[0, spec.solid_plane].clone()
            w = w[:, :spec.solid_plane].contiguous()
        bounds = (T, h - T, 1, wd - 1)
        rs = tuple(range(T - 1, -1, -2))
        glob = dict(extended=True, hg=2 * h + 4, wdg=wd + 3)
        got, gm = _host_step(host_kernel, w, 11, variant, T, tile, p_force,
                             -T, -1, solid, rs, mode=1, hg=glob["hg"],
                             wdg=glob["wdg"], bounds=bounds)
        want, wm = fhp_step_ref(w, 11, p_force=p_force, y0=-T, xw0=-1,
                                variant=variant, steps_per_launch=T,
                                solid=solid, record_steps=rs,
                                moment_bounds=bounds, **glob)
        win = (..., slice(T, h - T), slice(1, wd - 1))
        assert torch.equal(got[win], want[win]), (T, tile, p_force)
        assert torch.equal(gm, wm), (T, tile, p_force)


@pytest.mark.parametrize("variant", codegen.RULES)
def test_kernel_body_precomputed_rng_matches_plain_version(host_kernel,
                                                           variant):
    spec = rulespec.get_rule(variant)
    rng = np.random.default_rng(len(variant))
    h, wd = 22, 13
    for tile, p_force in itertools.product(((8, 8), (22, 5), (16, 13)),
                                           (0.0, 0.05)):
        if variant == "bml" and p_force:
            continue
        w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                          size=(2, spec.n_planes, h, wd),
                                          dtype=np.int64).astype(np.int32))
        chi = prng.chirality_words((h, wd), 11, y0=7, xw0=5)
        acc = prng.bernoulli_words((h, wd), 11, p_force, y0=7,
                                   xw0=5) if p_force else None
        got, gm = _host_step(host_kernel, w, 11, variant, 1, tile, p_force,
                             7, 5, None, (0,), mode=2, chi=chi, acc=acc)
        want, wm = fhp_step_ref(w, 11, p_force=p_force, y0=7, xw0=5,
                                variant=variant, record_steps=(0,))
        assert torch.equal(got, want), (tile, p_force)
        assert torch.equal(gm, wm), (tile, p_force)


# ---------------------------------------------------------------------------
# Argument checks, tiles and device dispatch.
# ---------------------------------------------------------------------------

def test_meta_tensor_raises_and_returns_nothing():
    planes = torch.empty((2, 8, 64, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fhp_step_cuda(planes, 0, steps_per_launch=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.run_cuda(planes, 4, steps_per_launch=2, moments_every=2)


def test_argument_checks():
    w = torch.zeros((1, 8, 16, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="single step"):
        ops.fhp_step_cuda(w, 0, rng_in_kernel=False, steps_per_launch=2)
    with pytest.raises(ValueError, match="fused-path"):
        ops.fhp_step_cuda(w[:, :7], 0, rng_in_kernel=False, solid=w[0, 7])
    with pytest.raises(ValueError, match="global-coordinate"):
        ops.fhp_step_cuda(w, 0, extended=True, hg=16, wdg=8,
                          rng_in_kernel=False)
    with pytest.raises(ValueError, match="hg/wdg"):
        ops.fhp_step_cuda(w, 0, extended=True, hg=16)
    with pytest.raises(ValueError, match="even hg"):
        ops.fhp_step_cuda(w, 0, extended=True, hg=15, wdg=8)
    for extended in (False, True):
        with pytest.raises(ValueError, match="donate"):
            ops.fhp_step_cuda(w, 0, donate=True, extended=extended, hg=16,
                              wdg=8)
    with pytest.raises(ValueError, match="expects 2"):
        ops.fhp_step_cuda(w, 0, variant="bml")
    with pytest.raises(ValueError, match="no force pass"):
        ops.fhp_step_cuda(w[:, :2], 0, variant="bml", p_force=0.1)
    with pytest.raises(ValueError, match="no solid plane"):
        ops.fhp_step_cuda(w[:, :1], 0, variant="bml", solid=w[0, 0])
    with pytest.raises(ValueError, match="solid plane"):
        ops.fhp_step_cuda(w[:, :7], 0, solid=w[0, 0, :8])
    with pytest.raises(ValueError, match="block_rows"):
        ops.fhp_step_cuda(w, 0, steps_per_launch=4, block_rows=2)
    with pytest.raises(ValueError, match="block_words"):
        ops.fhp_step_cuda(w, 0, steps_per_launch=4, block_rows=8,
                          block_words=2)
    with pytest.raises(ValueError, match="outside"):
        ops.fhp_step_cuda(w[:, :2], 0, variant="bml", steps_per_launch=32,
                          block_rows=32, block_words=32)
    with pytest.raises(ValueError, match="record_steps"):
        ops.fhp_step_cuda(w, 0, steps_per_launch=2, record_steps=(2,))
    with pytest.raises(ValueError, match="shared memory"):
        ops.fhp_step_cuda(w, 0, steps_per_launch=8, block_rows=64,
                          block_words=64)


def test_moment_headroom_refused_before_dispatch():
    # 2**28 FHP sites: px2's coefficients sum to 8, so int32 could overflow.
    big = torch.empty((1, 8, 2 ** 14, 2 ** 9), dtype=torch.int32,
                      device="meta")
    with pytest.raises(ValueError, match="overflow"):
        ops.fhp_step_cuda(big, 0, record_steps=(0,))
    ok = torch.empty((1, 8, 2 ** 13, 2 ** 9), dtype=torch.int32,
                     device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fhp_step_cuda(ok, 0, record_steps=(0,))


def test_pick_tile_and_shared_memory():
    assert ops.smem_bytes(32, 32, 8) == 2 * 8 * 48 * 48 * 4
    assert ops.pick_tile(4096, 1024, 8) == (32, 32)
    assert ops.pick_tile(4096, 1024, 8, static_solid=True) == (32, 32)
    assert ops.pick_tile(16, 8, 8) == (16, 8)
    assert ops.pick_tile(70, 31, 1, n_planes=2) == (32, 31)
    for h, wd, T, sp, n in ((4096, 1024, 8, False, 8), (256, 125, 4, True, 8),
                            (64, 3, 2, False, 2)):
        bh, bw = ops.pick_tile(h, wd, T, sp, n)
        assert ops.smem_bytes(bh, bw, T, sp, n) <= ops.SMEM_BYTES_PER_BLOCK
        assert T <= bh and (bw >= wd or T <= bw)
    with pytest.raises(ValueError, match="no valid tile"):
        ops.pick_tile(4, 64, 8)


# ---------------------------------------------------------------------------
# The card's parity sweep and the bound's instruction counter, on the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [check.Case("fhp2", 2, 1, 0.05),
                                  check.Case("fhp3", 1, 3, 0.05),
                                  check.Case("bml", 3, 1, 0.0)], ids=str)
def test_parity_sweep_case_on_cpu(case):
    # run_cuda's launch schedule against one plain step per call.
    assert check.run_case(case, CPU, h=30, wd=15) == []


def _sass(funcs):
    """``cuobjdump -sass`` text: each function's ops between one load and
    one store of ``copy``'s shape, with the encoding lines."""
    lines = ["\tcode for sm_90a"]
    for name, body in funcs.items():
        lines.append(f"\t\tFunction : {name}")
        insns = (["LDC R1, c[0x0][0x28] ;", "S2R R7, SR_TID.X ;",
                  "IMAD.WIDE R2, R7, 0x4, R2 ;",
                  "LDG.E R5, desc[UR4][R2.64] ;"]
                 + body + ["STG.E desc[UR4][R4.64], R5 ;", "EXIT ;",
                           "BRA 0x90;"])
        for i, insn in enumerate(insns):
            lines += [f"        /*{16 * i:04x}*/                   {insn}"
                      "   /* 0x000fe40000000800 */",
                      " " * 60 + "/* 0x000fe40000000800 */"]
    return "\n".join(lines)


def test_sass_counts_by_pipe():
    step = ["LOP3.LUT R5, R5, R6, R7, 0x96, !PT ;",
            "SHF.R.U32.HI R6, RZ, 0x10, R5 ;",
            "IMAD R5, R5, -0x7a143595, RZ ;",
            "@!P0 IADD3 R5, R5, 0x1, RZ ;",
            "UIMAD UR4, UR4, -0x61c88647, URZ ;"]
    sass = _sass({"copy": [],
                  "step_even": step,
                  "step_odd": step + ["LOP3.LUT R5, R5, R6, RZ, 0x3c, !PT ;"],
                  "pre_even": step[:1],
                  "pre_odd": step[:1],
                  "terms": ["LOP3.LUT R6, R5, R6, RZ, 0xc0, !PT ;",
                            "POPC R6, R6 ;", "IADD3 R8, R8, R6, RZ ;"]})
    assert opcount.parse_sass(sass)["step_even"]["LOP3"] == 1
    c = opcount.word_step_counts(sass)
    assert c["step"] == {"alu": 3.5, "fma": 1, "popc": 0, "other": 1}
    assert c["pre"] == {"alu": 1, "fma": 0, "popc": 0, "other": 0}
    assert c["terms"] == {"alu": 2, "fma": 0, "popc": 1, "other": 0}
    assert opcount.per_word_step(c, 0.5) == {"alu": 4.5, "fma": 1,
                                            "popc": 0.5, "other": 1}
    assert opcount.per_word_step(c, 0, "pre") == c["pre"]
    for bad in (["BRA 0x10;"], ["LDL R5, [R1] ;"]):
        with pytest.raises(RuntimeError, match="straight-line"):
            opcount.word_step_counts(sass + "\n" + _sass({"copy": bad}))


def test_ops_ms_takes_the_slowest_pipe():
    clocks = opcount.SM_CLOCKS_PER_S          # one SM-clock summed: 1 s
    assert opcount.ops_ms(clocks, {"alu": 64, "fma": 0, "popc": 0,
                                   "other": 0}) == (1000.0, "alu")
    assert opcount.ops_ms(clocks, {"alu": 32, "fma": 32, "popc": 8,
                                   "other": 56}) == (1000.0, "issue")
    ms, pipe = opcount.ops_ms(clocks, {"alu": 10, "fma": 10, "popc": 32,
                                       "other": 0})
    assert (ms, pipe) == (2000.0, "popc")
