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
from repro.kernels.fhp_step import ops as jops
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
    return _host_dll(lib)


def _host_dll(cxx_lib):
    dll = ctypes.CDLL(str(cxx_lib))
    dll.fhp_step_host.argtypes = build.launch_argtypes()
    dll.fhp_step_host.restype = ctypes.c_int
    dll.fhp_plan_host.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    dll.fhp_plan_host.restype = ctypes.c_int
    dll.fhp_bernoulli_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_uint,
                                       ctypes.c_int, ctypes.c_void_p]
    dll.fhp_bernoulli_host.restype = None
    dll.fhp_geometry_host.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dll.fhp_geometry_host.restype = None
    dll.fhp_stream_geometry_host.argtypes = ([ctypes.c_int] * 4
                                             + [ctypes.c_void_p])
    dll.fhp_stream_geometry_host.restype = None
    dll.fhp_stream_schedule_host.argtypes = ([ctypes.c_int] * 2
                                             + [ctypes.c_void_p] * 2)
    dll.fhp_stream_schedule_host.restype = ctypes.c_int
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


# Row-mapped tiles: one or two warps per tile row (W = bw + 2T up to 80
# words), several rounds of rows per step,
# 16-byte copies (Wd % 4 == 0) with tile origins off and on a 16-byte
# boundary, narrow (bw 1, prime) and ragged tiles, and tiles as wide as
# the lattice.
ROW_MAPPED_TILES = [(8, (32, 48)), (8, (16, 64)), (1, (8, 30)), (2, (33, 20)),
                    (3, (40, 1)), (4, (12, 7)), (2, (9, 72)), (8, (40, 72)),
                    (1, (5, 130))]


@pytest.mark.parametrize("T,tile", ROW_MAPPED_TILES, ids=str)
@pytest.mark.parametrize("variant,static", [("fhp2", False), ("fhp3", True),
                                            ("bml", False)])
def test_kernel_body_row_mapped_tiles(host_kernel, variant, static, T, tile):
    # On a 40 x 72-word lattice: periodic with moments against the plain
    # version, extended (y0 < 0) on its validity window, and K2 where T = 1.
    spec = rulespec.get_rule(variant)
    rng = np.random.default_rng(T * 100 + tile[1])
    h, wd = 40, 72
    p_force = 0.0 if variant == "bml" else 0.05
    w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                      size=(2, spec.n_planes, h, wd),
                                      dtype=np.int64).astype(np.int32))
    solid = None
    if static:
        solid = w[0, spec.solid_plane].clone()
        w = w[:, :spec.solid_plane].contiguous()
    rs = tuple(range(T - 1, -1, -3))
    got, gm = _host_step(host_kernel, w, 11, variant, T, tile, p_force, 7, 5,
                         solid, rs)
    want, wm = fhp_step_ref(w, 11, p_force=p_force, y0=7, xw0=5,
                            variant=variant, steps_per_launch=T, solid=solid,
                            record_steps=rs)
    assert torch.equal(got, want) and torch.equal(gm, wm)

    bounds = (T, h - T, 1, wd - 1)
    glob = dict(extended=True, hg=2 * h + 4, wdg=wd + 3)
    got, gm = _host_step(host_kernel, w, 11, variant, T, tile, p_force, -T,
                         -1, solid, rs, mode=1, hg=glob["hg"],
                         wdg=glob["wdg"], bounds=bounds)
    want, wm = fhp_step_ref(w, 11, p_force=p_force, y0=-T, xw0=-1,
                            variant=variant, steps_per_launch=T, solid=solid,
                            record_steps=rs, moment_bounds=bounds, **glob)
    win = (..., slice(T, h - T), slice(1, wd - 1))
    assert torch.equal(got[win], want[win]) and torch.equal(gm, wm)

    if T == 1 and not static and spec.needs_rng:
        chi, acc = ops.rng_words((h, wd), 11, p_force=p_force, y0=7, xw0=5,
                                 variant=variant)
        got, gm = _host_step(host_kernel, w, 11, variant, 1, tile, p_force,
                             7, 5, None, (0,), mode=2, chi=chi, acc=acc)
        want, wm = fhp_step_ref(w, 11, p_force=p_force, y0=7, xw0=5,
                                variant=variant, record_steps=(0,))
        assert torch.equal(got, want) and torch.equal(gm, wm)


@pytest.mark.parametrize("variant,T,mode,static", [
    ("fhp2", 2, 0, False), ("fhp3", 1, 0, True), ("bml", 2, 0, False),
    ("fhp2", 2, 1, False), ("fhp3", 1, 2, False)])
def test_kernel_body_matches_reference_kernel(host_kernel, variant, T, mode,
                                              static):
    # The row-mapped body against the reference's Pallas kernel (interpret
    # mode) for one launch with moments on a 16-row, 16-word lattice with
    # 16-byte copies and a ragged (12, 12) tile: periodic (mode 0, with
    # the static-solid layout for fhp3), extended (1, y0 < 0) and
    # precomputed RNG (2).
    spec = rulespec.get_rule(variant)
    w = words(21 + T + mode, (2, spec.n_planes, 16, 16))
    p_force = 0.0 if variant == "bml" else 0.05
    y0, xw0 = (-T, -1) if mode == 1 else (3, 2)
    x = carry.planes_from_reference(w, CPU)
    solid = jsolid = None
    if static:
        sp = spec.solid_plane
        jsolid, w = jnp.asarray(w[0, sp]), w[:, :sp]
        solid, x = x[0, sp].clone(), x[:, :sp].contiguous()
    kw = dict(p_force=p_force, y0=y0, xw0=xw0, variant=variant,
              steps_per_launch=T)
    rs = tuple(range(T))
    if mode == 1:
        glob = dict(hg=36, wdg=19)
        want, wm = jops.fhp_step_pallas(jnp.asarray(w), 5, extended=True,
                                        record_steps=rs, block_rows=8,
                                        moment_bounds=(T, 16 - T, 1, 15),
                                        **glob, **kw)
        got, gm = _host_step(host_kernel, x, 5, variant, T, (12, 12),
                             p_force, y0, xw0, None, rs, mode=1,
                             bounds=(T, 16 - T, 1, 15), **glob)
        win = (..., slice(T, 16 - T), slice(1, 15))
        want, got = np.asarray(want)[win], carry.planes_to_reference(got)[win]
    else:
        want, wm = jops.fhp_step_pallas(
            jnp.asarray(w), 5, record_steps=rs, solid=jsolid,
            rng_in_kernel=mode != 2, **kw)
        chi = acc = None
        if mode == 2:
            chi, acc = ops.rng_words((16, 16), 5, p_force=p_force, y0=y0,
                                     xw0=xw0, variant=variant)
        got, gm = _host_step(host_kernel, x, 5, variant, T, (12, 12),
                             p_force, y0, xw0, solid, rs, mode=mode,
                             chi=chi, acc=acc)
        want, got = np.asarray(want), carry.planes_to_reference(got)
    assert np.array_equal(want, got)
    assert np.array_equal(np.asarray(wm), carry.moments_to_reference(gm))


def _plan(dll, store, extended, vec, wd, bw, T, tx):
    n = bw + 2 * T
    bufs = [np.zeros(n, dtype=np.int32) for _ in range(4)]
    units = dll.fhp_plan_host(store, extended, vec, wd, bw, T, tx,
                              *(b.ctypes.data for b in bufs))
    return [tuple(int(b[u]) for b in bufs) for u in range(units)]


@pytest.mark.parametrize("extended", [0, 1])
@pytest.mark.parametrize("vec", [0, 1])
@pytest.mark.parametrize("wd,bw,T", [(1024, 32, 8), (1024, 48, 8),
                                     (1024, 62, 1), (72, 30, 1), (16, 72, 2),
                                     (12, 5, 3), (8, 1, 1), (124, 32, 4)])
def test_copy_plan_covers_every_word_once(host_kernel, extended, vec, wd, bw,
                                          T):
    # Every apron word of every tile of the row is loaded exactly once from
    # the word src_index names, and every interior word that lies in the
    # array stored once; 16-byte chunks only with vec, from a source and
    # to a shared-memory word that are multiples of 4, and never across a
    # wrap or clamp.
    n = bw + 2 * T
    for tx in range(0, wd, bw):
        cover = np.zeros(n, dtype=int)
        for c, width, src, dst in _plan(host_kernel, 0, extended, vec, wd,
                                        bw, T, tx):
            cover[c:c + width] += 1
            if width == 4:
                assert vec and src % 4 == 0 and dst % 4 == 0
                assert 0 <= src and src + 4 <= wd and src == tx - T + c
            else:
                g = tx - T + c
                want = (min(max(g, 0), wd - 1) if extended else g % wd)
                assert src == want and dst == (tx - T) % 4 + c
        assert (cover == 1).all(), (tx, cover)
        cover = np.zeros(n, dtype=int)
        for c, width, src, dst in _plan(host_kernel, 1, extended, vec, wd,
                                        bw, T, tx):
            cover[c:c + width] += 1
            assert src == tx + c and dst == (tx - T) % 4 + T + c
            if width == 4:
                assert vec and src % 4 == 0 and dst % 4 == 0
        assert (cover[:min(bw, wd - tx)] == 1).all()
        assert not cover[min(bw, wd - tx):].any()
    if vec and wd % 4 == 0 and bw >= 8:
        assert any(u[1] == 4 for u in _plan(host_kernel, 0, extended, 1, wd,
                                            bw, T, 0))


@pytest.mark.parametrize("pq", [1, 2, 1966, 0x8000, 0xFFFF, 0, 65536,
                                0x1234, 0x0F00, 0x7FFF])
def test_unrolled_bernoulli_word(host_kernel, pq):
    # The kernel's unrolled, predicated comparator against the port's and
    # the reference's bernoulli_words_at on random signed coordinates.
    from repro.core import prng as jprng
    rng = np.random.default_rng(pq)
    n = 256
    rows = rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)
    cols = rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)
    t = 12345
    got = np.zeros(n, dtype=np.uint32)
    host_kernel.fhp_bernoulli_host(rows.ctypes.data, cols.ctypes.data, n, t,
                                   pq, got.ctypes.data)
    p = pq / 65536
    want = prng.bernoulli_words_at(torch.from_numpy(rows),
                                   torch.from_numpy(cols), t, p)
    assert np.array_equal(got.view(np.int32), want.numpy())
    jwant = jprng.bernoulli_words_at(jnp.asarray(rows), jnp.asarray(cols), t,
                                     p)
    assert np.array_equal(got, np.asarray(jwant).view(np.uint32))


def test_ptxas_report():
    text = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function "
        "'_ZN3fhp15fhp_step_kernelI9Rule_fhp2Lb1ELi1EEEvNS_6ParamsE' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN3fhp15fhp_step_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, 32 bytes smem, 408 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN3fhp15fhp_step_kernelI8Rule_bmlLb0ELi2EEEvNS_6ParamsE' for "
        "'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers, 16 bytes smem"])
    assert build.ptxas_report(text) == [
        {"kernel": "fhp2 static extended", "registers": 56,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "bml precomputed_rng", "registers": 64,
         "spill_stores": 8, "spill_loads": 4}]


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
    # A tile that overflows shared memory is refused where tiles run
    # (here an extended launch); a periodic launch streams, and there the
    # same block_rows/block_words name the rows and words a block owns.
    with pytest.raises(ValueError, match="shared memory"):
        ops.fhp_step_cuda(w, 0, steps_per_launch=8, block_rows=96,
                          block_words=96, extended=True, hg=16, wdg=8)
    assert ops.fhp_step_cuda(w, 0, steps_per_launch=8, block_rows=96,
                             block_words=96).shape == w.shape


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
    # One tile buffer (no ping-pong buffer) at its own size and a word per
    # tile row.
    assert ops.smem_bytes(32, 32, 8) == 8 * 48 * 48 * 4 + 48 * 4
    assert ops.smem_bytes(40, 48, 8, True) == (7 + 1) * 56 * 64 * 4 + 56 * 4
    assert ops.smem_bytes(64, 64, 8) == 8 * 80 * 80 * 4 + 80 * 4
    assert ops.smem_bytes(5, 1, 2, n_planes=2) == 2 * 9 * 8 * 4 + 9 * 4
    # Tiles whose origin can sit off a 16-byte boundary pad the row pitch
    # (62 + 2 words to 68, 30 + 4 to 40).
    assert ops.smem_bytes(64, 62, 1) == 8 * 66 * 68 * 4 + 66 * 4
    assert ops.smem_bytes(8, 30, 2) == 8 * 12 * 40 * 4 + 12 * 4
    # A tile row with its apron fills one warp's two 32-word passes, and
    # the most rows fit two blocks an SM.
    assert ops.pick_tile(4096, 1024, 8) == (40, 48)
    assert ops.pick_tile(4096, 1024, 8, static_solid=True) == (40, 48)
    assert ops.pick_tile(4096, 1024, 1) == (50, 62)
    assert ops.pick_tile(4096, 1024, 1, n_planes=2) == (208, 62)
    assert ops.pick_tile(2064, 514, 4) == (48, 56)
    assert ops.pick_tile(64, 1024, 16) == (24, 32)
    assert ops.pick_tile(16, 8, 8) == (16, 8)
    assert ops.pick_tile(70, 31, 1, n_planes=2) == (70, 31)
    for h, wd, T, sp, n in ((4096, 1024, 8, False, 8), (4096, 1024, 1, False, 8),
                            (4096, 1024, 2, True, 8), (4096, 1024, 1, False, 2),
                            (256, 125, 4, True, 8), (64, 3, 2, False, 2)):
        bh, bw = ops.pick_tile(h, wd, T, sp, n)
        assert ops.smem_bytes(bh, bw, T, sp, n) <= ops.TILE_SMEM_BYTES
        assert bh == h or ops.smem_bytes(bh + 1, bw, T, sp,
                                         n) > ops.TILE_SMEM_BYTES
        assert (bw + 2 * T) % ops.MAX_TILE == 0 or bw == wd
        assert T <= bh and (bw >= wd or T <= bw)
    with pytest.raises(ValueError, match="no valid tile"):
        ops.pick_tile(4, 64, 8)
    # A tile wider than a block covers runs as tiles of the widest width.
    assert ops.smem_bytes(8, 1100, 1, n_planes=2) == ops.smem_bytes(
        8, ops.MAX_TILE_WORDS - 2, 1, n_planes=2)


def test_tile_geometry_matches_kernel(host_kernel):
    # ops.smem_bytes and MAX_TILE_WORDS against the kernel's own geometry
    # (make_params and smem_words in csrc/fhp_step.cuh, built for the host).
    out = (ctypes.c_int * 4)()
    for bh, bw, T, n, solid in itertools.product(
            (1, 7, 40), (1, 3, 30, 48, 62, 125, 1020, 1023, 1208, 4840),
            (1, 2, 3, 8), (2, 7, 8), (False, True)):
        host_kernel.fhp_geometry_host(n - solid, bh, bw, T, solid, out)
        assert out[1] == (bh + 2 * T) * out[0] and out[0] % 4 == 0
        assert out[2] == ops.smem_bytes(bh, bw, T, solid, n), (bh, bw, T)
        assert out[3] == min(bw, ops.MAX_TILE_WORDS - 2 * T), (bw, T)


# The widest tile rows: a block covers up to MAX_TILE_WORDS words a row with
# the apron, and a wider tile runs as tiles of that width.  The widest
# one-row tiles the kernel took before the row-mapped redesign (bml rows of
# 4840 words and 8-plane rows of 1208 words at T = 1, as much as its two
# buffers fitted in shared memory) still run, bit-equal.
@pytest.mark.parametrize("variant,bw", [("bml", 1022), ("fhp2", 1022),
                                        ("bml", 4840), ("fhp2", 1208)])
def test_widest_tile_row(host_kernel, variant, bw):
    spec = rulespec.get_rule(variant)
    h, wd = 4, bw + 5
    p_force = 0.0 if variant == "bml" else 0.05
    w = torch.from_numpy(words(bw, (1, spec.n_planes, h, wd)).view(np.int32))
    kw = dict(p_force=p_force, y0=3, xw0=1, variant=variant,
              record_steps=(0,))
    want, wm = fhp_step_ref(w, 2, **kw)
    got, gm = ops.fhp_step_cuda(w, 2, block_rows=1, block_words=bw, **kw)
    assert torch.equal(got, want) and torch.equal(gm, wm)
    got, gm = _host_step(host_kernel, w, 2, variant, 1, (1, bw), p_force, 3,
                         1, None, (0,))
    assert torch.equal(got, want) and torch.equal(gm, wm)


# ---------------------------------------------------------------------------
# The row-streaming kernel (periodic launches without a solid operand).
# ---------------------------------------------------------------------------

# Lattices (H, Wd) and (block_rows, block_words) of streamed launches: even
# and odd H (the general parity path runs at an odd H's wrap), ragged Wd,
# 16-byte rows and rows that take single words, lattices narrower than one
# strip, shorter than one share and shorter than T, strips of 2 .. 8 chunks
# a warp; block_rows 0 shares the strip rows among the emulated persistent
# blocks, block_words 0 takes pick_stream's strips.
STREAM_LATTICES = [(22, 13), (5, 40), (3, 4), (40, 72), (9, 150), (7, 260),
                   (5, 530)]
STREAM_BLOCKS = [(0, 0), (0, 5), (8, 0), (7, 9), (1, 1000), (3, 120)]


@pytest.mark.parametrize("T", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("variant", codegen.RULES)
def test_streamed_kernel_body_matches_plain_version(host_kernel, variant, T):
    # The row-streaming kernel's per-thread functions, wave by wave, against
    # the plain version: planes and moments recorded at interior steps over
    # an interior window, from nonzero t0, y0 and xw0.
    spec = rulespec.get_rule(variant)
    rng = np.random.default_rng(T * 10 + len(variant))
    p_force = 0.0 if variant == "bml" else 0.05
    rs = tuple(range(T - 1, -1, -2))
    n = 0
    for (h, wd), (bh, bw) in itertools.product(STREAM_LATTICES,
                                               STREAM_BLOCKS):
        bw = bw or ops.pick_stream(h, wd, T, spec.n_planes, 2)
        y0 = 7 if (h + bw) % 2 else 4
        w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                          size=(2, spec.n_planes, h, wd),
                                          dtype=np.int64).astype(np.int32))
        bounds = (1, h - 1, 1, wd - 1) if min(h, wd) > 2 else (0, h, 0, wd)
        got, gm = _host_step(host_kernel, w, 11, variant, T, (bh, bw),
                             p_force, y0, 5, None, rs, mode=3, bounds=bounds)
        want, wm = fhp_step_ref(w, 11, p_force=p_force, y0=y0, xw0=5,
                                variant=variant, steps_per_launch=T,
                                record_steps=rs, moment_bounds=bounds)
        assert torch.equal(got, want), ((h, wd), (bh, bw))
        assert torch.equal(gm, wm), ((h, wd), (bh, bw))
        n += 1
    assert n == len(STREAM_LATTICES) * len(STREAM_BLOCKS)


@pytest.mark.parametrize("T", [1, 2, 3, 8, 16])
def test_stream_ring_schedule_never_aliases(host_kernel, T):
    # The kernel's wave schedule: every row a level reads in a wave is in
    # the slot it reads, written in an earlier wave (an input row: landed,
    # its load waited for at the end of wave q) and not overwritten since;
    # no slot a level writes, nor one an input row is still being loaded
    # into, is read in the same wave; level T writes rows T .. n + T - 1,
    # each once, in order.
    for n in (1, 2, 5, 3 * T + 4):
        waves = n + 3 * T
        written = np.zeros((waves, T + 1, 2), dtype=np.int32)
        read = np.zeros((waves, T, 3), dtype=np.int32)
        assert host_kernel.fhp_stream_schedule_host(
            T, n, written.ctypes.data, read.ctypes.data) == waves
        ahead = ops.STREAM_AHEAD
        ring = [dict() for _ in range(T)]     # level -> slot -> row
        busy = {}                             # input slot -> landing wave
        for q in range(ahead):                # the segment's first loads
            busy[q % (ops.STREAM_RING + ahead)] = q
            ring[0][q % (ops.STREAM_RING + ahead)] = q
        finished = []
        for i in range(waves):
            writes = {L: written[i, L, 1] for L in range(1, T)
                      if written[i, L, 0] >= 0}
            for s in range(1, T + 1):
                q = i - 2 * s
                if read[i, s - 1, 0] < 0:
                    assert not s <= q < n + 2 * T - s, (i, s)
                    continue
                for k, row in enumerate((q + 1, q, q - 1)):
                    slot = read[i, s - 1, k]
                    assert ring[s - 1].get(slot) == row, (T, n, i, s, row)
                    if s == 1:
                        assert busy[slot] < i, (T, n, i, slot)
                    else:
                        assert writes.get(s - 1) != slot, (T, n, i, s)
            for L, slot in writes.items():
                ring[L][slot] = written[i, L, 0]
            if written[i, T, 0] >= 0:
                finished.append(written[i, T, 0])
            q0, slot0 = written[i, 0]
            if q0 >= 0:
                assert busy.get(slot0, -1) < i, (T, n, i)
                ring[0][slot0] = q0
                busy[slot0] = q0          # waited for at the end of wave q0
        assert finished == list(range(T, n + T))


def test_stream_geometry_matches_kernel(host_kernel):
    # ops.stream_geometry, stream_max_owned and their shared memory against
    # the kernel's own (stream_geom in csrc/fhp_step.cuh, built for the
    # host).
    out = (ctypes.c_int * 7)()
    n = 0
    for wd, T, nps, bw in itertools.product(
            (1, 4, 13, 72, 125, 1024, 4840), (1, 2, 3, 5, 8, 16, 24, 31),
            (2, 8), (0, 1, 5, 171, 342, 5000)):
        host_kernel.fhp_stream_geometry_host(wd, T, nps, bw or 10 ** 6, out)
        assert out[6] == ops.stream_max_owned(T, nps), (T, nps)
        if out[6] < 1:
            with pytest.raises(ValueError, match="cannot stream"):
                ops.stream_geometry(wd, T, nps, bw)
            continue
        g = ops.stream_geometry(wd, T, nps, bw)
        assert tuple(out[:6]) == (g["strips"], g["words"],
                                  32 * g["chunks"] * nps, g["per_warp"],
                                  g["warps"], g["smem_bytes"]), (wd, T, bw)
        assert g["smem_bytes"] <= ops.STREAM_SMEM_BYTES
        assert g["warps"] <= ops.STREAM_WARPS
        assert g["owned"] * g["strips"] >= wd > (g["owned"] - 1) * g["strips"]
        n += 1
    assert n > 500


def test_pick_stream():
    # The main path's launch: 6 strips of 171 words at T = 8 (24 warps of
    # 2 chunks); BML's 2 planes take wider strips and more chunks a warp.
    assert ops.pick_stream(4096, 1024, 8, 8, 4) == 171
    assert ops.stream_geometry(1024, 8, 8, 171) == {
        "strips": 6, "owned": 171, "words": 187, "chunks": 6,
        "per_warp": 2, "warps": 24, "smem_bytes": 221_184}
    assert ops.pick_stream(4096, 1024, 8, 2, 4) == 512
    assert ops.stream_geometry(1024, 8, 2, 512)["per_warp"] == 8
    assert ops.pick_stream(4096, 1024, 1, 8, 4) == 342
    # Every pick fits; a T whose rings cannot fit gets none (tiles run).
    for h, wd, T, n in itertools.product((3, 1024, 4096), (1, 13, 128, 1024),
                                         (1, 2, 4, 8, 16, 24), (2, 8)):
        bw = ops.pick_stream(h, wd, T, n, 4)
        g = ops.stream_geometry(wd, T, n, bw)
        assert g["owned"] <= bw <= ops.stream_max_owned(T, n)
        assert ops.stream_cost(h, wd, T, n, 4, bw) <= min(
            (ops.stream_cost(h, wd, T, n, 4, -(-wd // k)) for k in (1, 2, 3)
             if -(-wd // k) <= ops.stream_max_owned(T, n)),
            default=float("inf"))
    assert ops.pick_stream(4096, 1024, 25, 8) is None
    assert ops.stream_max_owned(24, 8) >= 1 > ops.stream_max_owned(25, 8)
    # Thread word-steps per owned word-step: the apron's columns and the
    # segments' warm-up, far below the tile's 1.567 at 40 x 48, T = 8.
    assert 1.0 < ops.stream_thread_steps(4096, 1024, 8, 8, 4, 171) < 1.2


def test_streamed_launches_counted_apart():
    # "streamed" counts launches that also count under their mode, as
    # "moments" does: launches_total sums the modes only.
    ops.LAUNCHES.clear()
    try:
        ops.LAUNCHES.update(periodic=8, streamed=8, moments=8, extended=2)
        assert ops.launches_total() == 10
    finally:
        ops.LAUNCHES.clear()


def test_ptxas_report_names_streamed_kernels():
    text = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN3fhp22fhp_step_stream_kernelI9Rule_fhp2Li2EEEvNS_6ParamsENS_"
        "10StreamGeomE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, 768 bytes smem"])
    assert build.ptxas_report(text) == [
        {"kernel": "fhp2 streamed J=2", "registers": 72, "spill_stores": 0,
         "spill_loads": 0}]


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


def test_loop_bodies_of_built_kernel():
    # A kernel with a two-barrier round loop inside a step loop, and a
    # second function that must not be read.
    body = ["S2R R0, SR_TID.X ;",                       # 0x00
            "LDS R1, [R0] ;",                            # 0x10 step loop
            "LOP3.LUT R1, R1, R2, RZ, 0x3c, !PT ;",      # 0x20 round loop
            "IMAD R3, R1, 0x3, RZ ;",
            "BAR.SYNC.DEFER_BLOCKING 0x0 ;",
            "STS [R0], R1 ;",
            "BAR.SYNC.DEFER_BLOCKING 0x0 ;",
            "@P0 BRA 0x20 ;",                            # 0x70
            "@P1 BRA 0x10 ;",                            # 0x80
            "EXIT ;"]
    lines = ["\t\tFunction : _ZN3fhp15fhp_step_kernelI9Rule_fhp2Lb0ELi0E"]
    lines += [f"        /*{16 * i:04x}*/   {insn}   /* 0x0 */"
              for i, insn in enumerate(body)]
    lines += ["\t\tFunction : other", "        /*0000*/   BRA 0x0 ;"]
    loops = opcount.loop_bodies("\n".join(lines), "fhp2Lb0ELi0E")
    assert [(b["start"], b["end"], b["barriers"]) for b in loops] == [
        (0x10, 0x80, 2), (0x20, 0x70, 2)]
    assert loops[1] == {"alu": 1, "fma": 1, "popc": 0, "other": 0,
                        "shared": 1, "barriers": 2, "total": 6,
                        "start": 0x20, "end": 0x70}


def test_ops_ms_takes_the_slowest_pipe():
    clocks = opcount.SM_CLOCKS_PER_S          # one SM-clock summed: 1 s
    assert opcount.ops_ms(clocks, {"alu": 64, "fma": 0, "popc": 0,
                                   "other": 0}) == (1000.0, "alu")
    assert opcount.ops_ms(clocks, {"alu": 32, "fma": 32, "popc": 8,
                                   "other": 56}) == (1000.0, "issue")
    ms, pipe = opcount.ops_ms(clocks, {"alu": 10, "fma": 10, "popc": 32,
                                       "other": 0})
    assert (ms, pipe) == (2000.0, "popc")
