"""The port's checkpoint store against the reference's: the same on-disk
format, so a tree saved by either store restores bit for bit in the
other; torn and corrupt checkpoints of either make the port's
``latest_valid_step`` fall back; a serve engine checkpointed mid-run by
one package resumes in the other and finishes with the reference's
results; bfloat16 leaves (an optimizer's moments) are written in the
reference's form (raw ``<V2`` words, manifest dtype ``bfloat16``) and
cross bit for bit.  Then the port's store on its own: typed errors,
subsets, the async manager and lattices placed on a mesh."""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve as ts
from repro.checkpoint import store as jstore
from repro.serve import CAServeEngine as JEngine
from repro.serve import Fault as JFault
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import SimJob as JSimJob
from repro.serve import SimulatedCrash as JSimulatedCrash
from repro_torch.checkpoint import (CheckpointExistsError, CheckpointManager,
                                    ChecksumError, LeafMismatchError,
                                    ManifestError, latest_step,
                                    latest_valid_step, load_leaf, load_meta,
                                    restore, save, store, verify_checkpoint)
from repro_torch.core import carry, distributed
from repro_torch.serve import (CAServeEngine, Fault, FaultInjector, SimJob,
                               SimulatedCrash)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _runner_cache():
    with ts.reference_runner_cache():
        yield


def _host_tree(seed=0, shape=(4, 8)):
    """The engine's kind of tree, on the host: uint32 lattices under keys
    that need the ``_SAFE`` substitution, float and int leaves, a list."""
    rng = np.random.default_rng(seed)
    return {"groups": {"fhp2|0.03": rng.integers(0, 2**32, (2, 8) + shape,
                                                 dtype=np.uint32)},
            "b": {"c": rng.standard_normal(shape).astype(np.float32)},
            "lst": [np.arange(6, dtype=np.int32) + seed,
                    rng.integers(0, 2**32, shape, dtype=np.uint32)]}


def _leaves(tree):
    return [leaf for _, leaf in store._leaves(tree)]


def _assert_tree_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        a = carry.planes_to_reference(a) if isinstance(a, torch.Tensor) \
            and a.dtype == torch.int32 else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def _port_target(tree):
    """The port's restore target for a host tree: lattices as int32
    tensors, the other leaves as tensors of their own type."""
    def conv(x):
        if x.dtype == np.uint32:
            return carry.planes_from_reference(np.zeros_like(x), CPU)
        return torch.zeros(x.shape, dtype=torch.from_numpy(x).dtype)
    return store._unflatten(tree, iter([conv(x) for x in _leaves(tree)]))


def _port_tree(tree):
    """The same tree as the port holds it: float and int leaves as
    tensors, lattices converted to uint32 words (as the engine does)."""
    return store._unflatten(tree, iter(
        [x if x.dtype == np.uint32 else torch.from_numpy(x.copy())
         for x in _leaves(tree)]))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tree_restores_bit_exactly_in_the_other(tmp_path, writer):
    tree = _host_tree(seed=1)
    d = str(tmp_path)
    if writer == "port":
        save(d, 3, _port_tree(tree), meta={"rule": "fhp2", "t": 6})
        got = jstore.restore(d, 3, _host_tree(seed=9))
        assert jstore.load_meta(d, 3) == {"rule": "fhp2", "t": 6}
    else:
        jstore.save(d, 3, tree, meta={"rule": "fhp2", "t": 6})
        got = restore(d, 3, _port_target(tree))
        assert load_meta(d, 3) == {"rule": "fhp2", "t": 6}
        lattice = got["groups"]["fhp2|0.03"]
        assert lattice.dtype == torch.int32 and lattice.device == CPU
    _assert_tree_equal(got, tree)
    assert latest_step(d) == jstore.latest_step(d) == 3


def test_same_files_from_both_stores(tmp_path):
    tree = _host_tree(seed=2)
    save(str(tmp_path / "p"), 1, _port_tree(tree), meta={"k": [1, 2]})
    jstore.save(str(tmp_path / "r"), 1, tree, meta={"k": [1, 2]})
    p, r = (store.step_dir(str(tmp_path / x), 1) for x in "pr")
    assert sorted(os.listdir(p)) == sorted(os.listdir(r))
    mp, mr = (json.load(open(os.path.join(x, "manifest.json")))
              for x in (p, r))
    assert mp == mr
    for fn in os.listdir(p):
        assert open(os.path.join(p, fn), "rb").read() == \
            open(os.path.join(r, fn), "rb").read(), fn


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_latest_valid_step_falls_back(tmp_path, writer):
    d = str(tmp_path)
    for s in (2, 4, 6, 8):
        if writer == "port":
            save(d, s, _port_tree(_host_tree(seed=s)))
        else:
            jstore.save(d, s, _host_tree(seed=s))
    assert latest_valid_step(d) == 8
    fn = os.path.join(store.step_dir(d, 8), "b_c.npy")       # torn leaf
    with open(fn, "r+b") as fh:
        fh.truncate(os.path.getsize(fn) // 2)
    assert latest_valid_step(d) == 6
    fn = os.path.join(store.step_dir(d, 6), "lst_1.npy")     # crc mismatch
    raw = bytearray(open(fn, "rb").read())
    raw[-4] ^= 0x55
    open(fn, "wb").write(bytes(raw))
    with pytest.raises(ChecksumError):
        verify_checkpoint(d, 6)
    assert latest_valid_step(d) == 4
    with open(os.path.join(store.step_dir(d, 4), "manifest.json"),
              "w") as f:
        f.write('{"step": 4, "leav')                         # torn manifest
    assert latest_valid_step(d) == jstore.latest_valid_step(d) == 2
    _assert_tree_equal(restore(d, 2, _port_target(_host_tree())),
                       _host_tree(seed=2))


@pytest.mark.parametrize("crash_in", ["reference", "port"])
def test_engine_resumes_in_the_other_package(tmp_path, crash_in):
    """An engine killed at round 5 (checkpoints every 2 rounds) resumes in
    the other package and finishes with the results of the reference's
    uninterrupted run."""
    d = str(tmp_path / "svc")
    kw = dict(height=ts.H, width=ts.W, slots=2, depth=2, ckpt_every=2)
    clean = JEngine(**kw)
    jobs = [dict(rid=rid, scenario="bml_city" if rid % 3 == 1
                 else "cylinder", steps=12, frame_every=4,
                 overrides={"seed": rid}) for rid in range(3)]
    for job in jobs:
        clean.submit(JSimJob(**job))
    clean.drain()
    if crash_in == "reference":
        eng = JEngine(ckpt_dir=d, injector=JFaultInjector(
            [JFault(kind="killed_step", round=5)]), **kw)
        crash, cls = JSimulatedCrash, JSimJob
    else:
        eng = CAServeEngine(ckpt_dir=d, device=CPU, injector=FaultInjector(
            [Fault(kind="killed_step", round=5)]), **kw)
        crash, cls = SimulatedCrash, SimJob
    for job in jobs:
        eng.submit(cls(**job))
    with pytest.raises(crash):
        eng.drain()
    resumed = (CAServeEngine.resume(d, ckpt_every=2, device=CPU)
               if crash_in == "reference" else
               JEngine.resume(d, ckpt_every=2))
    assert resumed.round == 4
    assert sorted(j.rid for j in resumed.drain()) == [0, 1, 2]
    for rid, job in clean.jobs.items():
        got = resumed.jobs[rid]
        assert np.array_equal(np.asarray(got.result), job.result), rid
        # Frames are not checkpointed: the replay streams those after the
        # anchor, as the uninterrupted run did.
        assert got.frames == {s: f for s, f in job.frames.items()
                              if s > 8}, rid
    assert resumed.stats["jobs_done"] == 3


# ---------------------------------------------------------------------------
# The port's store on its own
# ---------------------------------------------------------------------------

def test_overwrite_refused_then_swapped(tmp_path):
    d = str(tmp_path)
    save(d, 1, _host_tree(seed=0))
    with pytest.raises(CheckpointExistsError):
        save(d, 1, _host_tree(seed=9))
    _assert_tree_equal(restore(d, 1, _host_tree(seed=3)), _host_tree(seed=0))
    save(d, 1, _host_tree(seed=2), overwrite=True)
    _assert_tree_equal(restore(d, 1, _host_tree(seed=3)), _host_tree(seed=2))
    assert os.listdir(d) == ["step_00000001"]


def test_typed_restore_errors(tmp_path):
    d = str(tmp_path)
    path = save(d, 1, _host_tree())
    with pytest.raises(LeafMismatchError) as ei:
        restore(d, 1, _host_tree(shape=(4, 16)))
    assert ei.value.key == "b/c" and ei.value.found == (4, 8)
    with pytest.raises(LeafMismatchError):
        restore(d, 1, {"b": {"c": np.zeros((4, 8), np.float32)}})
    with pytest.raises(LeafMismatchError) as ei:
        restore(d, 1, {"b": {"c": np.zeros((4, 8), np.float32)},
                       "zz": np.zeros(2)}, strict=False)
    assert ei.value.key == "zz"
    got = restore(d, 1, {"b": {"c": np.zeros((4, 8), np.float32)}},
                  strict=False)
    assert np.array_equal(got["b"]["c"], _host_tree()["b"]["c"])
    with pytest.raises(LeafMismatchError):
        load_leaf(d, 1, "b/missing")
    arr = np.load(os.path.join(path, "b_c.npy"))
    arr.flat[0] += 1
    np.save(os.path.join(path, "b_c.npy"), arr)
    with pytest.raises(ChecksumError):
        load_leaf(d, 1, "b/c")
    assert np.array_equal(load_leaf(d, 1, "b/c", check=False), arr)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write("not json")
    with pytest.raises(ManifestError):
        restore(d, 1, _host_tree())


def test_sharded_lattice_saved_and_placed_on_a_mesh(tmp_path):
    """A ``ShardedPlanes`` leaf is saved whole; restore places it with the
    target's sharding, or with another one given in ``shardings``."""
    d = str(tmp_path)
    words = _host_tree()["groups"]["fhp2|0.03"]                # (2, 8, 4, 8)
    mesh = distributed.make_mesh((2, 2), ("data", "model"), CPU)
    sharding = distributed.lattice_spec(mesh)
    placed = sharding.place(carry.planes_from_reference(words, CPU))
    save(d, 1, {"s": carry.planes_to_reference(placed.gather())})
    got = restore(d, 1, {"s": placed})["s"]
    assert isinstance(got, distributed.ShardedPlanes)
    assert np.array_equal(carry.planes_to_reference(got.gather()), words)
    row = distributed.lattice_spec(distributed.make_mesh(
        (1, 2), ("data", "model"), CPU))
    got = restore(d, 1, {"s": torch.zeros(words.shape, dtype=torch.int32)},
                  shardings={"s": row})["s"]
    assert got.sharding is row
    assert np.array_equal(carry.planes_to_reference(got.gather()), words)
    assert np.array_equal(jstore.restore(d, 1, {"s": jnp.zeros(
        words.shape, jnp.uint32)})["s"], words)


def test_manager_errors_drain_and_close(tmp_path):
    d = str(tmp_path)
    m = CheckpointManager(d, overwrite=False, keep=2)
    m.save_async(1, _port_tree(_host_tree()))
    m.wait()
    m.save_async(1, _host_tree(seed=2))        # refused: already published
    with pytest.raises(CheckpointExistsError):
        m.wait()
    for s in range(2, 6):
        m.save_async(s, _port_tree(_host_tree(seed=s)))
    m.close()
    assert store._steps(d) == [4, 5] and latest_valid_step(d) == 5
    with pytest.raises(RuntimeError):
        m.save_async(6, _host_tree())
    m.close()                                  # idempotent


def test_manager_snapshot_and_close_race(tmp_path):
    """``save_async`` copies tensors to the host at once (the caller may
    overwrite them), and a save racing ``close`` is written or refused,
    never dropped."""
    d = str(tmp_path)
    m = CheckpointManager(d, keep=100)
    t = torch.ones(4, dtype=torch.int64)
    m.save_async(1, {"x": t})
    t.zero_()
    accepted, rejected = [], []
    barrier = threading.Barrier(3)

    def submit(base):
        barrier.wait()
        for i in range(20):
            try:
                m.save_async(base + i, {"x": np.full(2, base + i)})
                accepted.append(base + i)
            except RuntimeError:
                rejected.append(base + i)

    threads = [threading.Thread(target=submit, args=(b,)) for b in (100, 200)]
    for th in threads:
        th.start()
    barrier.wait()
    m.close()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert set(store._steps(d)) == {1} | set(accepted)
    assert set(accepted).isdisjoint(rejected)
    assert load_leaf(d, 1, "x").tolist() == [1, 1, 1, 1]


def _bf16_tree(seed=4):
    """bfloat16 leaves (every bit pattern of a random draw, a 0-d one and
    a negative zero) beside float32 and int32 ones, as the port holds
    them and as the reference does (ml_dtypes arrays from jax)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 16, (3, 5), dtype=np.uint16)
    words[0, 0] = 0x8000
    tree = {"m": {"w": torch.from_numpy(words.view(np.int16).copy()).view(
                torch.bfloat16),
                  "s": torch.tensor(-1.5, dtype=torch.bfloat16)},
            "p": torch.from_numpy(rng.standard_normal(4).astype(np.float32)),
            "step": torch.tensor(7, dtype=torch.int32)}
    ref = {"m": {"w": np.asarray(jnp.asarray(words).view(jnp.bfloat16)),
                 "s": np.asarray(jnp.asarray(-1.5, jnp.bfloat16))},
           "p": tree["p"].numpy(), "step": np.int32(7)}
    return tree, ref


def jax_tree(ref):
    """A numpy tree as the reference's arrays."""
    return {k: (jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in ref.items()}


def _bits(x):
    """A leaf's raw bytes (bfloat16 tensors through an int16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    tree, _ = _bf16_tree()
    save(str(tmp_path), 2, tree)
    verify_checkpoint(str(tmp_path), 2)
    info = json.load(open(os.path.join(store.step_dir(str(tmp_path), 2),
                                       "manifest.json")))["leaves"]
    assert info["m/w"]["dtype"] == info["m/s"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(store.step_dir(str(tmp_path), 2),
                                info["m/w"]["file"])).dtype.str == "|V2"
    target = store._unflatten(tree, iter(
        [torch.zeros_like(x) for x in _leaves(tree)]))
    got = restore(str(tmp_path), 2, target)
    for a, b in zip(_leaves(got), _leaves(tree), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)
    # A float32 target takes the bfloat16 values exactly.
    wide = restore(str(tmp_path), 2, dict(target, m={
        k: torch.zeros(v.shape) for k, v in target["m"].items()}))
    assert torch.equal(wide["m"]["w"], tree["m"]["w"].float())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_checkpoints_cross_bit_for_bit(tmp_path, writer):
    tree, ref = _bf16_tree(seed=5)
    d = str(tmp_path)
    if writer == "port":
        save(d, 1, tree)
        got = jstore.restore(d, 1, jax_tree(ref))
        assert str(got["m"]["w"].dtype) == "bfloat16"
    else:
        jstore.save(d, 1, jax_tree(ref))
        got = restore(d, 1, store._unflatten(tree, iter(
            [torch.zeros_like(x) for x in _leaves(tree)])))
        assert got["m"]["w"].dtype == torch.bfloat16
    for a, b in zip(_leaves(got), _leaves(tree), strict=True):
        assert _bits(a) == _bits(b)


def test_bf16_files_equal_the_reference(tmp_path):
    tree, ref = _bf16_tree(seed=6)
    save(str(tmp_path / "p"), 1, tree)
    jstore.save(str(tmp_path / "r"), 1, jax_tree(ref))
    p, r = (store.step_dir(str(tmp_path / x), 1) for x in "pr")
    assert json.load(open(os.path.join(p, "manifest.json"))) == \
        json.load(open(os.path.join(r, "manifest.json")))
    for fn in sorted(os.listdir(p)):
        assert open(os.path.join(p, fn), "rb").read() == \
            open(os.path.join(r, fn), "rb").read(), fn
