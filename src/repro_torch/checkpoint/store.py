"""Sharded checkpointing: save/restore trees of tensors with async
writes, reshard-on-restore, and torn-write hardening.

The counterpart of ``repro/checkpoint/store.py``, with the same on-disk
format, so a checkpoint written by either package restores bit for bit
in the other.  One directory per step containing

* ``manifest.json`` -- tree structure (flattened key paths), shapes,
  dtypes, per-leaf crc32 checksums, step;
* one ``.npy`` per leaf (written from a host copy).

A tree is nested dicts (keys sorted, as jax's tree flattening orders
them), lists and tuples (by index); ``None`` is an empty subtree.  A leaf
is a numpy array or a tensor.  Leaf keys join the path's keys with
``/``, each with characters outside ``[A-Za-z0-9_.-]`` replaced by ``_``.
Tensors are saved with their own dtype: callers that hold lattices as
int32 bit-views convert them to the reference's uint32 words first
(``core.carry.planes_to_reference``), as the serve engine does.

Restore takes a *target tree*: each leaf is loaded, cast to the target
leaf's dtype (uint32 words into an int32 target keep their bits,
``core.carry.planes_from_reference``) and placed like it -- a numpy
target gives a numpy array, a tensor target a tensor on its device, a
``ShardedPlanes`` target a lattice placed with its sharding.  An optional
*sharding tree* overrides the placement per leaf (a ``torch.device`` or a
``LatticeSharding``), so a run can restart on a different mesh (elastic
re-scale) -- the arrays were saved with logical (global) shapes.

Hardening (the serve layer's rollback path leans on all of this):

* a checkpoint is *published* only by the final directory rename; a save
  that would overwrite an existing step either refuses
  (:class:`CheckpointExistsError`, the default) or swaps via a unique
  rename so no crash window ever destroys the previous good copy;
* every leaf carries a crc32 in the manifest; ``restore`` verifies it
  (:class:`ChecksumError` on mismatch) so silent on-disk corruption is
  caught before it poisons a replay;
* :func:`latest_valid_step` walks steps newest-first and returns the
  first checkpoint that passes :func:`verify_checkpoint` -- torn
  manifests, truncated ``.npy`` files, and checksum mismatches all fall
  through to the previous good checkpoint.

Shape/structure mismatches raise typed :class:`CheckpointError`
subclasses carrying the leaf key and expected-vs-found values (no bare
asserts on the restore path).

The writer is asynchronous (``save_async`` copies every leaf to the host,
then a worker thread writes); ``wait()`` blocks and drains (then clears)
the accumulated worker errors; ``close()`` stops accepting new work
*before* draining, so a concurrent ``save_async`` can never slip behind
the shutdown sentinel and be silently dropped.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core import carry
from repro_torch.core.distributed import LatticeSharding, ShardedPlanes

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
_STEP_DIR = re.compile(r"^step_(\d{8})$")


class CheckpointError(Exception):
    """Base class for checkpoint load/save failures."""


class CheckpointExistsError(CheckpointError):
    """``save`` would overwrite an already-published checkpoint."""


class ManifestError(CheckpointError):
    """Missing or unreadable ``manifest.json`` (torn checkpoint)."""


class LeafMismatchError(CheckpointError):
    """A leaf is missing or its shape/count disagrees with the target.

    Carries ``key`` plus ``expected`` / ``found`` (shapes, or counts for
    whole-tree mismatches with ``key=None``)."""

    def __init__(self, key, expected, found, what: str = "shape"):
        self.key, self.expected, self.found = key, expected, found
        super().__init__(
            f"checkpoint leaf {what} mismatch at {key!r}: "
            f"expected {expected}, found {found}")


class ChecksumError(CheckpointError):
    """A leaf's on-disk bytes fail the manifest crc32 (corruption)."""

    def __init__(self, key, expected, found):
        self.key, self.expected, self.found = key, expected, found
        super().__init__(
            f"checkpoint leaf {key!r} checksum mismatch: "
            f"manifest crc32={expected}, on-disk crc32={found}")


def _leaves(tree, path=(), keep_none: bool = False):
    """``[(path, leaf)]`` in jax's tree-flattening order: dict keys
    sorted, lists and tuples by index, ``None`` an empty subtree (a leaf
    with ``keep_none``, for sharding trees)."""
    if tree is None and not keep_none:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], path + (k,), keep_none)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, path + (i,), keep_none)]
    return [(path, tree)]


def _key(path) -> str:
    return "/".join(_SAFE.sub("_", str(p)) for p in path)


def _flatten(tree):
    return {_key(path): leaf for path, leaf in _leaves(tree)}


def _unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in order, by
    ``values`` (an iterator)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: None for k in tree}
        for k in sorted(tree):
            out[k] = _unflatten(tree[k], values)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values) for v in tree)
    return next(values)


def _host(leaf) -> np.ndarray:
    """A host numpy view of ``leaf`` (no copy where it already is one)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Any, meta: Optional[dict] = None,
         overwrite: bool = False) -> str:
    """Synchronous save.  Returns the checkpoint path.

    ``meta`` is an optional JSON-serializable dict stored in the
    manifest (e.g. ``{"rule": "fhp3", "t": 40}``): everything a restart
    needs to replay bit-exactly that is not derivable from the arrays
    themselves -- read it back with ``load_meta``.

    Publication is crash-safe: the tree is staged into a unique temp
    directory and renamed into place.  If ``step`` already exists,
    ``overwrite=False`` (default) refuses with
    :class:`CheckpointExistsError` -- re-publishing a step is a logic
    error on the normal path; ``overwrite=True`` swaps via a unique
    rename (old copy moved aside first, removed last), so at no instant
    between syscalls is the previous good copy destroyed without a
    complete replacement staged on disk.
    """
    from repro_torch import telemetry
    with telemetry.span("checkpoint.save", step=step):
        return _save(directory, step, tree, meta, overwrite)


def _save(directory: str, step: int, tree: Any, meta: Optional[dict],
          overwrite: bool) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp_{step}_{os.getpid()}")
    final = step_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    manifest = {"step": step, "leaves": {}, "meta": meta or {}}
    for key, leaf in flat.items():
        arr = _host(leaf)
        fn = _SAFE.sub("_", key) + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype),
                                   "crc32": _crc(arr)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        if not overwrite:
            shutil.rmtree(tmp, ignore_errors=True)
            raise CheckpointExistsError(
                f"checkpoint step {step} already published at {final}")
        old = f"{final}.old.{os.getpid()}"
        if os.path.exists(old):  # stale leftover from a crashed swap
            shutil.rmtree(old)
        os.rename(final, old)
        os.rename(tmp, final)   # atomic publish
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)   # atomic publish
    return final


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _STEP_DIR.match(d)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = [s for s in _steps(directory)
             if os.path.exists(os.path.join(step_dir(directory, s),
                                            "manifest.json"))]
    return max(steps) if steps else None


def _load_manifest(path: str) -> dict:
    mf = os.path.join(path, "manifest.json")
    try:
        with open(mf) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ManifestError(f"unreadable manifest at {mf}: {e}") from e
    if "leaves" not in manifest:
        raise ManifestError(f"manifest at {mf} has no leaves table")
    return manifest


def _load(path: str, key: str, info: dict, check: bool) -> np.ndarray:
    """One leaf's array, loadable and (with ``check``) crc32-verified."""
    try:
        arr = np.load(os.path.join(path, info["file"]))
    except (OSError, ValueError) as e:
        raise LeafMismatchError(key, "loadable .npy",
                                f"unreadable ({e})", what="file") from e
    if check and "crc32" in info:
        found = _crc(arr)
        if found != info["crc32"]:
            raise ChecksumError(key, info["crc32"], found)
    return arr


def verify_checkpoint(directory: str, step: int) -> None:
    """Raise a :class:`CheckpointError` unless the checkpoint at
    ``step`` is complete and uncorrupted: readable manifest, every leaf
    file present and loadable, shape/dtype as declared, crc32 matching.
    """
    path = step_dir(directory, step)
    manifest = _load_manifest(path)
    for key, info in manifest["leaves"].items():
        arr = _load(path, key, info, check=False)
        if list(arr.shape) != list(info["shape"]):
            raise LeafMismatchError(key, tuple(info["shape"]),
                                    tuple(arr.shape))
        if "crc32" in info:
            found = _crc(arr)
            if found != info["crc32"]:
                raise ChecksumError(key, info["crc32"], found)


def latest_valid_step(directory: str) -> Optional[int]:
    """Newest step whose checkpoint passes :func:`verify_checkpoint`.

    Torn manifests, truncated leaf files, and checksum mismatches are
    all skipped -- this is the rollback anchor: the serve layer restores
    from here so a crash mid-save (or injected corruption) costs at most
    one checkpoint interval, never the run."""
    for s in reversed(_steps(directory)):
        try:
            verify_checkpoint(directory, s)
        except CheckpointError:
            continue
        return s
    return None


def load_meta(directory: str, step: int) -> dict:
    """The ``meta`` dict stored with ``save`` (empty for old
    checkpoints)."""
    return _load_manifest(step_dir(directory, step)).get("meta", {})


def load_leaf(directory: str, step: int, key: str,
              check: bool = True) -> np.ndarray:
    """Load one leaf by its flattened key (e.g. ``"parked/7"``) as a host
    numpy array, crc32-verified -- the serve layer restores parked-job
    lattices this way, individually, without materialising a target
    tree."""
    path = step_dir(directory, step)
    manifest = _load_manifest(path)
    if key not in manifest["leaves"]:
        raise LeafMismatchError(key, "present in manifest", "missing",
                                what="leaf")
    return _load(path, key, manifest["leaves"][key], check)


def _place(arr: np.ndarray, tgt, sh):
    """``arr`` cast to ``tgt``'s dtype and placed like ``tgt`` (or on
    ``sh``: a ``torch.device`` or a ``LatticeSharding``)."""
    if isinstance(tgt, np.ndarray):
        if sh is None:
            return arr.astype(tgt.dtype)
        tgt = torch.from_numpy(tgt)
    if isinstance(tgt, ShardedPlanes):
        dtype, default = tgt.tiles[0][0].dtype, tgt.sharding
    else:
        dtype, default = tgt.dtype, tgt.device
    sh = default if sh is None else sh
    dev = sh.devices[0][0] if isinstance(sh, LatticeSharding) else sh
    if arr.dtype == np.uint32 and dtype == torch.int32:
        t = carry.planes_from_reference(arr, dev)      # same bits
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev, dtype)
    return sh.place(t) if isinstance(sh, LatticeSharding) else t


def restore(directory: str, step: int, target_tree: Any,
            shardings: Any = None, check: bool = True,
            strict: bool = True) -> Any:
    """Load a checkpoint into the structure of ``target_tree``.

    ``shardings`` (optional, same structure; ``None`` leaves mean "like
    the target") places leaves on a ``torch.device`` or a
    ``LatticeSharding`` -- this is the elastic-restart path: the saved
    logical arrays are placed onto whatever mesh the restarted job runs
    with.

    ``check=True`` (default) verifies each leaf's crc32 against the
    manifest before placement (:class:`ChecksumError` on mismatch);
    structure and shape disagreements raise :class:`LeafMismatchError`
    with the offending key and expected-vs-found shapes.

    ``strict=True`` (default) additionally requires the manifest's leaf
    count to match the target exactly.  ``strict=False`` restores a
    *subset*: every target leaf must still be present, shape-correct,
    and checksum-clean, but the checkpoint may carry extra leaves (the
    serve layer's parked-job lattices, loaded individually via
    :func:`load_leaf`).
    """
    from repro_torch import telemetry
    with telemetry.span("checkpoint.restore", step=step):
        return _restore(directory, step, target_tree, shardings, check,
                        strict)


def _restore(directory: str, step: int, target_tree: Any,
             shardings: Any, check: bool, strict: bool = True) -> Any:
    path = step_dir(directory, step)
    manifest = _load_manifest(path)
    flat = _flatten(target_tree)
    if strict and len(flat) != len(manifest["leaves"]):
        raise LeafMismatchError(None, len(flat),
                                len(manifest["leaves"]), what="count")
    # None marks "default placement" for a leaf: flatten must keep it.
    flat_sh = ([sh for _, sh in _leaves(shardings, keep_none=True)]
               if shardings is not None else [None] * len(flat))
    if len(flat_sh) != len(flat):
        raise LeafMismatchError(None, len(flat), len(flat_sh),
                                what="sharding count")
    out = []
    for (key, tgt), sh in zip(flat.items(), flat_sh):
        if key not in manifest["leaves"]:
            raise LeafMismatchError(key, "present in manifest", "missing",
                                    what="leaf")
        arr = _load(path, key, manifest["leaves"][key], check)
        if tuple(arr.shape) != tuple(tgt.shape):
            raise LeafMismatchError(key, tuple(tgt.shape), tuple(arr.shape))
        out.append(_place(arr, tgt, sh))
    return _unflatten(target_tree, iter(out))


class CheckpointManager:
    """Async checkpointing with retention.

    ``save`` snapshots to host immediately (so training can mutate buffers)
    and enqueues the disk write; a failed job restarts from
    ``latest_valid_step`` and replays from there (the counter RNG makes
    the replay bit-exact).
    """

    def __init__(self, directory: str, keep: int = 3,
                 overwrite: bool = True):
        self.directory = directory
        self.keep = keep
        self.overwrite = overwrite
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._errors: list = []
        self._lock = threading.Lock()
        self._closed = False

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree, meta = item
            try:
                save(self.directory, step, host_tree, meta=meta,
                     overwrite=self.overwrite)
                self._gc()
            except Exception as e:
                with self._lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = _steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(step_dir(self.directory, s), ignore_errors=True)

    def save_async(self, step: int, tree: Any, meta: Optional[dict] = None):
        host = _unflatten(tree, iter([np.array(_host(leaf), copy=True)
                                      for _, leaf in _leaves(tree)]))
        # The enqueue happens under the closed-flag lock: an accepted item
        # is always ahead of the shutdown sentinel (see ``close``), so it
        # is written, and a rejected one raises -- never silently dropped.
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "CheckpointManager is closed; save_async rejected "
                    f"(step {step})")
            self._q.put((step, host, meta))

    def wait(self):
        """Block until all enqueued saves land; raise the first worker
        error, *draining* the error list -- a failed save surfaces once,
        not on every subsequent wait."""
        self._q.join()
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            raise errs[0]

    def close(self):
        """Stop accepting work, then drain.  The closed flag flips before
        the drain, so a ``save_async`` racing ``close`` either lands in
        the queue ahead of the sentinel (and is written) or raises -- it
        is never silently dropped behind the sentinel."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)            # after close: nothing can enqueue
        self._q.join()
        self._worker.join(timeout=10)
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            raise errs[0]
