"""Production mesh builders on ``torch.distributed``.

The meshes of the reference's cells (``repro/launch/mesh.py``), as
``DeviceMesh``es: the single-pod mesh is ``(data=16, model=16)`` = 256
GPUs, 32 H100 hosts of 8 cards; the multi-pod mesh ``(pod=2, data=16,
model=16)`` = 512 GPUs.  A mesh needs a process group of exactly its size:
one rank per GPU, or for a dry-run the ``fake`` group of
:func:`install_fake_group` (the counterpart of the reference's fake host
devices).  Functions, never module-level constants: building a mesh needs
the process group first.
"""
from __future__ import annotations

import math
import os

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

DEFAULT_DRYRUN_DEVICES = 512


def install_fake_group(world_size: int | None = None) -> int:
    """Initialise the ``fake`` process group of ``world_size`` ranks
    (default ``DRYRUN_DEVICES``, else 512), this process being rank 0:
    collectives run no communication and the dry-run traces every rank's
    program as rank 0's.  Returns the world size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = int(world_size or os.environ.get("DRYRUN_DEVICES",
                                         DEFAULT_DRYRUN_DEVICES))
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is already initialised, not {n}")
        return n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return n


def _mesh(shape, axes, device_type: str):
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        what = ("none is initialised" if have is None
                else f"this one has {have}")
        raise RuntimeError(
            f"the {shape} mesh over {axes} needs a process group of {need} "
            f"ranks, and {what} (for a dry-run: DRYRUN_DEVICES={need}; to "
            f"train: torchrun --nproc-per-node {need})")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 GPUs (32 hosts of 8 H100s;
    the 16-way model axis spans two hosts).  Multi-pod: (pod=2, data=16,
    model=16) = 512 GPUs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Scaled-down mesh for CI: (data=4, model=2), or (pod=2, data=2,
    model=2); 8 ranks (one 8-GPU host, or 8 gloo ranks on the CPU with
    ``device_type="cpu"``)."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def batch_axes(mesh) -> tuple:
    return (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))
