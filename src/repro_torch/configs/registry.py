"""Config registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from repro_torch.configs.archs import FULL, PUBLISHED, PUBLISHED_SMOKE, SMOKE
from repro_torch.configs.shapes import SHAPES, applicable_shapes  # noqa: F401

ASSIGNED = [
    "internlm2-20b", "gemma2-27b", "qwen2.5-14b", "stablelm-3b",
    "chameleon-34b", "seamless-m4t-medium", "llama4-scout-17b-a16e",
    "deepseek-v3-671b", "mamba2-2.7b", "zamba2-2.7b",
]


def list_archs(assigned_only: bool = False):
    return list(ASSIGNED) if assigned_only else sorted(FULL)


def get_config(arch: str):
    """The registered configuration ``arch``: a twin of the JAX package's,
    or a published model (``archs.PUBLISHED``)."""
    if arch in PUBLISHED:
        return PUBLISHED[arch]
    if arch not in FULL:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(FULL) + sorted(PUBLISHED)}")
    return FULL[arch]


def get_smoke(arch: str):
    return PUBLISHED_SMOKE[arch] if arch in PUBLISHED_SMOKE else SMOKE[arch]
