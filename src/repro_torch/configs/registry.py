"""Config registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from repro_torch.configs.archs import FULL, SMOKE
from repro_torch.configs.shapes import SHAPES, applicable_shapes  # noqa: F401

ASSIGNED = [
    "internlm2-20b", "gemma2-27b", "qwen2.5-14b", "stablelm-3b",
    "chameleon-34b", "seamless-m4t-medium", "llama4-scout-17b-a16e",
    "deepseek-v3-671b", "mamba2-2.7b", "zamba2-2.7b",
]


def list_archs(assigned_only: bool = False):
    return list(ASSIGNED) if assigned_only else sorted(FULL)


def get_config(arch: str):
    if arch not in FULL:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(FULL)}")
    return FULL[arch]


def get_smoke(arch: str):
    return SMOKE[arch]
