"""Carry packed state between the reference's numpy uint32 words and the
port's ``torch.int32`` bit-view tensors (the same 32 bits per word).

Moments are int32 in both packages and pass through unchanged.
"""
from __future__ import annotations

import numpy as np
import torch


def planes_from_reference(words: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 numpy words (any shape) -> int32 tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    if not a.flags.writeable:          # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def planes_to_reference(planes: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> uint32 numpy words on the host."""
    if planes.dtype != torch.int32:
        raise TypeError(f"expected int32 bit-view words, got {planes.dtype}")
    return planes.detach().cpu().contiguous().numpy().view(np.uint32)


def moments_to_reference(moments: torch.Tensor) -> np.ndarray:
    """int32 moments tensor -> int32 numpy array on the host."""
    if moments.dtype != torch.int32:
        raise TypeError(f"expected int32 moments, got {moments.dtype}")
    return moments.detach().cpu().numpy()
