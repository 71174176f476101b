"""Deterministic synthetic token pipeline: the reference's
(``repro/data/pipeline.py``) numpy stream, copied, so both packages train
on the same batches bit for bit.

Counter-based (like the FHP RNG): batch ``i`` is a pure function of
``(seed, step, position)``, so any host can materialise exactly its shard
of the global batch (``host_slice``) with no coordination, and restarts
resume mid-stream bit-exactly (the step index is the state).  Token
streams are Zipf-ish (a hash mixed into a power-law rank) so the loss
curve behaves like natural text rather than uniform noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


def _mix(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    frames_dim: int = 0          # encdec: also emit (B, S, frames_dim)

    def batch_at(self, step: int, lo: int = 0, hi: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Rows [lo, hi) of the global batch for ``step`` (host numpy):
        ``tokens`` and ``labels`` (B, S) int32, and with ``frames_dim``
        ``frames`` (B, S, frames_dim) float32."""
        hi = self.global_batch if hi is None else hi
        rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        base = ((self.seed * 0x9E3779B97F4A7C15
                 + step * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF)
        ctr = (np.uint64(base) + rows * np.uint64(0x100000001B3) + cols)
        u = _mix(ctr).astype(np.float64) / float(2 ** 64)
        # Zipf via inverse CDF of a bounded power law over ranks.
        a = self.zipf_a
        v = float(self.vocab)
        ranks = np.floor(((v ** (1 - a) - 1.0) * u + 1.0) ** (1 / (1 - a)))
        toks = np.clip(ranks.astype(np.int64) - 1, 0, self.vocab - 1)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.frames_dim:
            fu = _mix(ctr[:, :-1] * np.uint64(31))[..., None]
            scale = (np.arange(self.frames_dim) + 1.0)
            frames = np.sin(fu.astype(np.float64) % 6283 / 1000.0 * scale)
            batch["frames"] = (frames * 0.1).astype(np.float32)
        return batch

    def host_slice(self, step: int, process_index: int, process_count: int):
        per = self.global_batch // process_count
        return self.batch_at(step, process_index * per,
                             (process_index + 1) * per)


def make_batch_specs(cfg, seq_len: int, global_batch: int):
    """``(shapes, logical axes)`` of one global batch, for dry-runs: meta
    tensors (no storage) with the reference's shapes and dtypes, and the
    reference's axes."""
    spec = lambda *shape, dtype=torch.int32: torch.empty(
        shape, dtype=dtype, device="meta")
    shapes = {"tokens": spec(global_batch, seq_len),
              "labels": spec(global_batch, seq_len)}
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if getattr(cfg, "frontend", "tokens") == "frames":
        shapes["frames"] = spec(global_batch, seq_len, cfg.d_model,
                                dtype=torch.float32)
        axes["frames"] = ("batch", None, None)
    return shapes, axes
