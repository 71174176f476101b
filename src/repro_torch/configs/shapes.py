"""Assigned input shapes (seq_len x global_batch) and applicability rules."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only the SSM/hybrid archs run
# it; all other cells apply.
LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(cfg) -> list:
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
            continue
        out.append(s.name)
    return out
