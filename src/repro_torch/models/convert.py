"""Carry a reference parameter tree into the port.

The reference's ``init_params`` tree (``embed``, ``layers/{ci}_{kind}``
stacks, ``final_norm``, ``head`` when untied), as numpy arrays, has the
same leaf names and layouts as the port's, so both packages compute the
same function from it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelCfg


def params_from_reference(np_tree, cfg: ModelCfg, *, device="cpu",
                          dtype=torch.float32):
    """The port's parameters from a reference tree of arrays: every leaf
    copied to ``device`` in ``dtype``.  Raises ``NotImplementedError`` for
    the families the port does not run, and ``ValueError`` when the
    tree's layer stacks or head do not match ``cfg``."""
    lm.check_supported(cfg)
    want = {f"{ci}_{k}" for ci, k in enumerate(cfg.cycle)}
    if set(np_tree["layers"]) != want:
        raise ValueError(f"layer stacks {sorted(np_tree['layers'])} do not "
                         f"match {cfg.name}'s cycle {sorted(want)}")
    if ("head" in np_tree) == cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} "
                         f"but the tree {'has' if 'head' in np_tree else 'lacks'}"
                         f" a head")

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    return lm.tree_map(leaf, np_tree)
