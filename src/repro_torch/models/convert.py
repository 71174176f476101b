"""Carry a reference parameter tree into the port.

The reference's ``init_params`` tree (``embed``, the ``layers/{ci}_{kind}``
stacks, ``prefix``, ``shared``, ``final_norm``, ``head`` when untied,
``mtp``), as numpy arrays, has the same leaf names and layouts as the
port's, so both packages compute the same function from it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models.config import ModelCfg


def _mismatch(want, got, path=""):
    """The first place where two shape trees differ, or None."""
    if isinstance(want, dict) or isinstance(got, dict):
        if not (isinstance(want, dict) and isinstance(got, dict)):
            return f"{path or '/'}: a subtree against a leaf"
        if set(want) != set(got):
            return (f"{path or '/'}: keys {sorted(got)}, the config's "
                    f"{sorted(want)}")
        for k in sorted(want):
            where = _mismatch(want[k], got[k], f"{path}/{k}")
            if where:
                return where
        return None
    if want != got:
        return f"{path}: shape {got}, the config's {want}"
    return None


def params_from_reference(np_tree, cfg: ModelCfg, *, device=None,
                          dtype=torch.float32):
    """The port's parameters from a reference tree of arrays: every leaf
    copied to ``device`` (None: the card) in ``dtype``.  Raises
    ``NotImplementedError`` for the families the port does not run, and
    ``ValueError`` when the tree's leaves (layer stacks, dense prefix,
    experts, shared blocks, head, MTP) are not the ones ``cfg`` makes."""
    lm.check_supported(cfg)
    want = lm.tree_map(lambda t: tuple(t.shape),
                       lm.init_params(cfg, device="meta"))
    where = _mismatch(want, lm.tree_map(lambda a: tuple(np.shape(a)),
                                        np_tree))
    if where:
        raise ValueError(f"{cfg.name}: the tree does not match the config "
                         f"at {where}")
    device = cm.device_or_card(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    return lm.tree_map(leaf, np_tree)
