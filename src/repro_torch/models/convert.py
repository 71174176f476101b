"""Carry a reference parameter tree into the port.

The reference's ``init_params`` tree (``embed``, the ``layers/{ci}_{kind}``
stacks with their ``nx``/``xattn`` cross-attention, ``prefix``,
``shared``, ``enc_layers``, ``enc_norm``, ``final_norm``, ``head`` when
untied, ``mtp``), as numpy arrays, has the same leaf names and layouts as
the port's, so both packages compute the same function from it; and its
AdamW state ``{"m", "v", "step"}`` carries over the same way.
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
    ``ValueError`` when the tree's leaves (layer stacks, dense prefix,
    experts, shared blocks, encoder stack and cross-attention, head, MTP)
    are not the ones ``cfg`` makes."""
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


def opt_state_from_reference(np_state, params):
    """The port's AdamW state from the reference's ``{"m", "v", "step"}``
    (numpy arrays): the moments in their own dtype (float32, or bfloat16
    as ml_dtypes arrays), each on its parameter's device, and the step an
    int32 scalar there.  Raises ``ValueError`` when a moment's tree or
    shapes are not the parameters'."""
    from repro_torch.checkpoint.store import to_tensor
    shapes = lm.tree_map(lambda t: tuple(t.shape), params)
    for name in ("m", "v"):
        where = _mismatch(shapes, lm.tree_map(lambda a: tuple(np.shape(a)),
                                              np_state[name]))
        if where:
            raise ValueError(f"optimizer state {name!r} does not match the "
                             f"parameters at {where}")
    dev = next(lm.tree_leaves(params)).device

    def moments(tree):
        return lm.tree_map(lambda a: to_tensor(np.asarray(a), dev), tree)

    return {"m": moments(np_state["m"]), "v": moments(np_state["v"]),
            "step": torch.as_tensor(np.asarray(np_state["step"]),
                                    dtype=torch.int32).to(dev)}
