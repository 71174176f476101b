"""Sharding-rules engine: logical axes -> mesh axes with divisibility
fallback, resolved to DTensor placements on a ``DeviceMesh``.

The counterpart of ``repro/parallel/rules.py``.  Models annotate every
parameter/activation dim with a *logical* name ("heads", "d_ff", "vocab",
"batch", ...).  This module resolves names to mesh axes by priority,
subject to two constraints checked per array:

* divisibility -- a dim whose size does not divide the mesh axis extent is
  left replicated (e.g. qwen2.5's 40 q-heads on a 16-way model axis), and
* exclusivity -- a mesh axis is used at most once per array.

``Rules.spec`` gives the reference's partition spec as a plain tuple (one
entry per array dim: None, a mesh axis name, or a tuple of names);
``Rules.sharding`` gives the same placement as DTensor placements, one per
mesh dim: ``Shard(i)`` where array dim ``i`` uses that mesh dim, else
``Replicate()``.  A group such as ``("pod", "data")`` shards its dim over
both mesh dims, in mesh-dim order (the group's order).  Fallback events
are logged in ``fallbacks`` and surface in the roofline as extra
collective bytes.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` or any object
with its ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

log = logging.getLogger(__name__)

Axis = Optional[str]

# (logical name, candidate mesh-axis groups in preference order).
# Names earlier in the list claim mesh axes first within one array.
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Tuple[str, ...], ...]], ...] = (
    ("experts", (("model",),)),
    ("heads", (("model",),)),
    ("kv_heads", (("model",),)),
    ("d_ff", (("model",),)),
    ("vocab", (("model",),)),
    ("kv_seq", (("model",),)),          # decode-cache fallback: split-S
    ("batch", (("pod", "data"), ("data",))),
    ("embed", (("data",),)),            # FSDP (zero-3) weight shard
    ("lat_y", (("pod", "data"), ("data",))),   # FHP lattice rows
    ("lat_x", (("model",),)),                  # FHP lattice words
)


class Rules:
    def __init__(self, mesh, rules: Sequence = DEFAULT_RULES,
                 fsdp: bool = True, seq_parallel: bool = False):
        self.mesh = mesh
        self.rules: Dict[str, Tuple[Tuple[str, ...], ...]] = dict(rules)
        if not fsdp:
            self.rules["embed"] = ()
        if seq_parallel:
            # sequence parallelism: the model axis carries the sequence of
            # activations; block weights replicate on it (vocab/experts
            # keep TP -- embedding tables are the memory hogs).
            for name in ("heads", "kv_heads", "d_ff"):
                self.rules[name] = ()
            self.rules["seq"] = (("model",),)
        self.axis_sizes = dict(zip(mesh.mesh_dim_names,
                                   (int(n) for n in mesh.shape)))
        self.fallbacks: List[Tuple] = []
        self._priority = ["seq"] + [name for name, _ in rules]

    def _group_size(self, group: Tuple[str, ...]) -> int:
        return math.prod(self.axis_sizes[a] for a in group)

    def spec(self, shape: Sequence[int], axes: Sequence[Axis]) -> tuple:
        """Resolve one array's logical axes to a partition spec: a tuple
        with one entry per dim (None, a mesh axis, or a tuple of axes)."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and logical axes "
                             f"{tuple(axes)} differ in rank")
        out: List = [None] * len(axes)
        used: set = set()
        order = sorted(
            range(len(axes)),
            key=lambda i: (self._priority.index(axes[i])
                           if axes[i] in self._priority else 10 ** 6))
        for i in order:
            name = axes[i]
            if name is None or name not in self.rules:
                continue
            placed = False
            for group in self.rules[name]:
                if any(a not in self.axis_sizes for a in group):
                    continue
                if any(a in used for a in group):
                    continue
                if shape[i] % self._group_size(group) != 0:
                    continue
                out[i] = group if len(group) > 1 else group[0]
                used.update(group)
                placed = True
                break
            if not placed and self.rules[name]:
                self.fallbacks.append((tuple(shape), tuple(axes), name))
        return tuple(out)

    def sharding(self, shape, axes) -> tuple:
        """The DTensor placements of ``spec(shape, axes)`` on the mesh."""
        return placements(self.mesh, self.spec(shape, axes))


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements, one per mesh dim, of a partition spec."""
    dim_of: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def spec_for(mesh, shape, axes, rules=DEFAULT_RULES) -> tuple:
    return Rules(mesh, rules).spec(shape, axes)


def sharding_for(mesh, shape, axes, rules=DEFAULT_RULES) -> tuple:
    return placements(mesh, spec_for(mesh, shape, axes, rules))


def tree_pairs(shapes_tree, axes_tree):
    """``(leaf, logical axes)`` of every leaf of ``shapes_tree`` (nested
    dicts and tuples of tensors, in sorted-key order), walking
    ``axes_tree`` up to the same structure: its leaves are tuples of
    names, which stay whole."""
    if isinstance(shapes_tree, dict):
        for k in sorted(shapes_tree):
            yield from tree_pairs(shapes_tree[k], axes_tree[k])
    elif isinstance(shapes_tree, tuple):
        for s, a in zip(shapes_tree, axes_tree, strict=True):
            yield from tree_pairs(s, a)
    else:
        yield shapes_tree, axes_tree


def _tree_build(shapes_tree, values):
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        return next(it)

    return build(shapes_tree)


def tree_specs(mesh, shapes_tree, axes_tree, rules=DEFAULT_RULES):
    """Map a (shapes, logical-axes) tree pair to partition specs (a tree
    shaped like ``shapes_tree``)."""
    r = Rules(mesh, rules)
    return _tree_build(shapes_tree, [r.spec(s.shape, a) for s, a in
                                     tree_pairs(shapes_tree, axes_tree)])


def tree_shardings(mesh, shapes_tree, axes_tree, rules=DEFAULT_RULES):
    """Map a (shapes, logical-axes) tree pair to DTensor placements."""
    r = Rules(mesh, rules)
    return _tree_build(shapes_tree, [r.sharding(s.shape, a) for s, a in
                                     tree_pairs(shapes_tree, axes_tree)])
