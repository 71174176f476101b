"""Ambient sharding-rules context.

The counterpart of ``repro/parallel/context.py``.  Model code is
mesh-agnostic (it annotates logical axes only), but a few places pin a
placement explicitly -- the logits, the embedded rows, the row-parallel
outputs, the activations under sequence parallelism -- as the reference
pins them with ``with_sharding_constraint``.  The launcher installs the
active ``Rules`` here; model code asks for a placement by logical names
and gets a no-op when no rules are installed or the tensor is not a
DTensor (one device).  ``distribute`` places a tree by its logical axes,
and ``sharded_einsum`` runs a matmul with the placements the rules give
its operands.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.parallel.rules import _tree_build, tree_pairs

# The installed rules, innermost last.  A process-wide stack, not a
# context variable: on a card the autograd engine runs the backward pass
# -- and with it remat's recomputed forward -- on a thread of its own,
# which must see the rules the forward ran under.
_STACK: list = []


@contextlib.contextmanager
def use_rules(rules):
    _STACK.append(rules)
    try:
        yield
    finally:
        _STACK.pop()


def current_rules():
    return _STACK[-1] if _STACK else None


def constrain(x, logical_axes):
    """Redistribute a DTensor to the placement its logical axes resolve
    to (``DTensor.redistribute``, the counterpart of
    ``with_sharding_constraint``); ``x`` unchanged without installed rules
    or when it is not a DTensor."""
    r = current_rules()
    if r is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, r.sharding(x.shape, logical_axes))


def distribute(tree, axes_tree, rules=None):
    """A tree of tensors (nested dicts and tuples) as DTensors placed on
    the mesh of ``rules`` (default: the installed rules) by their logical
    axes.  Each rank keeps its own shard of the tensor it holds (no
    communication: every rank holds the same tree, or shapes only)."""
    r = rules if rules is not None else current_rules()
    if r is None:
        raise RuntimeError("distribute needs rules (use_rules or rules=)")
    return _tree_build(tree, [
        distribute_tensor(t, r.mesh, r.sharding(t.shape, a),
                          src_data_rank=None)
        for t, a in tree_pairs(tree, axes_tree)])


def sharded_einsum(eq: str, a, b, a_axes, b_axes):
    """``torch.einsum(eq, a, b)`` of two DTensors as one local einsum on
    each device (``local_map``), its operands placed by the installed
    rules from their logical axes, and every placement -- the result's and
    both gradients' -- fixed by the equation: a mesh dim that shards a
    letter of the result shards the result there; one that shards only
    contracted letters leaves the result pending a sum (``Partial``).  A
    mesh dim that would shard different letters of the two operands keeps
    ``a``'s and replicates ``b`` (an FSDP weight is gathered).

    DTensor's own einsum flattens letter groups, and may shard a
    flattened group over an axis that its leading letter does not divide,
    after which it cannot split the group again."""
    r = current_rules()
    lhs, out = eq.split("->")
    la, lb = lhs.split(",")
    mesh = a.device_mesh
    pa = list(r.sharding(a.shape, a_axes))
    pb = list(r.sharding(b.shape, b_axes))
    letter = lambda pl, ls: ls[pl.dim] if isinstance(pl, Shard) else None
    for j in range(mesh.ndim):
        ca, cb = letter(pa[j], la), letter(pb[j], lb)
        if cb is not None and ca is not None and ca != cb:
            pb[j] = Replicate()
        elif cb is not None and ca is None and cb in la:
            pa[j] = Shard(la.index(cb))

    def result(j):
        c = letter(pa[j], la) or letter(pb[j], lb)
        if c is None:
            return Replicate()
        return Shard(out.index(c)) if c in out else Partial()

    def grad(p_self, l_self, p_other, l_other, j):
        if isinstance(p_self[j], Shard):
            return p_self[j]
        c = letter(p_other[j], l_other)
        return Partial() if c is not None and c not in l_self else \
            Replicate()

    n = range(mesh.ndim)
    return local_map(
        lambda x, y: torch.einsum(eq, x, y),
        out_placements=(tuple(result(j) for j in n),),
        in_placements=(tuple(pa), tuple(pb)),
        in_grad_placements=(tuple(grad(pa, la, pb, lb, j) for j in n),
                            tuple(grad(pb, lb, pa, la, j) for j in n)),
        device_mesh=mesh, redistribute_inputs=True)(a, b)
