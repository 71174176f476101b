"""Roofline accounting from a traced step (no card needed): the
counterpart of the reference's XLA-HLO parsers (``collective_bytes``,
``hbm_bytes_estimate``, ``analyze_compiled`` in
``repro/roofline/analysis.py``).

Where the reference reads the post-partitioning HLO text of a compiled
program, the port records the per-device op stream of one eager step:
:class:`TraceRecorder` is a ``TorchDispatchMode`` that lets every op on
DTensors pass through DTensor (``NotImplemented``) and records what
DTensor then runs on the local shards -- the aten ops each device runs
and the functional collectives (``_c10d_functional.*``) it issues -- so
every shape it sees is a device's local one.  A replicated op counts in
full on every device.  Ops on FakeTensors (DTensor's own shape
propagation) are not part of the step and are skipped.  Kernels that no
dispatch mode can see (the FHP kernel, launched through ``ctypes``) and
the FHP ring copies report themselves through :func:`note_kernel` and
:func:`note_collective`.

Three totals per device, priced by ``analysis.roofline_terms`` on the
card's rates:

    compute    = FLOPs (``torch.utils.flop_counter``'s matmul and
                 convolution formulas on local shapes)
    memory     = ``hbm_bytes_estimate(trace, "fused")``
    collective = ``collective_bytes(trace)["_total"]["operand_bytes"]``

Like XLA's cost analysis before it, the FLOP count covers matmuls and
convolutions; unlike it, elementwise FLOPs are not counted.
"""
from __future__ import annotations

import contextvars
import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import H100, HW, roofline_terms

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")

# Functional collective -> (kind, index of its group argument).
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", 2),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 2),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 3),
    "_c10d_functional.all_to_all_single": ("all-to-all", 3),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 3),
    "_c10d_functional_autograd.all_gather_into_tensor": ("all-gather", 2),
    "_c10d_functional_autograd.reduce_scatter_tensor": (
        "reduce-scatter", 3),
    "_c10d_functional_autograd.all_to_all_single": ("all-to-all", 3),
}

# Ops whose outputs must be materialised in device memory whatever the
# fusion: the counterpart of the reference's ``_MAJOR_OPS``.
MAJOR_OPS = frozenset((
    "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
    "aten.convolution", "aten.convolution_backward",
    "aten.embedding", "aten.embedding_dense_backward",
    "aten.gather", "aten.scatter", "aten.scatter_add", "aten.scatter_add_",
    "aten.scatter_", "aten.index", "aten.index_put", "aten.index_put_",
    "aten._index_put_impl_", "aten.index_select", "aten.index_add",
    "aten.index_add_", "aten.take_along_dim",
    "aten.cat", "aten.sort", "aten.topk",
    "aten.clone", "aten.copy_", "aten.copy",
))
# Ops that move no data: allocation and index generation.
_FREE_OPS = frozenset(("aten.empty", "aten.empty_strided", "aten.empty_like",
                       "aten.arange", "aten.detach", "aten.lift_fresh",
                       "_c10d_functional.wait_tensor",
                       "_c10d_functional._wrap_tensor_autograd"))

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_trace", default=None)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _group_size(group) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group).size()


@dataclasses.dataclass
class OpRecord:
    """One op of a device's stream: its name, bytes read and written
    (every tensor argument and result), FLOPs, whether it is major (its
    result materialises), and for a collective its kind and group size."""
    name: str
    in_bytes: int
    out_bytes: int
    flops: int = 0
    major: bool = False
    collective: Optional[str] = None
    group: int = 0


class TraceRecorder(TorchDispatchMode):
    """Record the local op stream of the code run under it (see the module
    docstring).  ``ops`` is the stream; ``peak_live_bytes`` the high-water
    mark of bytes held by op results that are not views (results still
    referenced when the recorder exits count as live until then)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._tok = None

    def __enter__(self):
        self._tok = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tok)
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor):
        n = _nbytes(t)
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

        def free(rec=weakref.ref(self), n=n):
            r = rec()
            if r is not None:
                r.live_bytes -= n

        weakref.finalize(t, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor run the local ops
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                     # DTensor's shape propagation
        name = str(func.overloadpacket)
        if name in _FREE_OPS or getattr(func, "is_view", False):
            return out
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        coll = _COLLECTIVES.get(name)
        rec = OpRecord(name, sum(map(_nbytes, ins)), sum(map(_nbytes, outs)),
                       flops, name in MAJOR_OPS or coll is not None)
        if coll is not None:
            rec.collective = coll[0]
            rec.group = _group_size(args[coll[1]])
        self.ops.append(rec)
        if not func._schema.returns or all(
                r.alias_info is None for r in func._schema.returns):
            for t in outs:
                self._track(t)
        return out

    # -- what no dispatch mode sees -----------------------------------------
    def note(self, rec: OpRecord):
        self.ops.append(rec)


def active() -> Optional[TraceRecorder]:
    """The recorder of the enclosing ``with TraceRecorder()``, if any."""
    return _ACTIVE.get()


def note_kernel(name: str, in_bytes: int, out_bytes: int, flops: int = 0):
    """Report a kernel launch that dispatch cannot see (a ``ctypes``
    launch) to the active recorder as one major op."""
    r = active()
    if r is not None:
        r.note(OpRecord(name, int(in_bytes), int(out_bytes), int(flops),
                        True))


def note_collective(kind: str, nbytes: int, group: int = 2):
    """Report a collective that dispatch cannot see (a ring copy between
    slots of an in-process mesh: ``collective-permute``, group 2) to the
    active recorder."""
    if kind not in COLL_OPS:
        raise ValueError(f"unknown collective kind {kind!r}")
    r = active()
    if r is not None:
        r.note(OpRecord(kind, int(nbytes), int(nbytes), 0, True, kind,
                        int(group)))


# ---------------------------------------------------------------------------
# The counterparts of the HLO parsers
# ---------------------------------------------------------------------------

def collective_bytes(trace: TraceRecorder) -> Dict[str, Dict[str, float]]:
    """Operand and wire bytes per collective kind of a traced step:
    ``{kind: {count, operand_bytes, wire_bytes}}`` plus ``"_total"``, with
    the reference's ring factors (``n`` = the group size: the mesh dim's
    extent; a permute is pairwise).  Operand bytes are each collective's
    input: the full buffer for an all-reduce, all-to-all or permute, the
    local shard for an all-gather, the unreduced buffer for a
    reduce-scatter."""
    out: Dict[str, Dict[str, float]] = {
        op: {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0}
        for op in COLL_OPS}
    for r in trace.ops:
        if r.collective is None:
            continue
        n = max(r.group, 1)
        operand = float(r.in_bytes)
        wire = {"all-reduce": 2 * (n - 1) / n * operand,
                "all-gather": (n - 1) / n * r.out_bytes,
                "reduce-scatter": (n - 1) / n * operand,
                "all-to-all": (n - 1) / n * operand,
                "collective-permute": operand}[r.collective]
        out[r.collective]["count"] += 1
        out[r.collective]["operand_bytes"] += operand
        out[r.collective]["wire_bytes"] += wire
    out["_total"] = {
        "count": sum(v["count"] for v in out.values()),
        "operand_bytes": sum(v["operand_bytes"] for v in out.values()),
        "wire_bytes": sum(v["wire_bytes"] for v in out.values()),
    }
    return out


def hbm_bytes_estimate(trace: TraceRecorder, mode: str = "fused", *,
                       boundary_bytes: float = 0.0) -> float:
    """Device-memory traffic estimate (bytes) of a traced step.

    mode="all": every recorded op's input + output bytes -- every
    intermediate written and read back (an UPPER bound: a fused kernel
    keeps elementwise chains in registers).

    mode="fused": models perfect elementwise fusion -- 2x (write + read)
    the bytes of buffers that *must* materialise: the step's inputs and
    outputs (``boundary_bytes``, their local bytes summed) and the results
    of major ops (matmuls, convolutions, embedding, gather / scatter /
    index ops, cat, sort, data-moving copies, collectives and reported
    kernels).  A LOWER bound."""
    if mode == "all":
        return float(sum(r.in_bytes + r.out_bytes for r in trace.ops))
    if mode != "fused":
        raise ValueError(f"mode must be 'fused' or 'all', not {mode!r}")
    return 2.0 * (boundary_bytes
                  + sum(r.out_bytes for r in trace.ops if r.major))


def local_bytes(tree) -> int:
    """Bytes of a tree's leaves on one device: a DTensor's local shard, a
    tensor whole."""
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t._local_tensor if isinstance(t, DTensor) else t)
    return total


def trace_costs(trace: TraceRecorder, boundary_bytes: float) -> Dict:
    """The five per-device totals of a traced step, under the keys the
    depth-knob extrapolation reads."""
    cb = collective_bytes(trace)
    return {"flops": float(sum(r.flops for r in trace.ops)),
            "bytes": hbm_bytes_estimate(trace, "fused",
                                        boundary_bytes=boundary_bytes),
            "bytes_xla": hbm_bytes_estimate(trace, "all"),
            "coll_op": cb["_total"]["operand_bytes"],
            "coll_wire": cb["_total"]["wire_bytes"]}


def analyze_trace(trace: TraceRecorder, *, inputs=(), outputs=(),
                  model_flops: Optional[float] = None, chips: int = 1,
                  hw: HW = H100) -> Dict:
    """Full per-device roofline record of one traced step, under the
    reference's record keys (``analyze_compiled``'s).

    ``inputs``/``outputs`` are the step's arguments and results (trees of
    DTensors or tensors): their local bytes are the fused estimate's
    boundary buffers and ``memory_analysis["argument_size_in_bytes"]``
    and ``["output_size_in_bytes"]``; ``["temp_size_in_bytes"]`` is the
    recorder's high-water mark of live op results.  The key
    ``bytes_xla_prefusion_per_device`` is kept for the readers of the
    record; it holds the every-op count (``hbm_bytes_estimate(mode=
    "all")``).  ``model_flops`` is the *global* useful-model FLOPs per
    step (6*N*D etc.); the record reports MODEL_FLOPS / (FLOPs * chips)
    and the roofline fraction on ``hw``."""
    arg_b, out_b = local_bytes(inputs), local_bytes(outputs)
    costs = trace_costs(trace, arg_b + out_b)
    colls = collective_bytes(trace)
    terms = roofline_terms(costs["flops"], costs["bytes"], costs["coll_op"],
                           hw)
    rec = {
        "flops_per_device": costs["flops"],
        "bytes_per_device": costs["bytes"],
        "bytes_xla_prefusion_per_device": costs["bytes_xla"],
        "collective_bytes_per_device": costs["coll_op"],
        "collective_wire_bytes_per_device": colls["_total"]["wire_bytes"],
        "collectives": {k: v for k, v in colls.items() if k != "_total"
                        and v["count"]},
        "terms": terms,
        "memory_analysis": {"argument_size_in_bytes": arg_b,
                            "output_size_in_bytes": out_b,
                            "temp_size_in_bytes": trace.peak_live_bytes},
    }
    if model_flops is not None:
        add_model_flops(rec, model_flops, chips, hw)
    return rec


def add_model_flops(rec: Dict, model_flops: float, chips: int,
                    hw: HW = H100) -> Dict:
    """Set ``model_flops_global``, ``model_flops_ratio`` and
    ``roofline_fraction`` of a record from its per-device FLOPs and
    terms."""
    traced_global = rec["flops_per_device"] * chips
    t = rec["terms"]["step_s_lower_bound"]
    rec["model_flops_global"] = model_flops
    rec["model_flops_ratio"] = (model_flops / traced_global
                                if traced_global else 0.0)
    rec["roofline_fraction"] = ((model_flops / chips / hw.peak_flops) / t
                                if t > 0 else 0.0)
    return rec
