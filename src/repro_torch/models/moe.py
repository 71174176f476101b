"""Mixture-of-experts layer: top-k routing with capacity, gather dispatch,
scatter-add combine, optional shared (always-on) experts.

Dispatch is gather-based, as in the reference: router top-k assignments
become per-expert slot indices by a cumulative count, tokens are gathered
into a ``(G, E, C, D)`` buffer, the experts run as batched einsums over
stacked weights, and their outputs scatter-add back weighted by the gate.

``G`` is the dispatch group count (``_dispatch_groups``): 1 without
installed sharding rules, else one group per data shard, each with its
own capacity (GShard/Switch semantics), as in the reference.  On
DTensors the dispatch runs as a local function over each device's tokens
and experts (``local_map``): each data shard routes and dispatches its own
group to the experts of its model shard, and the combined output is a
pending sum over the model axis.  The Switch load-balance aux loss, which
is returned beside the output, stays the global mean over every token.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import common as cm
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.parallel import context


def init_moe(init: cm.Init, cfg):
    e, d = cfg.moe, cfg.d_model
    f = e.d_ff_expert
    p = {
        "router": init.normal((d, e.n_experts), ("embed", "experts"),
                              scale=0.006),
        "wg": init.normal((e.n_experts, d, f), ("experts", "embed", "d_ff")),
        "wu": init.normal((e.n_experts, d, f), ("experts", "embed", "d_ff")),
        "wd": init.normal((e.n_experts, f, d), ("experts", "d_ff", "embed")),
    }
    if e.n_shared:
        p["shared"] = init_mlp(init, d, f * e.n_shared)
    return p


def capacity(n_tokens: int, cfg) -> int:
    e = cfg.moe
    c = int(n_tokens * e.top_k / e.n_experts * e.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(p, xt, cfg):
    """Float32 router over ``xt`` (T, D): ``(probs (T, E), gate (T, k)
    renormalised, expert (T, k))``.  The top k come from a stable
    descending sort, so ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them."""
    logits = torch.einsum("td,de->te", xt.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    return (probs,) + top_k(probs, cfg.moe.top_k)


def top_k(probs, k: int):
    """``(gate (T, k) renormalised, expert (T, k))`` of router
    probabilities (T, E), ties to the lower expert index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, expert


def assign_slots(flat_e, n_experts: int, cg: int):
    """Token-major slot of each assignment in its expert's queue, and
    whether it fits under the capacity ``cg`` (later tokens overflow
    first, as in Switch).  flat_e: (G, T*k) -> (slot, keep), (G, T*k)."""
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)
    pos = torch.cumsum(onehot, dim=1) - 1                   # (G, T*k, E)
    slot = torch.take_along_dim(pos, flat_e[..., None], dim=2)[..., 0]
    return slot, slot < cg


def _dispatch_groups(t: int) -> int:
    """Dispatch group count == data-parallel shard count.

    The slot assignment (a cumulative count over the T*k assignments) is
    sequential along the tokens; one group per data shard, each with its
    own capacity, keeps it local to the shard.  Without installed rules
    this is 1, the flat policy."""
    r = context.current_rules()
    if r is None:
        return 1
    g = math.prod(r.axis_sizes[a] for a in ("pod", "data")
                  if a in r.axis_sizes)
    return g if g > 1 and t % g == 0 else 1


def _group_capacity(t: int, ng: int, cfg) -> int:
    return max(8, -(-capacity(t, cfg) // (8 * ng)) * 8)


def _dispatch(p, xt, gate, expert, cfg, ng: int, cg: int, e0: int = 0):
    """The experts' float32 output (T, D) of tokens ``xt`` (T, D) in
    ``ng`` groups of capacity ``cg``, for the experts ``[e0, e0 +
    E_local)`` whose weights ``p`` holds (every expert by default)."""
    e = cfg.moe
    t, d = xt.shape
    tg = t // ng
    dev = xt.device
    flat_e = expert.reshape(ng, tg * e.top_k)               # token-major
    slot, keep = assign_slots(flat_e, e.n_experts, cg)
    col = torch.where(keep, slot, cg)

    # Local token ids into the (G, E, Cg) index table; dropped slots all
    # land in column Cg, which is sliced off, and empty slots point at a
    # zero pad row (local index tg).
    tok_of = torch.arange(tg, device=dev).repeat_interleave(
        e.top_k)[None].expand(ng, -1)
    gi = torch.arange(ng, device=dev)[:, None].expand(-1, tg * e.top_k)
    idx = torch.full((ng, e.n_experts, cg + 1), tg, dtype=torch.int64,
                     device=dev)
    idx[gi, flat_e, col] = torch.where(keep, tok_of, tg)
    el = p["wg"].shape[0]
    idx = idx[:, e0:e0 + el, :cg]                           # (G, E, Cg)

    xg = xt.reshape(ng, tg, d)
    xpad = torch.cat([xg, torch.zeros((ng, 1, d), dtype=xt.dtype,
                                      device=dev)], dim=1)
    g_idx = torch.arange(ng, device=dev)[:, None, None]
    gathered = xpad[g_idx, idx]                             # (G, E, Cg, D)

    # The (G, E, Cg, ...) buffers are dropped as soon as they are used:
    # at full width each is gigabytes beside the parameters.
    g_ = torch.einsum("gecd,edf->gecf", gathered, p["wg"].to(xt.dtype))
    u = torch.einsum("gecd,edf->gecf", gathered, p["wu"].to(xt.dtype))
    del gathered
    y = torch.einsum("gecf,efd->gecd", cm.silu(g_) * u,
                     p["wd"].to(xt.dtype))
    del g_, u

    # Combine: scatter-add expert outputs back, weighted by the gate, in
    # float32 (a token's k contributions may add in another order than
    # the reference's: expect ulp-level differences).
    w_ec = torch.zeros((ng, e.n_experts, cg + 1), dtype=gate.dtype,
                       device=dev)
    w_ec[gi, flat_e, col] = torch.where(
        keep, gate.reshape(ng, tg * e.top_k), 0.0)
    w_ec = w_ec[:, e0:e0 + el, :cg]
    upd = (y * w_ec[..., None].to(y.dtype)).to(torch.float32)
    out = torch.zeros((ng, tg + 1, d), dtype=torch.float32, device=dev)
    out.index_put_((g_idx.expand_as(idx), idx), upd, accumulate=True)
    return out[:, :tg].reshape(t, d)


def moe_block(p, x, cfg):
    """x: (B, S, D) -> (out, aux_loss)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    ng = _dispatch_groups(t)
    if isinstance(x, DTensor) and context.current_rules() is not None:
        out, aux = _moe_sharded(p, x, cfg, ng)
    else:
        dev = x.device
        xt = x.reshape(t, d)
        probs, gate, expert = route(p, xt, cfg)
        # Switch aux loss: E * sum_e f_e * P_e (f = token fraction, P =
        # mass).
        f_e = torch.zeros((e.n_experts,), dtype=torch.float32, device=dev)
        f_e.index_add_(0, expert.reshape(-1), torch.full(
            (t * e.top_k,), 1.0 / (t * e.top_k), dtype=torch.float32,
            device=dev))
        p_e = probs.mean(dim=0)
        aux = e.n_experts * torch.sum(f_e * p_e) * e.aux_loss_weight
        out = _dispatch(p, xt, gate, expert, cfg, ng,
                        _group_capacity(t, ng, cfg)).to(x.dtype)
    if "shared" in p:
        out = out + mlp_block(p["shared"], x.reshape(1, t, d))[0]
    return out.reshape(b, s, d), aux


def _moe_sharded(p, x, cfg, ng: int):
    """``moe_block`` on DTensors.  The router's probabilities are DTensor
    ops over every token (and so is the aux loss's probability mass);
    then each device takes its data shard's tokens (one dispatch group
    when ``ng`` > 1, else every token) and runs them through the experts
    of its model shard, in a ``local_map``.  The float32 output is summed
    over the expert axis, then cast; the aux loss's token counts are
    summed over the data shards."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    rules = context.current_rules()
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    xt = x.reshape(t, d)
    probs = torch.softmax(torch.einsum(
        "td,de->te", xt.to(torch.float32), p["router"].to(torch.float32)),
        dim=-1)
    p_e = probs.mean(dim=0)
    data = [a for a in ("pod", "data") if a in names] if ng > 1 else []
    w_pl = rules.sharding(p["wg"].shape, ("experts", None, None))
    emesh = [a for a, pl in zip(names, w_pl) if isinstance(pl, Shard)]
    tok = tuple(Shard(0) if a in data else Replicate() for a in names)
    # A device's gradients: its tokens' (summed over the expert shards)
    # and its experts' (summed over the data shards).
    tok_grad = tuple(Shard(0) if a in data else Partial() if a in emesh
                     else Replicate() for a in names)
    w_grad = tuple(pl if isinstance(pl, Shard) else Partial() if a in data
                   else Replicate() for a, pl in zip(names, w_pl))
    out_pl = tuple(Shard(0) if a in data else
                   Partial() if a in emesh else Replicate() for a in names)
    sums = tuple(Partial() if a in data else Replicate() for a in names)
    el = e.n_experts // math.prod(mesh.size(names.index(a)) for a in emesh)
    cg = _group_capacity(t, ng, cfg)

    def local(xl, pl, wg, wu, wd):
        e0 = el * (mesh.get_local_rank(emesh[0]) if emesh else 0)
        gate, expert = top_k(pl, e.top_k)
        f_e = torch.zeros((e.n_experts,), dtype=torch.float32,
                          device=xl.device)
        f_e.index_add_(0, expert.reshape(-1), torch.full(
            (expert.numel(),), 1.0 / (t * e.top_k), dtype=torch.float32,
            device=xl.device))
        out = _dispatch({"wg": wg, "wu": wu, "wd": wd}, xl, gate, expert,
                        cfg, 1, cg, e0)
        return out, f_e

    out, f_e = local_map(
        local, out_placements=(out_pl, sums),
        in_placements=(tok, tok, w_pl, w_pl, w_pl),
        in_grad_placements=(tok_grad, tok_grad, w_grad, w_grad, w_grad),
        device_mesh=mesh, redistribute_inputs=True)(
        xt, probs, p["wg"], p["wu"], p["wd"])
    aux = e.n_experts * torch.sum(f_e * p_e) * e.aux_loss_weight
    return out.to(x.dtype), aux
