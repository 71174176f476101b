"""Mixture-of-experts layer: top-k routing with capacity, gather dispatch,
scatter-add combine, optional shared (always-on) experts.

Dispatch is gather-based, as in the reference: router top-k assignments
become per-expert slot indices by a cumulative count, tokens are gathered
into a ``(G, E, C, D)`` buffer, the experts run as batched einsums over
stacked weights, and their outputs scatter-add back weighted by the gate.
The port runs one dispatch group (``G = 1``, the reference's value with
no sharding rules installed); per-data-shard groups come with the
sharding rules (ROADMAP §1, item 11f).

The Switch load-balance aux loss is returned beside the output.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.models.mlp import init_mlp, mlp_block


def init_moe(init: cm.Init, cfg):
    e, d = cfg.moe, cfg.d_model
    f = e.d_ff_expert
    p = {
        "router": init.normal((d, e.n_experts), scale=0.006),
        "wg": init.normal((e.n_experts, d, f)),
        "wu": init.normal((e.n_experts, d, f)),
        "wd": init.normal((e.n_experts, f, d)),
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
    k = cfg.moe.top_k
    logits = torch.einsum("td,de->te", xt.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


def assign_slots(flat_e, n_experts: int, cg: int):
    """Token-major slot of each assignment in its expert's queue, and
    whether it fits under the capacity ``cg`` (later tokens overflow
    first, as in Switch).  flat_e: (G, T*k) -> (slot, keep), (G, T*k)."""
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)
    pos = torch.cumsum(onehot, dim=1) - 1                   # (G, T*k, E)
    slot = torch.take_along_dim(pos, flat_e[..., None], dim=2)[..., 0]
    return slot, slot < cg


def moe_block(p, x, cfg):
    """x: (B, S, D) -> (out, aux_loss)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)

    probs, gate, expert = route(p, xt, cfg)

    # Switch aux loss: E * sum_e f_e * P_e (f = token fraction, P = mass).
    f_e = torch.zeros((e.n_experts,), dtype=torch.float32, device=dev)
    f_e.index_add_(0, expert.reshape(-1), torch.full(
        (t * e.top_k,), 1.0 / (t * e.top_k), dtype=torch.float32,
        device=dev))
    p_e = probs.mean(dim=0)
    aux = e.n_experts * torch.sum(f_e * p_e) * e.aux_loss_weight

    # One dispatch group (see the module docstring).
    ng, tg = 1, t
    cg = max(8, -(-capacity(t, cfg) // (8 * ng)) * 8)       # per-group cap
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
    idx = idx[..., :cg]                                     # (G, E, Cg)

    xg = xt.reshape(ng, tg, d)
    xpad = torch.cat([xg, torch.zeros((ng, 1, d), dtype=xt.dtype,
                                      device=dev)], dim=1)
    g_idx = torch.arange(ng, device=dev)[:, None, None]
    gathered = xpad[g_idx, idx]                             # (G, E, Cg, D)

    # The (G, E, Cg, ...) buffers are dropped as soon as they are used:
    # at full width each is gigabytes beside the parameters.
    g_ = torch.einsum("gecd,edf->gecf", gathered, p["wg"].to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", gathered, p["wu"].to(x.dtype))
    del gathered
    y = torch.einsum("gecf,efd->gecd", cm.silu(g_) * u,
                     p["wd"].to(x.dtype))
    del g_, u

    # Combine: scatter-add expert outputs back, weighted by the gate, in
    # float32 (a token's k contributions may add in another order than
    # the reference's: expect ulp-level differences).
    w_ec = torch.zeros((ng, e.n_experts, cg + 1), dtype=gate.dtype,
                       device=dev)
    w_ec[gi, flat_e, col] = torch.where(
        keep, gate.reshape(ng, tg * e.top_k), 0.0)
    upd = (y * w_ec[..., :cg, None].to(y.dtype)).to(torch.float32)
    out = torch.zeros((ng, tg + 1, d), dtype=torch.float32, device=dev)
    out.index_put_((g_idx.expand_as(idx), idx), upd, accumulate=True)
    out = out[:, :tg].reshape(t, d).to(x.dtype)

    if "shared" in p:
        out = out + mlp_block(p["shared"], xt[None])[0]
    return out.reshape(b, s, d), aux
