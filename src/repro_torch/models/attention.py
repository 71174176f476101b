"""Attention blocks: GQA with bias / qk-norm / softcap / sliding window /
padded heads / cross-attention, as plain PyTorch.

Training / prefill attention is *chunked* (online softmax over KV blocks):
peak memory is O(S * block) instead of O(S^2).  Decode takes the simple
full-cache path (the score tensor has a single query position) and writes
each row's new K/V into the cache in place.  Scores are computed in fp32
from the compute-dtype operands, as the reference's
``preferred_element_type=float32`` does; no fused attention call is used,
since the softcap and the per-row decode masks must stay the reference's.

MLA (DeepSeek's latent attention) trains and prefills in the expanded
form (the latent lifted to per-head K/V, q/k head dim ``nope + rope`` and
v dim ``v_dim``, through ``chunked_attention``) and decodes in the
absorbed form against a cache of the latent ``c`` and the rotated ``kr``.
With YaRN (``YarnMLACfg``, the published DeepSeek-V3) the rotary dims turn
by YaRN's frequencies and the softmax scale takes its mscale squared.
Telemetry: each ``mla_decode`` call is one ``mla.decode`` span.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import telemetry
from repro_torch.models import common as cm
from repro_torch.models.config import YarnMLACfg
from repro_torch.parallel import context

NEG = -1e30
PAD_POSITION = 2 ** 30      # position of padded KV slots (always masked)


def n_heads_eff(cfg) -> int:
    """Effective (possibly padded) q-head count."""
    return max(cfg.pad_heads, cfg.n_heads) if cfg.pad_heads else cfg.n_heads


def _head_mask(cfg, dtype, device=None):
    """(H_eff,) mask that zeroes padded dummy heads.

    Dummy heads are distributed per KV group (the (B,S,KV,G,hd) reshape
    assigns head h to group h // (H_eff/KV), so tail-padding would
    reshuffle real heads across groups)."""
    he = n_heads_eff(cfg)
    if he == cfg.n_heads:
        return None
    kv = cfg.n_kv_heads
    if he % kv or cfg.n_heads % kv:
        raise ValueError(f"pad_heads {he} and n_heads {cfg.n_heads} must "
                         f"be multiples of n_kv_heads {kv}")
    g_pad, g_real = he // kv, cfg.n_heads // kv
    return ((torch.arange(he, device=device) % g_pad) < g_real).to(dtype)


def init_attn(init: cm.Init, cfg, cross: bool = False):
    """Attention projections; a cross-attention sub-block (``cross``, the
    encoder-decoder's) draws no q/k/v biases."""
    d, kv, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    h = n_heads_eff(cfg)
    p = {
        "wq": init.normal((d, h, hd), ("embed", "heads", None)),
        "wk": init.normal((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": init.normal((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": init.normal((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = init.zeros((h, hd), ("heads", None))
        p["bk"] = init.zeros((kv, hd), ("kv_heads", None))
        p["bv"] = init.zeros((kv, hd), ("kv_heads", None))
    if cfg.qk_norm:
        p["qn"] = init.zeros((hd,), (None,))
        p["kn"] = init.zeros((hd,), (None,))
    return p


def heads_proj(x, w, name: str):
    """``einsum("bsd,dhk->bshk", x, w)`` in ``x``'s dtype; sharded, the
    heads on the placement the rules give the logical ``name``."""
    return cm.einsum("bsd,dhk->bshk", x, w.to(x.dtype),
                     ("batch", "seq", None), (None, name, None))


def heads_out(o, w):
    """``einsum("bshk,hkd->bsd", o, w)`` in ``o``'s dtype (the output
    projection); sharded, summed over the heads' axis here, in ``o``'s
    dtype, onto the batch (and sequence) placement."""
    y = cm.einsum("bshk,hkd->bsd", o, w.to(o.dtype),
                  ("batch", "seq", "heads", None), ("heads", None, None))
    return context.constrain(y, ("batch", "seq", None))


def group_heads(q, kvh: int):
    """(B, S, H, hd) queries as (B, S, KV, G, hd), head h in group h //
    G.  On DTensors under installed rules the heads first take the
    placement the rules give the ``kv_heads`` (a mesh axis that divides H
    but not KV could not be split over the two dims)."""
    b, s, h, hd = q.shape
    rules = context.current_rules()
    if rules is not None and isinstance(q, DTensor):
        q = q.redistribute(q.device_mesh, rules.sharding(
            (b, s, kvh, hd), ("batch", "seq", "kv_heads", None)))
    return q.reshape(b, s, kvh, h // kvh, hd)


def _qkv(p, x, cfg, positions=None, kv_x=None, rope: bool = True):
    """Project to q (B,S,H,hd) and k/v (B,T,KV,hd) -- k/v from ``kv_x``
    (cross-attention: the encoder's output) when given, else from ``x``
    -- with bias/qk-norm, and rope when ``rope`` and ``positions``."""
    kv_x = x if kv_x is None else kv_x
    q = heads_proj(x, p["wq"], "heads")
    k = heads_proj(kv_x, p["wk"], "kv_heads")
    v = heads_proj(kv_x, p["wv"], "kv_heads")
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if "qn" in p:
        q = cm.rms_norm(q, p["qn"], cfg.norm_eps)
        k = cm.rms_norm(k, p["kn"], cfg.norm_eps)
    if rope and positions is not None:
        q = cm.apply_rope(q, positions, cfg.rope_frac, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_frac, cfg.rope_theta)
    return q, k, v


def _scores(qg, k):
    """(B,S,KV,G,T) fp32 scores of grouped queries against keys, both in
    the compute dtype (the products are exact in fp32)."""
    return torch.einsum("bskgh,btkh->bskgt", qg.to(torch.float32),
                        k.to(torch.float32))


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      cap: float = 0.0, bk: int = 1024,
                      kv_positions=None, q_positions=None, scale=None):
    """Attention as an online softmax over KV chunks.

    q: (B, S, H, hd);  k, v: (B, T, KV, hd) with H % KV == 0; the scores
    scaled by ``scale`` (None: hd ** -0.5).
    Returns (B, S, H, hd) in q.dtype.
    """
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    g = h // kvh
    bk = min(bk, t)
    t_real = t
    pad = (-t) % bk
    dev = q.device
    if pad:  # pad KV to a block multiple; padded slots are masked out below
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        t = t + pad
    nc = t // bk
    qg = group_heads(q, kvh)
    scale = hd ** -0.5 if scale is None else scale
    if q_positions is None:
        q_positions = torch.arange(s, device=dev)
    qpos = q_positions.to(torch.int32)
    if kv_positions is None:
        kv_positions = torch.arange(t, device=dev)
    elif pad:
        kv_positions = torch.cat([kv_positions.to(dev), torch.full(
            (pad,), PAD_POSITION, dtype=kv_positions.dtype, device=dev)])
    kpos_all = kv_positions.to(torch.int32).reshape(nc, bk)
    kvalid_all = (torch.arange(t, device=dev) < t_real).reshape(nc, bk)

    m = torch.full((b, s, kvh, g), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, kvh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, kvh, g, hdv), dtype=torch.float32, device=dev)
    for c in range(nc):
        kc, vc = k[:, c * bk:(c + 1) * bk], v[:, c * bk:(c + 1) * bk]
        kp, kva = kpos_all[c], kvalid_all[c]
        sc = _scores(qg, kc) * scale
        if cap:
            sc = cm.softcap(sc, cap)
        mask = kva[None, :].expand(s, bk)
        if causal:
            mask = mask & (qpos[:, None] >= kp[None, :])
        if window:
            mask = mask & (kp[None, :] > (qpos[:, None] - window))
        sc = torch.where(mask[None, :, None, None, :], sc,
                         torch.full((), NEG, dtype=sc.dtype, device=dev))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(sc - m_new[..., None])
        l = l * alpha + pr.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgt,btkh->bskgh", pr.to(q.dtype).to(torch.float32),
            vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, h, hdv).to(q.dtype)


def attention(q, k, v, *, causal: bool, window: int = 0, cap: float = 0.0,
              scale=None):
    """``chunked_attention`` of (B, S, H, hd) queries against (B, T, KV,
    hd) keys and values.  On DTensors under installed rules each device
    runs it on its own rows and heads (``local_map``): the batch on its
    data axes, a sequence shard of the queries at its global positions,
    and the heads on the axis that shards the KV heads -- or, where only
    the query heads divide that axis, each device's query heads with the
    KV heads of their groups (the gradients of the shared K/V are then
    summed over the axis)."""
    rules = context.current_rules()
    if rules is None or not isinstance(q, DTensor):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 cap=cap, scale=scale)
    mesh = q.device_mesh
    b, s, h, _ = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    rows = rules.sharding((b, s), ("batch", "seq"))
    kvp = rules.sharding((b, t, kvh), ("batch", None, "kv_heads"))
    hp = rules.sharding((b, s, h), ("batch", "seq", "heads"))
    qpl, kpl, kgrad = [], [], []
    seq_dim = pick_dim = None
    for j in range(mesh.ndim):
        hl = h // mesh.size(j)
        if rows[j].is_shard():
            qpl.append(rows[j])
            if rows[j].dim == 0:
                kpl.append(Shard(0))
                kgrad.append(Shard(0))
            else:                       # a sequence shard of the queries
                seq_dim = j
                kpl.append(Replicate())
                kgrad.append(Partial())
        elif kvp[j].is_shard():
            qpl.append(Shard(2))
            kpl.append(Shard(2))
            kgrad.append(Shard(2))
        elif hp[j].is_shard() and (hl % g == 0 or g % hl == 0):
            pick_dim = j
            qpl.append(Shard(2))
            kpl.append(Replicate())
            kgrad.append(Partial())
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
            kgrad.append(Replicate())

    def local(ql, kl, vl):
        if pick_dim is not None:
            kv0 = mesh.get_local_rank(pick_dim) * ql.shape[2] // g
            nkv = max(ql.shape[2] // g, 1)
            kl, vl = kl[:, :, kv0:kv0 + nkv], vl[:, :, kv0:kv0 + nkv]
        qpos = None
        if seq_dim is not None:
            sl = ql.shape[1]
            qpos = torch.arange(sl, device=ql.device) \
                + mesh.get_local_rank(seq_dim) * sl
        return chunked_attention(ql, kl, vl, causal=causal, window=window,
                                 cap=cap, q_positions=qpos, scale=scale)

    qpl, kpl, kgrad = tuple(qpl), tuple(kpl), tuple(kgrad)
    return local_map(local, out_placements=(qpl,),
                     in_placements=(qpl, kpl, kpl),
                     in_grad_placements=(qpl, kgrad, kgrad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def attn_block(p, x, cfg, *, positions, causal=True, window=0, kv_x=None,
               rope=True):
    """Attention sub-block (projections + chunked attention + out): causal
    self-attention by default; the encoder's is non-causal, and
    cross-attention takes its keys and values from ``kv_x`` without rope."""
    q, k, v = _qkv(p, x, cfg, positions=positions, kv_x=kv_x, rope=rope)
    if cfg.seq_parallel:
        # Activations are sequence-sharded; attention needs the whole K/V:
        # one gather instead of the tensor-parallel reductions.
        k = context.constrain(k, ("batch", None, None, None))
        v = context.constrain(v, ("batch", None, None, None))
    o = attention(q, k, v, causal=causal, window=window,
                  cap=cfg.attn_softcap)
    hm = _head_mask(cfg, o.dtype, o.device)
    if hm is not None:
        o = o * hm[None, None, :, None]
    return heads_out(o, p["wo"])


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------

def pos_vec(pos, b: int, device) -> torch.Tensor:
    """Normalise scalar-or-(B,) decode positions to an int64 (B,) vector."""
    pv = torch.as_tensor(pos, device=device).to(torch.int64)
    return pv.expand(b) if pv.dim() == 0 else pv


def write_rows(buf, pv, new):
    """``buf[b, pv[b]] = new[b]`` for every row ``b``, in place.  On a
    DTensor cache the write is a select over the positions (an indexed
    write has no sharding strategy that keeps the cache's placement)."""
    if isinstance(buf, DTensor):
        hit = torch.arange(buf.shape[1], device=pv.device)[None, :] \
            == pv[:, None]
        hit = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        buf.copy_(torch.where(hit, new[:, None].to(buf.dtype), buf))
    else:
        buf[torch.arange(buf.shape[0], device=buf.device), pv] = \
            new.to(buf.dtype)


def attn_decode(p, x, cfg, cache, pos, *, window=0, cross=False):
    """x: (B, 1, D); cache: {"k","v"}: (B, T, KV, hd).  Returns (out, cache).

    ``pos`` is a scalar or per-row (B,) vector (continuous batching: slots
    may be at different depths).  Self-attention writes the new K/V at each
    row's own position, in place: the returned cache is the one passed in.
    Cross-attention (``cross``) reads a static encoder-side cache, every
    position valid; its query takes the bias but, as in the reference, not
    the QK norm."""
    b = x.shape[0]
    pv = pos_vec(pos, b, x.device)
    k, v = cache["k"], cache["v"]
    t = k.shape[1]
    if cross:
        q = heads_proj(x, p["wq"], "heads")
        if "bq" in p:
            q = q + p["bq"].to(x.dtype)
        mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    else:
        q, k1, v1 = _qkv(p, x, cfg, positions=pv[:, None])
        write_rows(k, pv, k1[:, 0])
        write_rows(v, pv, v1[:, 0])
        kpos = torch.arange(t, device=x.device)
        mask = kpos[None, :] <= pv[:, None]
        if window:
            mask = mask & (kpos[None, :] > (pv[:, None] - window))
    _, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = group_heads(q, kvh)
    sc = _scores(qg, k.to(q.dtype)) * (hd ** -0.5)
    if cfg.attn_softcap:
        sc = cm.softcap(sc, cfg.attn_softcap)
    sc = torch.where(mask[:, None, None, None, :], sc,
                     torch.full((), NEG, dtype=sc.dtype, device=x.device))
    pr = torch.softmax(sc, dim=-1).to(q.dtype)
    o = torch.einsum("bskgt,btkh->bskgh", pr, v.to(q.dtype))
    o = o.reshape(b, 1, h, hd)
    hm = _head_mask(cfg, o.dtype, o.device)
    if hm is not None:
        o = o * hm[None, None, :, None]
    out = heads_out(o, p["wo"])
    return out, cache


def init_decode_cache(dtype, cfg, batch: int, max_len: int, device=None):
    """Zeroed K/V cache, each leaf its own storage; ``device=None`` is the
    card."""
    device = cm.device_or_card(device)
    kv, hd = cfg.n_kv_heads, cfg.hd
    shape = (batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(init: cm.Init, cfg):
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.nope_dim + m.rope_dim
    return {
        "wdq": init.normal((d, m.q_lora), ("embed", None)),
        "qn": init.zeros((m.q_lora,), (None,)),
        "wuq": init.normal((m.q_lora, h, qk), (None, "heads", None)),
        "wdkv": init.normal((d, m.kv_lora), ("embed", None)),
        "kvn": init.zeros((m.kv_lora,), (None,)),
        "wkr": init.normal((d, m.rope_dim), ("embed", None)),
        "wuk": init.normal((m.kv_lora, h, m.nope_dim),
                           (None, "heads", None)),
        "wuv": init.normal((m.kv_lora, h, m.v_dim),
                           (None, "heads", None)),
        "wo": init.normal((h, m.v_dim, d), ("heads", None, "embed")),
    }


def _mla_rope(x, positions, cfg):
    """Rotary on MLA's rope dims (..., S, heads, rope_dim): YaRN's
    frequencies where the configuration has them, else plain rotary."""
    m = cfg.mla
    if not isinstance(m, YarnMLACfg):
        return cm.apply_rope(x, positions, 1.0, cfg.rope_theta)
    return cm.rotate(x, positions, _yarn_inv(m.rope_dim, cfg.rope_theta,
                                             m.yarn, x.device))


@functools.lru_cache(maxsize=8)
def _yarn_inv(dim: int, theta: float, yarn, device):
    """YaRN's inverse frequencies as a float32 tensor on ``device``, made
    once (a copy to the card a call would add two to every MLA layer)."""
    return torch.tensor(cm.yarn_frequencies(dim, theta, yarn),
                        dtype=torch.float32, device=device)


def mla_scale(cfg) -> float:
    """MLA's softmax scale: (nope + rope) ** -0.5, times YaRN's mscale
    squared where the configuration has YaRN."""
    m = cfg.mla
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    if isinstance(m, YarnMLACfg):
        scale *= cm.yarn_mscale(m.yarn)
    return scale


def _mla_qkr(p, x, cfg, positions):
    """Queries through the low-rank q path: (q_nope, q_rope rotated)."""
    m = cfg.mla
    cq = cm.rms_norm(torch.einsum("bsd,dq->bsq", x, p["wdq"].to(x.dtype)),
                     p["qn"], cfg.norm_eps)
    q = torch.einsum("bsq,qhk->bshk", cq, p["wuq"].to(x.dtype))
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    return q_nope, _mla_rope(q_rope, positions, cfg)


def _mla_latent(p, x, cfg, positions):
    """The cached pair: normed latent c (B,S,kv_lora), rotated kr
    (B,S,rope_dim)."""
    c = cm.rms_norm(torch.einsum("bsd,dc->bsc", x, p["wdkv"].to(x.dtype)),
                    p["kvn"], cfg.norm_eps)
    kr = torch.einsum("bsd,dr->bsr", x, p["wkr"].to(x.dtype))
    kr = _mla_rope(kr[:, :, None, :], positions, cfg)[:, :, 0, :]
    return c, kr


def mla_block(p, x, cfg, *, positions):
    """Training / prefill MLA: the latent expanded to per-head K/V, causal
    chunked attention (scale ``mla_scale``, no softcap)."""
    m = cfg.mla
    q_nope, q_rope = _mla_qkr(p, x, cfg, positions)
    c, kr = _mla_latent(p, x, cfg, positions)
    k_nope = torch.einsum("bsc,chk->bshk", c, p["wuk"].to(x.dtype))
    v = torch.einsum("bsc,chv->bshv", c, p["wuv"].to(x.dtype))
    h = cfg.n_heads
    k_rope = kr[:, :, None, :].expand(kr.shape[:2] + (h, m.rope_dim))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    o = attention(q, k, v, causal=True, scale=mla_scale(cfg))
    return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(x.dtype))


def mla_decode(p, x, cfg, cache, pos):
    """Absorbed MLA decode: cache is {"c": (B,T,kv_lora), "kr": (B,T,rope)}.
    ``pos`` is a scalar or per-row (B,) vector; each row's latent and
    rotated key are written at its own position, in place (the returned
    cache is the one passed in)."""
    with telemetry.span("mla.decode"):
        return _mla_decode(p, x, cfg, cache, pos)


def _mla_decode(p, x, cfg, cache, pos):
    b = x.shape[0]
    pv = pos_vec(pos, b, x.device)
    q_nope, q_rope = _mla_qkr(p, x, cfg, pv[:, None])
    c1, kr1 = _mla_latent(p, x, cfg, pv[:, None])
    c, kr = cache["c"], cache["kr"]
    write_rows(c, pv, c1[:, 0])
    write_rows(kr, pv, kr1[:, 0])
    # Absorb W_uk into q: scores on the latent side, fp32 from
    # compute-dtype operands.
    q_lat = torch.einsum("bshk,chk->bshc", q_nope, p["wuk"].to(x.dtype))
    f32 = torch.float32
    sc = (torch.einsum("bshc,btc->bsht", q_lat.to(f32),
                       c.to(x.dtype).to(f32))
          + torch.einsum("bshr,btr->bsht", q_rope.to(f32),
                         kr.to(x.dtype).to(f32)))
    sc = sc * mla_scale(cfg)
    mask = torch.arange(c.shape[1], device=x.device)[None, :] <= pv[:, None]
    sc = torch.where(mask[:, None, None, :], sc,
                     torch.full((), NEG, dtype=sc.dtype, device=x.device))
    pr = torch.softmax(sc, dim=-1).to(x.dtype)
    ctx = torch.einsum("bsht,btc->bshc", pr, c.to(x.dtype))
    o = torch.einsum("bshc,chv->bshv", ctx, p["wuv"].to(x.dtype))
    return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(x.dtype)), cache


def init_mla_cache(dtype, cfg, batch: int, max_len: int, device=None):
    """Zeroed latent cache; ``device=None`` is the card."""
    device = cm.device_or_card(device)
    m = cfg.mla
    return {"c": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, max_len, m.rope_dim), dtype=dtype,
                              device=device)}
