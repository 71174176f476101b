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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm

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
        "wq": init.normal((d, h, hd)),
        "wk": init.normal((d, kv, hd)),
        "wv": init.normal((d, kv, hd)),
        "wo": init.normal((h, hd, d)),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = init.zeros((h, hd))
        p["bk"] = init.zeros((kv, hd))
        p["bv"] = init.zeros((kv, hd))
    if cfg.qk_norm:
        p["qn"] = init.zeros((hd,))
        p["kn"] = init.zeros((hd,))
    return p


def _qkv(p, x, cfg, positions=None, kv_x=None, rope: bool = True):
    """Project to q (B,S,H,hd) and k/v (B,T,KV,hd) -- k/v from ``kv_x``
    (cross-attention: the encoder's output) when given, else from ``x``
    -- with bias/qk-norm, and rope when ``rope`` and ``positions``."""
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", kv_x, p["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", kv_x, p["wv"].to(x.dtype))
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
                      kv_positions=None, q_positions=None):
    """Attention as an online softmax over KV chunks.

    q: (B, S, H, hd);  k, v: (B, T, KV, hd) with H % KV == 0.
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
    qg = q.reshape(b, s, kvh, g, hd)
    scale = hd ** -0.5
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


def attn_block(p, x, cfg, *, positions, causal=True, window=0, kv_x=None,
               rope=True):
    """Attention sub-block (projections + chunked attention + out): causal
    self-attention by default; the encoder's is non-causal, and
    cross-attention takes its keys and values from ``kv_x`` without rope."""
    q, k, v = _qkv(p, x, cfg, positions=positions, kv_x=kv_x, rope=rope)
    o = chunked_attention(q, k, v, causal=causal, window=window,
                          cap=cfg.attn_softcap)
    hm = _head_mask(cfg, o.dtype, o.device)
    if hm is not None:
        o = o * hm[None, None, :, None]
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------

def pos_vec(pos, b: int, device) -> torch.Tensor:
    """Normalise scalar-or-(B,) decode positions to an int64 (B,) vector."""
    pv = torch.as_tensor(pos, device=device).to(torch.int64)
    return pv.expand(b) if pv.dim() == 0 else pv


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
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
        if "bq" in p:
            q = q + p["bq"].to(x.dtype)
        mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    else:
        q, k1, v1 = _qkv(p, x, cfg, positions=pv[:, None])
        rows = torch.arange(b, device=x.device)
        k[rows, pv] = k1[:, 0].to(k.dtype)
        v[rows, pv] = v1[:, 0].to(v.dtype)
        kpos = torch.arange(t, device=x.device)
        mask = kpos[None, :] <= pv[:, None]
        if window:
            mask = mask & (kpos[None, :] > (pv[:, None] - window))
    _, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
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
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
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
        "wdq": init.normal((d, m.q_lora)),
        "qn": init.zeros((m.q_lora,)),
        "wuq": init.normal((m.q_lora, h, qk)),
        "wdkv": init.normal((d, m.kv_lora)),
        "kvn": init.zeros((m.kv_lora,)),
        "wkr": init.normal((d, m.rope_dim)),
        "wuk": init.normal((m.kv_lora, h, m.nope_dim)),
        "wuv": init.normal((m.kv_lora, h, m.v_dim)),
        "wo": init.normal((h, m.v_dim, d)),
    }


def _mla_qkr(p, x, cfg, positions):
    """Queries through the low-rank q path: (q_nope, q_rope rotated)."""
    m = cfg.mla
    cq = cm.rms_norm(torch.einsum("bsd,dq->bsq", x, p["wdq"].to(x.dtype)),
                     p["qn"], cfg.norm_eps)
    q = torch.einsum("bsq,qhk->bshk", cq, p["wuq"].to(x.dtype))
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = cm.apply_rope(q_rope, positions, 1.0, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, cfg, positions):
    """The cached pair: normed latent c (B,S,kv_lora), rotated kr
    (B,S,rope_dim)."""
    c = cm.rms_norm(torch.einsum("bsd,dc->bsc", x, p["wdkv"].to(x.dtype)),
                    p["kvn"], cfg.norm_eps)
    kr = torch.einsum("bsd,dr->bsr", x, p["wkr"].to(x.dtype))
    kr = cm.apply_rope(kr[:, :, None, :], positions, 1.0,
                       cfg.rope_theta)[:, :, 0, :]
    return c, kr


def mla_block(p, x, cfg, *, positions):
    """Training / prefill MLA: the latent expanded to per-head K/V, causal
    chunked attention (scale ``(nope + rope) ** -0.5``, no softcap)."""
    m = cfg.mla
    q_nope, q_rope = _mla_qkr(p, x, cfg, positions)
    c, kr = _mla_latent(p, x, cfg, positions)
    k_nope = torch.einsum("bsc,chk->bshk", c, p["wuk"].to(x.dtype))
    v = torch.einsum("bsc,chv->bshv", c, p["wuv"].to(x.dtype))
    h = cfg.n_heads
    k_rope = kr[:, :, None, :].expand(kr.shape[:2] + (h, m.rope_dim))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    o = chunked_attention(q, k, v, causal=True)
    return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(x.dtype))


def mla_decode(p, x, cfg, cache, pos):
    """Absorbed MLA decode: cache is {"c": (B,T,kv_lora), "kr": (B,T,rope)}.
    ``pos`` is a scalar or per-row (B,) vector; each row's latent and
    rotated key are written at its own position, in place (the returned
    cache is the one passed in)."""
    m = cfg.mla
    b = x.shape[0]
    pv = pos_vec(pos, b, x.device)
    q_nope, q_rope = _mla_qkr(p, x, cfg, pv[:, None])
    c1, kr1 = _mla_latent(p, x, cfg, pv[:, None])
    rows = torch.arange(b, device=x.device)
    c, kr = cache["c"], cache["kr"]
    c[rows, pv] = c1[:, 0].to(c.dtype)
    kr[rows, pv] = kr1[:, 0].to(kr.dtype)
    # Absorb W_uk into q: scores on the latent side, fp32 from
    # compute-dtype operands.
    q_lat = torch.einsum("bshk,chk->bshc", q_nope, p["wuk"].to(x.dtype))
    f32 = torch.float32
    sc = (torch.einsum("bshc,btc->bsht", q_lat.to(f32),
                       c.to(x.dtype).to(f32))
          + torch.einsum("bshr,btr->bsht", q_rope.to(f32),
                         kr.to(x.dtype).to(f32)))
    sc = sc * ((m.nope_dim + m.rope_dim) ** -0.5)
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
