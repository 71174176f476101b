"""Mamba-2 SSD (state-space duality) block: chunked-scan forward and O(1)
recurrent decode.

The chunked algorithm follows the reference's (arXiv:2405.21060) block
decomposition: a quadratic attention-like intra-chunk term, a low-rank
inter-chunk term and a sequential state hand-off between chunks.  The SSD
core runs in float32 whatever the compute dtype (``dt``, the cumulative
decays and the states: exp-sums that underflow in bf16).

``ssm_decode`` updates its cache (state, conv buffer) in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, nheads, conv_ch


def init_ssm(init: cm.Init, cfg):
    s, d = cfg.ssm, cfg.d_model
    d_in, nheads, conv_ch = dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nheads
    # dt bias: softplus^-1 of dt ~ U[1e-3, 1e-1]; A ~ U[1, 16] -- the
    # reference's own numpy draws, so these leaves equal its values.
    rng = np.random.default_rng(0)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), nheads))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    a0 = rng.uniform(1.0, 16.0, nheads)
    return {
        "in_proj": init.normal((d, proj_out), ("embed", "d_ff")),
        "conv_w": init.normal((s.conv_dim, conv_ch), (None, "d_ff"),
                              scale=0.1),
        "conv_b": init.zeros((conv_ch,), ("d_ff",)),
        "A_log": init.const(np.log(a0), (None,)),
        "D": init.ones((nheads,), (None,)),
        "dt_bias": init.const(dt_bias, (None,)),
        "norm_w": init.zeros((d_in,), (None,)),
        "out_proj": init.normal((d_in, d), ("d_ff", "embed")),
    }


def _split_proj(zxbcdt, cfg):
    s = cfg.ssm
    d_in, nheads, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nheads], dim=-1)


def _causal_conv(x, w, bias):
    """Depthwise causal conv over (B, S, C) with kernel (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + bias[None, None, :]


def ssm_block(p, x, cfg, *, mask=None, return_state=False,
              real_len: int = 0):
    """Training/prefill forward, chunked SSD.  x: (B, S, D) -> (B, S, D).

    ``mask`` (B, S) zeroes dt at (right-)padded positions so the state is
    unaffected by padding; with ``return_state`` also returns the decode
    cache ``(state, conv_buf)`` at position ``real_len`` (defaults to S),
    for an exact prefill -> decode continuation.
    """
    s = cfg.ssm
    d_in, nheads, _ = dims(cfg)
    b_, seq, _ = x.shape
    assert seq % s.chunk == 0, (seq, s.chunk)
    nc, q = seq // s.chunk, s.chunk
    hp, g, n = s.head_dim, s.n_groups, s.d_state
    f32 = torch.float32

    zxbcdt = torch.einsum("bsd,dp->bsp", x, p["in_proj"].to(x.dtype))
    z, xs, bb, cc, dt = _split_proj(zxbcdt, cfg)
    xbc_raw = torch.cat([xs, bb, cc], dim=-1)
    xbc = cm.silu(_causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype)))
    xs, bb, cc = torch.split(xbc, [d_in, g * n, g * n], dim=-1)

    xh = xs.reshape(b_, nc, q, nheads, hp).to(f32)
    bg = bb.reshape(b_, nc, q, g, n).to(f32)
    cg = cc.reshape(b_, nc, q, g, n).to(f32)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
    if mask is not None:
        dt = dt * mask.to(f32)[..., None]
    dt = dt.reshape(b_, nc, q, nheads)
    a = -torch.exp(p["A_log"].to(f32))                      # (H,)
    da = dt * a                                             # (B,nc,Q,H) <= 0
    lcum = torch.cumsum(da, dim=2)                          # within-chunk

    hg = nheads // g  # heads per B/C group

    # --- intra-chunk (quadratic, masked) ---
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cg, bg)
    # decay from source k to query q: sum_{i=k+1..q} da_i = lcum_q - lcum_k
    decay = lcum[..., :, None, :] - lcum[..., None, :, :]   # (B,nc,Q,K,H)
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    w_qk = torch.where(tril[None, None, :, :, None], torch.exp(decay),
                       torch.zeros((), dtype=f32, device=x.device))
    del decay
    cb_h = torch.repeat_interleave(cb, hg, dim=2)           # (B,nc,H,Q,K)
    w_full = cb_h.permute(0, 1, 3, 4, 2) * w_qk             # (B,nc,Q,K,H)
    del w_qk, cb_h
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w_full,
                           xh * dt[..., None])
    del w_full

    # --- chunk states and inter-chunk hand-off ---
    seg = torch.exp(lcum[..., -1:, :] - lcum)               # decay to chunk end
    bxh = torch.einsum("bcqhn,bcqhp->bchnp",
                       torch.repeat_interleave(bg, hg, dim=3)
                       * (dt * seg)[..., None], xh)
    chunk_decay = torch.exp(lcum[:, :, -1, :])              # (B,nc,H)

    state = torch.zeros((b_, nheads, n, hp), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + bxh[:, c]
    prev = torch.stack(prev, dim=1)                         # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           torch.repeat_interleave(cg, hg, dim=3)
                           * torch.exp(lcum)[..., None], prev)

    y = (y_intra + y_inter
         + p["D"].to(f32)[None, None, None, :, None] * xh)
    y = y.reshape(b_, seq, d_in).to(x.dtype)
    y = cm.rms_norm(y * cm.silu(z), p["norm_w"], cfg.norm_eps)
    out = torch.einsum("bsd,dp->bsp", y, p["out_proj"].to(x.dtype))
    if not return_state:
        return out
    rl = real_len or seq
    kd = p["conv_w"].shape[0]
    conv_buf = (xbc_raw[:, rl - kd:rl, :] if rl >= kd
                else F.pad(xbc_raw[:, :rl, :], (0, 0, kd - rl, 0)))
    return out, (state, conv_buf)


def ssm_block_naive(p, x, cfg):
    """Token-by-token recurrence (the oracle for the chunked path)."""
    b_, seq, _ = x.shape
    cache = init_ssm_cache(torch.float32, cfg, b_, device=x.device)
    outs = []
    for i in range(seq):
        o, cache = ssm_decode(p, x[:, i:i + 1], cfg, cache)
        outs.append(o)
    return torch.cat(outs, dim=1)


def init_ssm_cache(dtype, cfg, batch: int, device=None):
    """(state float32 (B, H, N, P), conv buffer (B, K, C) in ``dtype``);
    ``device=None`` is the card."""
    device = cm.device_or_card(device)
    s = cfg.ssm
    d_in, nheads, conv_ch = dims(cfg)
    state = torch.zeros((batch, nheads, s.d_state, s.head_dim),
                        dtype=torch.float32, device=device)
    conv = torch.zeros((batch, s.conv_dim, conv_ch), dtype=dtype,
                       device=device)
    return state, conv


def ssm_decode(p, x, cfg, cache):
    """One-token recurrent step.  x: (B, 1, D); cache: (state, conv_buf),
    both updated in place; returns (out, cache)."""
    s = cfg.ssm
    d_in, nheads, conv_ch = dims(cfg)
    g, n, hp = s.n_groups, s.d_state, s.head_dim
    state, conv_buf = cache
    b_ = x.shape[0]
    f32 = torch.float32

    zxbcdt = torch.einsum("bsd,dp->bsp", x, p["in_proj"].to(x.dtype))
    z, xs, bb, cc, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([xs, bb, cc], dim=-1)[:, 0, :]          # (B, conv_ch)
    conv_buf.copy_(torch.cat([conv_buf[:, 1:, :],
                              xbc[:, None, :].to(conv_buf.dtype)], dim=1))
    conv_out = torch.einsum("bkc,kc->bc", conv_buf.to(f32),
                            p["conv_w"].to(f32))
    conv_out = cm.silu(conv_out + p["conv_b"].to(f32))
    xs, bb, cc = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    xh = xs.reshape(b_, nheads, hp)
    bg = torch.repeat_interleave(bb.reshape(b_, g, n), nheads // g, dim=1)
    cg = torch.repeat_interleave(cc.reshape(b_, g, n), nheads // g, dim=1)
    dt = F.softplus(dt[:, 0, :].to(f32) + p["dt_bias"].to(f32))  # (B,H)
    a = -torch.exp(p["A_log"].to(f32))
    da = torch.exp(dt * a)                                  # (B,H)

    state.copy_(state * da[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", bg * dt[..., None], xh))
    y = (torch.einsum("bhn,bhnp->bhp", cg, state)
         + p["D"].to(f32)[None, :, None] * xh)
    y = y.reshape(b_, 1, d_in).to(x.dtype)
    y = cm.rms_norm(y * cm.silu(z), p["norm_w"], cfg.norm_eps)
    out = torch.einsum("bsd,dp->bsp", y, p["out_proj"].to(x.dtype))
    return out, cache
