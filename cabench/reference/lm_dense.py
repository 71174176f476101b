"""InternLM2's decoder (arXiv:2403.17297; hf internlm/internlm2-20b) in
plain float32 PyTorch: the reference of the LM cells' ``correct``.

Each layer: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``; RMSNorm;
causal grouped-query softmax attention, query head h reading key/value
head h // (n_heads / n_kv_heads), scaled by head_dim ** -0.5; rotary on
all head_dim dimensions in the half-split (``rotate_half``) form, pair j
turning by position * theta ** (-2 j / head_dim); SwiGLU ``down(silu(gate
x) * up x)``; a final RMSNorm and an untied head.  No bias anywhere.

Departures from the published model, none of which changes its
mathematics:

* the published fused and interleaved ``wqkv`` is three matrices here,
  ``wq`` (L, D, H, hd), ``wk`` and ``wv`` (L, D, KV, hd), and ``wo`` is
  (L, H, hd, D): the layout the benchmark draws its weights in
  (``shapes``);
* an RMSNorm's gain is stored as its offset from 1 (the gain is 1 + w),
  so an untrained norm stores zeros;
* float32 throughout, with TF32 off (``logits`` turns it off: on the
  H100 a float32 matrix product may otherwise run in TF32); the angles
  of the rotary in float64.

The weights are read layer by layer, each layer's cast to float32 in
turn, so that the reference fits beside the weights it is given.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

LAYER = ("n1", "wq", "wk", "wv", "wo", "n2", "wg", "wu", "wd")


def shapes(w: Dict) -> Dict[str, tuple]:
    """Every weight's shape, by name, for widths ``w``."""
    n, d, h, kv, hd, f, v = (w[k] for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab"))
    return {"embed": (v, d), "n1": (n, d), "wq": (n, d, h, hd),
            "wk": (n, d, kv, hd), "wv": (n, d, kv, hd), "wo": (n, h, hd, d),
            "n2": (n, d), "wg": (n, d, f), "wu": (n, d, f), "wd": (n, f, d),
            "final_norm": (d,), "head": (d, v)}


def rms_norm(x, g, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + g)


def rotary(x, theta: float):
    """(S, heads, hd) turned by the positions 0 .. S - 1."""
    s, hd = x.shape[0], x.shape[-1]
    inv = theta ** (-np.arange(0, hd, 2, dtype=np.float64) / hd)
    ang = np.arange(s, dtype=np.float64)[:, None] * inv[None, :]
    cos = torch.tensor(np.cos(ang), dtype=x.dtype, device=x.device)[:, None]
    sin = torch.tensor(np.sin(ang), dtype=x.dtype, device=x.device)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(x, p: Dict, w: Dict):
    """One decoder layer over a whole sequence ``x`` (S, D)."""
    s, d = x.shape
    h, kv, hd = w["n_heads"], w["n_kv_heads"], w["head_dim"]
    a = rms_norm(x, p["n1"], w["norm_eps"])
    q = rotary((a @ p["wq"].reshape(d, h * hd)).view(s, h, hd),
               w["rope_theta"])
    k = rotary((a @ p["wk"].reshape(d, kv * hd)).view(s, kv, hd),
               w["rope_theta"])
    v = (a @ p["wv"].reshape(d, kv * hd)).view(s, kv, hd)
    k = k.transpose(0, 1).repeat_interleave(h // kv, dim=0)
    v = v.transpose(0, 1).repeat_interleave(h // kv, dim=0)
    sc = q.transpose(0, 1) @ k.transpose(1, 2) * hd ** -0.5   # (H, S, S)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    pr = torch.softmax(sc.masked_fill(future, float("-inf")), dim=-1)
    o = (pr @ v).transpose(0, 1).reshape(s, h * hd)
    x = x + o @ p["wo"].reshape(h * hd, d)
    m = rms_norm(x, p["n2"], w["norm_eps"])
    g = m @ p["wg"]
    return x + (g * torch.sigmoid(g) * (m @ p["wu"])) @ p["wd"]


def logits(weights: Dict[str, torch.Tensor], w: Dict,
           seqs: Sequence[torch.Tensor], first: Sequence[int]
           ) -> List[torch.Tensor]:
    """Float32 logits of each token sequence ``seqs[i]`` at its positions
    ``first[i]`` onwards, (len - first, vocab) each, on the weights'
    device.  ``weights`` by the names of ``shapes``, of any float type."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    dev = weights["embed"].device
    xs = [weights["embed"][torch.as_tensor(t, device=dev).long()].to(f32)
          for t in seqs]
    for i in range(w["n_layers"]):
        p = {k: weights[k][i].to(f32) for k in LAYER}
        xs = [layer(x, p, w) for x in xs]
        del p
    g = weights["final_norm"].to(f32)
    head = weights["head"].to(f32)
    return [rms_norm(x[s:], g, w["norm_eps"]) @ head
            for x, s in zip(xs, first)]
