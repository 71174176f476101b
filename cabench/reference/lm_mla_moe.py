"""DeepSeek-V3's decoder (arXiv:2412.19437; hf deepseek-ai/DeepSeek-V3,
its config.json and ``inference/model.py``) in plain float32 PyTorch,
one chip's expert share of it: the reference of the DeepSeek-V3 cell's
``correct``.

Each layer: ``x + mla(norm1(x))``, then ``x + ffn(norm2(x))``; RMSNorm at
``rms_norm_eps``.  MLA in its non-absorbed form: the query through its
low rank, ``cq = norm(x Wdq)``, ``q = cq Wuq`` split per head into nope
and rope dims; the latent ``c = norm(x Wdkv)`` lifted to per-head keys
``c Wuk`` and values ``c Wuv``; one rotated key ``x Wkr`` shared by every
head; causal softmax of ``(q_nope k_nope + q_rope k_rope) * scale``;
output ``o Wo``.  Rotary by YaRN's frequencies (``rope_scaling``: pair i
turns at theta ** (-2 i / rope) below the correction range, that over
``factor`` above it, blended linearly between) and the softmax scale
``(nope + rope) ** -0.5`` times ``(0.1 mscale_all_dim ln factor + 1) **
2``.  The first ``first_k_dense_replace`` layers take a SwiGLU of
``intermediate_size``; the rest the expert layer: the gate's sigmoid
scores over all ``n_routed_experts * ep_size`` experts, biased by the
correction ``bias`` for the choice, each of ``n_group`` groups scored by
its top 2, the top ``topk_group`` groups kept, the top
``num_experts_per_tok`` experts of those (ties to the lower index); the
weights the chosen unbiased scores over their sum times
``routed_scaling_factor``; then each chosen expert's SwiGLU of
``moe_intermediate_size`` times its weight, plus the shared expert's.
A final RMSNorm and an untied head.  No bias in any projection.

Departures from the published model:

* the expert share: only the experts ``[ep_rank * n, (ep_rank + 1) *
  n)`` (n = ``n_routed_experts``, those one chip of ``ep_size`` holds) add
  their part; the others' part is left out, as it is in the program, and
  what is left goes on to the next layer;
* no MTP module (``num_nextn_predict_layers`` 0): a draft head for
  speculative decoding, outside the served logits;
* rotary pairs are the half-split (``rotate_half``) pairs, dims j and j +
  rope / 2, where the published checkpoint pairs adjacent dims: with drawn
  weights a fixed permutation of ``wuq``'s and ``wkr``'s rotary columns;
* the layout the benchmark draws its weights in (``shapes``), RMSNorm
  gains stored as their offset from 1;
* float32 throughout, TF32 off (``logits`` turns it off), rotary angles
  in float64.

The weights are read layer by layer, each layer's cast to float32 in
turn, and attention is computed a block of queries at a time, so that
the reference fits beside the weights it is given.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

ATTN = ("n1", "wdq", "qn", "wuq", "wdkv", "kvn", "wkr", "wuk", "wuv", "wo",
        "n2")
DENSE = ("wg", "wu", "wd")
MOE = ("router", "bias", "ewg", "ewu", "ewd", "swg", "swu", "swd")
QUERY_BLOCK = 512


def shapes(w: Dict) -> Dict[str, tuple]:
    """Every weight's shape, by name, for the configuration ``w`` (the
    config.json's keys)."""
    n, d, h = w["num_hidden_layers"], w["hidden_size"], \
        w["num_attention_heads"]
    nd = w["first_k_dense_replace"]
    nm = n - nd
    ql, kvl = w["q_lora_rank"], w["kv_lora_rank"]
    rope, nope, vd = (w["qk_rope_head_dim"], w["qk_nope_head_dim"],
                      w["v_head_dim"])
    f, fe = w["intermediate_size"], w["moe_intermediate_size"]
    el = w["n_routed_experts"]
    fs = fe * w["n_shared_experts"]
    v = w["vocab_size"]
    return {"embed": (v, d), "n1": (n, d), "wdq": (n, d, ql), "qn": (n, ql),
            "wuq": (n, ql, h, nope + rope), "wdkv": (n, d, kvl),
            "kvn": (n, kvl), "wkr": (n, d, rope), "wuk": (n, kvl, h, nope),
            "wuv": (n, kvl, h, vd), "wo": (n, h, vd, d), "n2": (n, d),
            "wg": (nd, d, f), "wu": (nd, d, f), "wd": (nd, f, d),
            "router": (nm, d, el * w["ep_size"]),
            "bias": (nm, el * w["ep_size"]),
            "ewg": (nm, el, d, fe), "ewu": (nm, el, d, fe),
            "ewd": (nm, el, fe, d), "swg": (nm, d, fs), "swu": (nm, d, fs),
            "swd": (nm, fs, d), "final_norm": (d,), "head": (d, v)}


def rms_norm(x, g, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + g)


def yarn_inv_freq(w: Dict) -> np.ndarray:
    """YaRN's inverse frequencies of the rotary pairs, float64."""
    dim, theta = w["qk_rope_head_dim"], w["rope_theta"]
    rs = w["rope_scaling"]
    inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)

    def dim_of(turns):
        return dim * np.log(rs["original_max_position_embeddings"]
                            / (turns * 2 * np.pi)) / (2 * np.log(theta))

    low = max(int(np.floor(dim_of(rs["beta_fast"]))), 0)
    high = min(int(np.ceil(dim_of(rs["beta_slow"]))), dim - 1)
    span = high - low if high > low else 0.001
    ramp = np.clip((np.arange(dim // 2) - low) / span, 0.0, 1.0)
    return inv * (1.0 - ramp) + inv / rs["factor"] * ramp


def softmax_scale(w: Dict) -> float:
    rs = w["rope_scaling"]
    m = 0.1 * rs["mscale_all_dim"] * np.log(rs["factor"]) + 1.0
    return float((w["qk_nope_head_dim"] + w["qk_rope_head_dim"]) ** -0.5
                 * m * m)


def rotary(x, inv: np.ndarray):
    """(S, heads, rope) turned by the positions 0 .. S - 1."""
    s, r = x.shape[0], x.shape[-1]
    ang = np.arange(s, dtype=np.float64)[:, None] * inv[None, :]
    cos = torch.tensor(np.cos(ang), dtype=x.dtype, device=x.device)[:, None]
    sin = torch.tensor(np.sin(ang), dtype=x.dtype, device=x.device)[:, None]
    x1, x2 = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, wg, wu, wd):
    g = x @ wg
    return (g * torch.sigmoid(g) * (x @ wu)) @ wd


def mla(a, p: Dict, w: Dict):
    """Causal MLA of the normed sequence ``a`` (S, D), non-absorbed."""
    s, d = a.shape
    h, nope, rope, vd = (w["num_attention_heads"], w["qk_nope_head_dim"],
                         w["qk_rope_head_dim"], w["v_head_dim"])
    eps = w["rms_norm_eps"]
    inv = yarn_inv_freq(w)
    cq = rms_norm(a @ p["wdq"], p["qn"], eps)
    q = (cq @ p["wuq"].reshape(cq.shape[1], -1)).view(s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], rotary(q[..., nope:], inv)
    c = rms_norm(a @ p["wdkv"], p["kvn"], eps)
    kr = rotary((a @ p["wkr"])[:, None, :], inv)[:, 0]            # (S, r)
    k_nope = (c @ p["wuk"].reshape(c.shape[1], -1)).view(s, h, nope)
    v = (c @ p["wuv"].reshape(c.shape[1], -1)).view(s, h, vd)
    k_nope, v = k_nope.transpose(0, 1), v.transpose(0, 1)         # (H,S,.)
    scale = softmax_scale(w)
    out = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        sc = (q_nope[q0:q1].transpose(0, 1) @ k_nope.transpose(1, 2)
              + (q_rope[q0:q1] @ kr.T).transpose(0, 1)) * scale
        future = torch.arange(s, device=a.device)[None, :] \
            > torch.arange(q0, q1, device=a.device)[:, None]
        pr = torch.softmax(sc.masked_fill(future, float("-inf")), dim=-1)
        out.append((pr @ v).transpose(0, 1).reshape(q1 - q0, h * vd))
        del sc, pr
    return torch.cat(out) @ p["wo"].reshape(h * vd, d)


def gate(m, p: Dict, w: Dict):
    """The published gate over ``m`` (S, D): ``(weight, expert)``, (S, k)
    each."""
    s = m.shape[0]
    scores = torch.sigmoid(m @ p["router"])
    biased = (scores + p["bias"]).view(s, w["n_group"], -1)
    top2 = biased.topk(2, dim=-1).values.sum(-1)
    groups = torch.sort(top2, dim=-1, descending=True,
                        stable=True).indices[:, :w["topk_group"]]
    keep = torch.zeros_like(top2, dtype=torch.bool).scatter_(1, groups, True)
    biased = biased.masked_fill(~keep[..., None], float("-inf")).view(s, -1)
    expert = torch.sort(biased, dim=-1, descending=True,
                        stable=True).indices[:, :w["num_experts_per_tok"]]
    weight = scores.gather(1, expert)
    weight = weight / weight.sum(-1, keepdim=True) \
        * w["routed_scaling_factor"]
    return weight, expert


def expert_layer(m, p: Dict, w: Dict):
    """The held experts' part of the routed experts, plus the shared
    expert, over ``m`` (S, D)."""
    weight, expert = gate(m, p, w)
    n = w["n_routed_experts"]
    e0 = w["ep_rank"] * n
    out = swiglu(m, p["swg"], p["swu"], p["swd"])
    for j in range(n):
        hit = expert == e0 + j                                     # (S, k)
        tok = hit.any(-1).nonzero()[:, 0]
        if tok.numel():
            wt = (weight * hit)[tok].sum(-1, keepdim=True)
            out[tok] += wt * swiglu(m[tok], p["ewg"][j], p["ewu"][j],
                                    p["ewd"][j])
    return out


def layer(x, p: Dict, w: Dict, moe: bool):
    """One decoder layer over a whole sequence ``x`` (S, D)."""
    eps = w["rms_norm_eps"]
    x = x + mla(rms_norm(x, p["n1"], eps), p, w)
    m = rms_norm(x, p["n2"], eps)
    if moe:
        return x + expert_layer(m, p, w)
    return x + swiglu(m, p["wg"], p["wu"], p["wd"])


def logits(weights: Dict[str, torch.Tensor], w: Dict,
           seqs: Sequence, first: Sequence[int]) -> List[torch.Tensor]:
    """Float32 logits of each token sequence ``seqs[i]`` at its positions
    ``first[i]`` onwards, (len - first, vocab) each, on the weights'
    device.  ``weights`` by the names of ``shapes``, of any float type."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    dev = weights["embed"].device
    nd = w["first_k_dense_replace"]
    xs = [weights["embed"][torch.as_tensor(t, device=dev).long()].to(f32)
          for t in seqs]
    for i in range(w["num_hidden_layers"]):
        moe = i >= nd
        p = {k: weights[k][i].to(f32) for k in ATTN}
        p.update({k: weights[k][i - nd if moe else i].to(f32)
                  for k in (MOE if moe else DENSE)})
        xs = [layer(x, p, w, moe) for x in xs]
        del p
    g = weights["final_norm"].to(f32)
    head = weights["head"].to(f32)
    return [rms_norm(x[s:], g, w["rms_norm_eps"]) @ head
            for x, s in zip(xs, first)]
