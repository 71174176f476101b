"""Frozen counts of DeepSeek-V3's work on one chip of its expert-parallel
deployment, from its configuration's widths alone and never from the
program: the yardstick of the DeepSeek-V3 cell's ``mfu``,
``moe.expert_byte_roofline`` and ``mla.decode_roofline``.

The layer is the published one (arXiv:2412.19437; the names are those
of its config.json): MLA with 128 heads, a query rank ``q_lora_rank``, a
latent of ``kv_lora_rank`` and rotary keys of ``qk_rope_head_dim``; the
first ``first_k_dense_replace`` layers a SwiGLU of ``intermediate_size``,
the rest a router over ``n_routed_experts * ep_size`` experts, the
``n_routed_experts`` experts held here and the shared expert, SwiGLUs of
``moe_intermediate_size``; an untied head over ``vocab_size``.

FLOPs are model FLOPs: 2 a matrix parameter a token passes through.
Every token passes through each layer's MLA matrices (``wdq``, ``wuq``,
``wdkv``, ``wkr``, ``wuk``, ``wuv``, ``wo``: the non-absorbed form, in
which each key's per-head key and value are lifted from its latent once),
the dense layers' SwiGLU, the router, the shared expert and, at the
expectation, ``num_experts_per_tok * n_routed_experts / (n_routed_experts
* ep_size)`` held experts (8 x 8 / 256 = 0.25 of an expert: this chip
computes its experts' part of every token it serves); and the head only
where its logits are used (every decoded token, a prompt's last
position).  Against each key it sees (itself and every earlier position)
a query takes ``2 (nope + rope) + 2 v`` FLOPs a head a layer, the
published mathematics' scores and weighted values.  Norms, rotary,
softmax, the gate's sort and the embedding lookup are left out.

Bytes of a decode step's expert layers (``expert_bytes``): the held and
shared experts' weights and the router, each read once a layer, in the
weights' type.  Least time of a decode step's MLA (``mla_decode_seconds``):
the larger of its bytes (every MLA weight and norm -- the input norm,
the query's and the latent's -- read once a layer, the
live latent cache, ``kv_lora_rank + qk_rope_head_dim`` elements a key a
layer, read once, and each row's new entry written once) at 3.35e12 B/s,
and the absorbed form's FLOPs (2 a MLA matrix parameter a row, and a key
``2 (kv_lora + rope) + 2 kv_lora`` a head a layer: scores and weighted
values on the latent side) at the dense bf16 peak.

Peaks as ``cabench.roofline.lm`` has them: 989.4e12 FLOP/s, 3.35e12 B/s.
"""
from __future__ import annotations

from typing import Dict

from cabench.roofline import HBM_BYTES_PER_S
from cabench.roofline.lm import BYTES, PEAK_BF16_FLOPS  # noqa: F401


def _w(w: Dict):
    return (w["hidden_size"], w["num_attention_heads"], w["q_lora_rank"],
            w["kv_lora_rank"], w["qk_rope_head_dim"], w["qk_nope_head_dim"],
            w["v_head_dim"])


def mla_params(w: Dict) -> int:
    """Matrix parameters of one layer's MLA."""
    d, h, ql, kvl, rope, nope, vd = _w(w)
    return (d * ql + ql * h * (nope + rope) + d * kvl + d * rope
            + kvl * h * (nope + vd) + h * vd * d)


def expert_params(w: Dict) -> int:
    """Matrix parameters of one routed expert (SwiGLU)."""
    return 3 * w["hidden_size"] * w["moe_intermediate_size"]


def router_experts(w: Dict) -> int:
    return w["n_routed_experts"] * w["ep_size"]


def layer_counts(w: Dict):
    n, nd = w["num_hidden_layers"], w["first_k_dense_replace"]
    return nd, n - nd


def token_params(w: Dict) -> float:
    """Matrix parameters a token passes through in the body, the routed
    experts at their expectation."""
    nd, nm = layer_counts(w)
    d = w["hidden_size"]
    routed = w["num_experts_per_tok"] * w["n_routed_experts"] \
        / router_experts(w)
    moe = (d * router_experts(w)
           + (w["n_shared_experts"] + routed) * expert_params(w))
    return (nd + nm) * mla_params(w) \
        + nd * 3 * d * w["intermediate_size"] + nm * moe


def head_params(w: Dict) -> int:
    return w["hidden_size"] * w["vocab_size"]


def attention_flops(w: Dict, keys: int) -> int:
    """FLOPs of every layer's attention of queries that see ``keys`` keys
    in all, in the published (non-absorbed) form."""
    _, h, _, _, rope, nope, vd = _w(w)
    return (2 * (nope + rope) + 2 * vd) * h * w["num_hidden_layers"] * keys


def flops(w: Dict, *, prompts: int, prompt_tokens: int, prompt_keys: int,
          decode_rows: int, decode_keys: int) -> float:
    """Model FLOPs of ``prompts`` prefills of ``prompt_tokens`` tokens in
    all, whose causal attention sees ``prompt_keys`` keys in all, and of
    ``decode_rows`` decoded tokens that see ``decode_keys`` keys."""
    return (2 * token_params(w) * (prompt_tokens + decode_rows)
            + 2 * head_params(w) * (prompts + decode_rows)
            + attention_flops(w, prompt_keys + decode_keys))


def expert_bytes(w: Dict) -> int:
    """Bytes of one decode step's expert layers: the held and shared
    experts' weights and the router, read once a layer."""
    _, nm = layer_counts(w)
    d = w["hidden_size"]
    per = ((w["n_routed_experts"] + w["n_shared_experts"])
           * expert_params(w) + d * router_experts(w))
    return nm * per * BYTES[w["dtype"]]


def expert_seconds(w: Dict, steps: int) -> float:
    """Least seconds of ``steps`` decode steps' expert layers: their
    weights' bytes over HBM."""
    return steps * expert_bytes(w) / HBM_BYTES_PER_S


def mla_decode_seconds(w: Dict, *, steps: int, rows: int, keys: int
                       ) -> float:
    """Least seconds of ``steps`` decode steps' MLA, with ``rows`` live
    rows in all that see ``keys`` keys in all (a row at position p: p +
    1): the larger of the bytes at HBM and the absorbed FLOPs at peak."""
    d, h, ql, kvl, rope, _, _ = _w(w)
    n = w["num_hidden_layers"]
    latent = (kvl + rope) * BYTES[w["cache_dtype"]]
    weights = mla_params(w) * BYTES[w["dtype"]] \
        + (d + ql + kvl) * BYTES[w["dtype"]]
    n_bytes = n * (steps * weights + keys * latent + rows * latent)
    n_flops = n * (2 * mla_params(w) * rows
                   + (2 * (kvl + rope) + 2 * kvl) * h * keys)
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / PEAK_BF16_FLOPS)
