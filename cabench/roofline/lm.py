"""Frozen counts of a dense GQA decoder's work, from its configuration's
widths alone and never from the program: the yardstick of ``mfu`` and
``lm.decode_byte_roofline``.

The layer is InternLM2's (arXiv:2403.17297): RMSNorm, attention with
``n_heads`` query heads and ``n_kv_heads`` key/value heads of
``head_dim``, rotary, SwiGLU of ``d_ff``; an untied head over ``vocab``.

FLOPs are model FLOPs: the work the mathematics needs, whatever the
program runs.  A token passes through every matrix of every layer once,
2 FLOPs a parameter: q (D x H hd), k and v (D x KV hd each), o (H hd x
D), gate and up (D x F each), down (F x D); and through the head (D x V)
only where its logits are used: every decoded token, and a prompt's last
position.  Against ``c`` keys (itself and every earlier position) its
attention takes 4 H hd c a layer: 2 H hd c for the scores, 2 H hd c for
the weighted values.  Norms, rotary, softmax and the embedding lookup
are left out (under 0.1% of a token's FLOPs at these widths).  Source:
the forward third of the count in PaLM's appendix B (arXiv:2204.02311:
6N + 12 L H Q T a token in training), with the attention over the causal
context a token actually sees.

Bytes of a decode step: every matrix and norm weight read once, one
embedding row read a live row, each live row's earlier K and V read and
its new K and V written once (2 L KV hd elements a position, of the
cache's type), and the logits written once (a row of V).

Peaks (one H100 SXM5): dense BF16 tensor rate with FP32 accumulate
989.4e12 FLOP/s (NVIDIA H100 Tensor Core GPU Architecture whitepaper,
table of H100 SXM5 peaks, 989.4 without sparsity); HBM3 3.35e12 B/s, as
``cabench.roofline`` has it.
"""
from __future__ import annotations

from typing import Dict, Tuple

from cabench.roofline import HBM_BYTES_PER_S

PEAK_BF16_FLOPS = 989.4e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def matrix_params(w: Dict) -> Tuple[int, int]:
    """``(body, head)``: the matrix parameters of every layer together,
    and of the head."""
    d, hd = w["d_model"], w["head_dim"]
    attn = d * w["n_heads"] * hd * 2 + d * w["n_kv_heads"] * hd * 2
    return w["n_layers"] * (attn + 3 * d * w["d_ff"]), d * w["vocab"]


def attention_flops(w: Dict, keys: int) -> int:
    """FLOPs of every layer's attention of queries that see ``keys``
    keys in all (summed over the queries)."""
    return 4 * w["n_heads"] * w["head_dim"] * w["n_layers"] * keys


def flops(w: Dict, *, prompts: int, prompt_tokens: int, prompt_keys: int,
          decode_rows: int, decode_keys: int) -> int:
    """Model FLOPs of ``prompts`` prefills of ``prompt_tokens`` tokens in
    all, whose causal attention sees ``prompt_keys`` keys in all (a prompt
    of s tokens: s (s + 1) / 2), and of ``decode_rows`` decoded tokens
    that see ``decode_keys`` keys in all (a token at position p: p + 1)."""
    body, head = matrix_params(w)
    return (2 * body * (prompt_tokens + decode_rows)
            + 2 * head * (prompts + decode_rows)
            + attention_flops(w, prompt_keys + decode_keys))


def decode_bytes(w: Dict, *, steps: int, rows: int, keys: int) -> int:
    """Bytes that ``steps`` decode steps of ``rows`` live rows in all,
    seeing ``keys`` keys in all, need to move: weights in the type
    ``w["dtype"]`` names, the cache in ``w["cache_dtype"]``'s."""
    body, head = matrix_params(w)
    d, el = w["d_model"], BYTES[w["dtype"]]
    norms = (2 * w["n_layers"] + 1) * d
    kv = 2 * w["n_layers"] * w["n_kv_heads"] * w["head_dim"] \
        * BYTES[w["cache_dtype"]]
    return (steps * (body + head + norms) * el + rows * (d + w["vocab"]) * el
            + keys * kv)


def decode_seconds(w: Dict, *, steps: int, rows: int, keys: int) -> float:
    """Least seconds of those decode steps: their bytes over HBM (a decode
    step's FLOPs at 32 rows take about a tenth of that on the tensor
    cores, and overlap it)."""
    return decode_bytes(w, steps=steps, rows=rows, keys=keys) \
        / HBM_BYTES_PER_S
