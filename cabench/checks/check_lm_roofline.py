"""The LM counts of ``cabench.roofline.lm``, by hand."""
from __future__ import annotations

import json

import pytest

from cabench import harness
from cabench.roofline import lm

SMOKE = {"n_layers": 4, "d_model": 128, "n_heads": 8, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 256, "vocab": 512, "dtype": "bfloat16",
         "cache_dtype": "bfloat16"}


def test_smoke_counts_by_hand():
    # A layer: q and o 128 x 8 x 16 = 16,384 each, k and v 128 x 2 x 16 =
    # 4,096 each, gate, up and down 128 x 256 = 32,768 each.
    assert lm.matrix_params(SMOKE) == (4 * (2 * 16384 + 2 * 4096
                                            + 3 * 32768), 128 * 512)
    # One 5-token prompt (keys 1 + ... + 5 = 15) and 3 decoded tokens at
    # positions 5, 6, 7 (keys 6 + 7 + 8 = 21): 8 tokens through the body,
    # 4 through the head, 36 keys at 4 x 8 x 16 x 4 FLOPs a key.
    want = 2 * 557056 * 8 + 2 * 65536 * 4 + 4 * 8 * 16 * 4 * 36
    assert want == 9510912
    assert lm.flops(SMOKE, prompts=1, prompt_tokens=5, prompt_keys=15,
                    decode_rows=3, decode_keys=21) == want
    # Two decode steps of 2 rows seeing 30 keys: the weights and norms
    # (9 x 128) twice, 4 embedding rows and 4 logits rows, 30 positions
    # of K and V (2 x 4 x 2 x 16 elements), all of 2 bytes.
    by_hand = 2 * (2 * (557056 + 65536 + 9 * 128) + 4 * (128 + 512)
                   + 30 * 2 * 4 * 2 * 16)
    assert lm.decode_bytes(SMOKE, steps=2, rows=4, keys=30) == by_hand
    assert lm.decode_seconds(SMOKE, steps=2, rows=4, keys=30) == \
        pytest.approx(by_hand / 3.35e12, rel=1e-12)


def test_the_cells_published_counts():
    bench = harness.load_benchmark()
    cfg = next(c for c in bench["configs"]
               if c["name"] == "internlm2-20b-bf16-32x2560")
    w = json.loads((harness.ROOT / cfg["file"]).read_text())
    body, head = lm.matrix_params(w)
    # 2 x the matrices a decoded token passes through: 3.86e10; with the
    # embedding table and the 97 norms, the model's 19,861,149,696.
    assert 2 * (body + head) == 38583926784
    assert body + 2 * head + 97 * 6144 == 19861149696
    # A decode step's weights and norms alone: 11.52 ms at 3.35 TB/s.
    assert lm.decode_seconds(w, steps=1, rows=0, keys=0) == pytest.approx(
        2 * (body + head + 97 * 6144) / 3.35e12)
    assert lm.PEAK_BF16_FLOPS == 989.4e12
