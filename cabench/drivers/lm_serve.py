"""Closed loop of chat clients of the port's LM serve engine
(``repro_torch.serve.lm_engine.ServeEngine``).

Each of ``clients`` clients has one request in flight and submits its
next when one finishes.  A request's prompt length is log-uniform over
``prompt_len`` and its new tokens uniform over ``new_tokens``, drawn in
strata: every ``stratum`` requests in turn, in order of submission, take
the ``stratum`` quantiles of each distribution, each list in a
bit-reversed order scrambled by the seed (``Traffic._order``).  So every
seed offers the same lengths in another order, and a run of consecutive
requests, such as those a window admits, takes nearly the same lengths
whatever the seed (with the order free, the window's model FLOPs spread
by 10% from seed to seed).  Token ids are uniform over the vocabulary; decoding is greedy
with ``eos`` (-1: none), so a request runs to its ``new_tokens``.

The weights are drawn on the device from the seed, one call a leaf, in
the configuration's ``dtype`` (matrices with ``init_std``, the norms'
gains about 1 with ``norm_std``), by the reference's names and shapes
(``reference.lm_dense.shapes``); the program gets them in its tree.  The
model configuration is the program's registered ``arch`` with the
configuration's widths, and is refused where those differ from the
registered ones (or, for the CPU checks, its smoke ones), or where the
registered model has a part the reference does not compute.

Set-up fills every slot and runs ``warmup_steps`` engine steps.  The
window then steps the engine until ``--seconds`` have passed and ends on
a synchronise.  Each step is one benchmark span, ``lm.step``, or
``lm.step.prefill`` where it prefilled.  The median decode-only step and
the prefilling steps' time are kept as counters beside the counts, to
tell the host's speed from the window's work where runs spread.

``tokens_per_s``: tokens produced in the window (each decode step's live
rows, each prefill's first token) over the window.  ``mfu``: the
window's model FLOPs (``roofline.lm.flops``, from the widths and the
positions of the tokens) over the window at the H100's dense bf16 peak.

``correct``: the program's logits are recorded, as the engine calls
``prefill`` and ``decode_step``, for every slot's current request (each
row copied on the device, no synchronise); when a request finishes, its
rows are kept if it is one of the checked: the one that finished k-th in
the window (k drawn from the seed below ``check_first``), the one with
the most tokens among those that finished in the window, and the last to
finish.  After the window and the engine are freed, the float32
reference runs over each checked request's prompt and tokens, teacher
forced, and is compared at every position the engine produced a token
from:

* ``served_gap``: the widest gap by which a served token's reference
  logit lies below the reference's best at its position;
* ``prefill_logits_err``: the relative L2 error of the prefill's logits
  (the prompt's last position), the largest over the checked requests;
* ``decode_logits_err``: the median over a request's decode positions of
  the relative L2 error of the logits, the largest over the requests;
  the median, since one position's error swings with the chaos of 48
  random layers while every fault of the cache moves them all;
* ``requests_short``: requests finished in the window with fewer than
  their new tokens;
* ``requests_unchecked``: 1 where no request finished in the window.

Each is held to the configuration's ``limits`` (0 for the counts).
``attempted`` counts the requests finished in the window; ``failed`` is
0, since a request that raises ends the run.

Hooks: ``model_cfg`` (a function of the program's model configuration),
``prefill`` and ``decode_step`` (each a function of the program's entry
point that returns the one the engine calls): the controls and faults of
``cabench/control_lm.py``.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from cabench.reference import lm_dense
from cabench.roofline import lm as lm_roofline

WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "rope_theta", "norm_eps")
CONFIG_KEYS = ("arch",) + WIDTHS + ("dtype", "cache_dtype", "slots",
                                    "max_len", "init_std", "norm_std",
                                    "limits")
TRAFFIC_KEYS = ("clients", "prompt_len", "new_tokens", "eos", "stratum",
                "warmup_steps", "check_first")
LIMITS = ("served_gap", "prefill_logits_err", "decode_logits_err")
NORMS = ("n1", "n2", "final_norm")
# Parts of the program's model configuration that the reference computes
# in one way only: a registered model with any other value is refused.
PLAIN = {"family": "dense", "layer_pattern": ("a",), "qkv_bias": False,
         "qk_norm": False, "rope_frac": 1.0, "attn_softcap": 0.0,
         "logit_softcap": 0.0, "local_window": 0, "post_norms": False,
         "norm": "rms", "tie_embeddings": False, "embed_scale": False,
         "moe": None, "mla": None, "ssm": None, "shared_attn_period": 0,
         "enc_layers": 0, "pad_heads": 0, "mtp": False}


def _refuse(msg: str):
    from cabench.harness import BenchError
    raise BenchError(msg)


def model_cfg(config: dict):
    """The program's model configuration of ``config``."""
    from repro_torch.configs import get_config, get_smoke
    arch = config["arch"]
    got = {k: config[k] for k in WIDTHS}
    regs = [get_config(arch), get_smoke(arch)]
    if not any(all(getattr(r, k) == v for k, v in got.items())
               for r in regs):
        _refuse(f"the configuration's widths {got} are not the program's "
                f"registered {arch!r} (nor its smoke widths)")
    cfg = dataclasses.replace(regs[0], **got, dtype=config["dtype"])
    bad = {k: getattr(cfg, k) for k, v in PLAIN.items()
           if getattr(cfg, k) != v}
    if bad:
        _refuse(f"{arch!r} has parts the reference does not compute: {bad}")
    return cfg


def draw_weights(config: dict, seed: int, device) -> dict:
    """The model's weights by the reference's names, drawn on ``device``
    from ``seed`` in the configuration's ``dtype``, one call a leaf."""
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    out = {}
    for name, shape in lm_dense.shapes(config).items():
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        out[name] = t.mul_(config["norm_std" if name in NORMS
                                  else "init_std"])
    return out


def program_tree(wt: dict) -> dict:
    """The same tensors in the program's parameter tree."""
    return {"embed": wt["embed"], "head": wt["head"],
            "final_norm": {"w": wt["final_norm"]},
            "layers": {"0_a": {
                "n1": {"w": wt["n1"]}, "n2": {"w": wt["n2"]},
                "attn": {k: wt[k] for k in ("wq", "wk", "wv", "wo")},
                "ffn": {k: wt[k] for k in ("wg", "wu", "wd")}}}}


def _refuse_other_tree(tree, cfg, dtype) -> None:
    """Refuse where the program's own tree for ``cfg`` differs from ours
    in its leaves, shapes or types."""
    from repro_torch.models import lm
    meta, _ = lm.abstract_params(cfg, dtype)
    want = lm.tree_map(lambda t: (tuple(t.shape), t.dtype), meta)
    got = lm.tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
    if want != got:
        _refuse(f"the program's parameter tree {want} is not the drawn one "
                f"{got}")


class Traffic:
    """The requests in order of submission, from the seed."""

    def __init__(self, tr: dict, vocab: int, seed: int):
        self.tr, self.vocab = tr, vocab
        self.rng = np.random.default_rng(seed % 2 ** 63)
        self.lengths: list = []
        self.n = 0

    def _order(self, n: int) -> np.ndarray:
        """Quantile indices 0 .. n - 1 (n a power of 2) in bit-reversed
        order, XOR a mask drawn from the seed: every aligned run of 2^k
        consecutive requests takes one quantile of each of the 2^k equal
        groups of them."""
        bits = n.bit_length() - 1
        rev = [int(f"{p:0{bits}b}"[::-1], 2) if bits else 0
               for p in range(n)]
        return np.asarray(rev) ^ int(self.rng.integers(n))

    def _stratum(self):
        n = self.tr["stratum"]
        q = (np.arange(n) + 0.5) / n
        lo, hi = np.log(self.tr["prompt_len"])
        plen = np.rint(np.exp(lo + q * (hi - lo))).astype(int)
        a, b = self.tr["new_tokens"]
        new = np.rint(a + q * (b - a)).astype(int)
        self.lengths = list(zip(plen[self._order(n)],
                                new[self._order(n)]))[::-1]

    def next(self):
        from repro_torch.serve import Request
        if not self.lengths:
            self._stratum()
        plen, new = self.lengths.pop()
        prompt = self.rng.integers(0, self.vocab, int(plen), dtype=np.int64)
        self.n += 1
        return Request(rid=self.n - 1, prompt=prompt.astype(np.int32),
                       max_new=int(new), eos=self.tr["eos"])


class Recorder:
    """Wraps the engine's ``prefill`` and ``decode_step``: copies every
    slot's logits row into ``rows[slot, token index]`` on the device, and
    counts the tokens, prompts and keys they take."""

    def __init__(self, eng, rows_per_slot: int, vocab: int, dtype, device):
        self.eng, self.r = eng, rows_per_slot
        self.rows = torch.empty((eng.bs, rows_per_slot, vocab), dtype=dtype,
                                device=device)
        self.prefilled: list = []       # slots prefilled in this step
        self.c = dict.fromkeys(("prompts", "prompt_tokens", "prompt_keys",
                                "decode_rows", "decode_keys"), 0)
        self.step_rows = self.step_keys = 0

    def prefill(self, inner):
        def call(params, cfg, batch, *a, **kw):
            last, cache = inner(params, cfg, batch, *a, **kw)
            slot = self.eng.slots.index(None)
            self.rows[slot, 0].copy_(last[0])
            self.prefilled.append(slot)
            s = int(batch["tokens"].shape[1])
            self.c["prompts"] += 1
            self.c["prompt_tokens"] += s
            self.c["prompt_keys"] += s * (s + 1) // 2
            return last, cache
        return call

    def decode_step(self, inner):
        def call(params, cfg, cache, token, pos):
            logits, cache = inner(params, cfg, cache, token, pos)
            eng = self.eng
            live = [i for i, s in enumerate(eng.slots) if s is not None]
            at = [i * self.r + (len(s.out) if s is not None else self.r - 1)
                  for i, s in enumerate(eng.slots)]
            self.rows.view(-1, self.rows.shape[-1]).index_copy_(
                0, torch.as_tensor(at, device=logits.device), logits)
            self.step_rows = len(live)
            self.step_keys = int(sum(eng.pos[i] + 1 for i in live))
            self.c["decode_rows"] += self.step_rows
            self.c["decode_keys"] += self.step_keys
            return logits, cache
        return call


def setup(run):
    from repro_torch.serve import ServeEngine, lm_engine
    cfg, tr = run.config, run.traffic
    if tr["new_tokens"][0] < 3:
        # A request then never finishes in the step that admits it (its
        # prefill and one decode give it two tokens).
        _refuse("requests of fewer than 3 new tokens are not offered")
    if tr["stratum"] & (tr["stratum"] - 1):
        _refuse(f"stratum {tr['stratum']} is not a power of 2")
    if tr["prompt_len"][1] + tr["new_tokens"][1] > cfg["max_len"]:
        _refuse(f"a request of {tr['prompt_len'][1]} + "
                f"{tr['new_tokens'][1]} tokens outgrows max_len "
                f"{cfg['max_len']}")
    missing = set(LIMITS) - set(cfg["limits"])
    if missing:
        _refuse(f"the configuration states no limit for {sorted(missing)}")
    mcfg = model_cfg(cfg)
    mcfg = run.hooks.get("model_cfg", lambda c: c)(mcfg)
    wt = draw_weights(cfg, run.seed, run.device)
    tree = program_tree(wt)
    _refuse_other_tree(tree, mcfg, getattr(torch, cfg["dtype"]))
    eng = ServeEngine(tree, mcfg, batch_size=cfg["slots"],
                      max_len=cfg["max_len"],
                      cache_dtype=getattr(torch, cfg["cache_dtype"]),
                      greedy=True, device=run.device)
    rec = Recorder(eng, tr["new_tokens"][1] + 1, cfg["vocab"],
                   getattr(torch, cfg["dtype"]), run.device)
    st = {"wt": wt, "eng": eng, "rec": rec, "inner": {},
          "traffic": Traffic(tr, cfg["vocab"], run.seed),
          "pick": int(np.random.default_rng(run.seed % 2 ** 63 + 1)
                      .integers(tr["check_first"])),
          "kept": {}, "window": None}
    for name in ("prefill", "decode_step"):
        inner = st["inner"][name] = getattr(lm_engine, name)
        hook = run.hooks.get(name, lambda f: f)
        setattr(lm_engine, name, getattr(rec, name)(hook(inner)))
    try:
        for _ in range(tr["clients"]):
            eng.submit(st["traffic"].next())
        for _ in range(tr["warmup_steps"]):
            _step(run, st)
        _sync(run.device)
    except BaseException:
        _restore(st)
        raise
    return st


def _restore(st) -> None:
    from repro_torch.serve import lm_engine
    for name, inner in st["inner"].items():
        setattr(lm_engine, name, inner)
    st["inner"] = {}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _keep(st, req, slot: int) -> None:
    """Keep the rows of ``req``, which finished in ``slot``, where it is
    one of the checked requests of the window."""
    w = st["window"]
    w["finished"] += 1
    w["short"] += len(req.out) < req.max_new
    roles = {"last"}
    if w["finished"] - 1 == st["pick"]:
        roles.add("drawn")
    longest = st["kept"].get("longest")
    if longest is None or len(req.out) > len(longest[0].out):
        roles.add("longest")
    rows = st["rec"].rows[slot, :len(req.out)].clone()
    for role in roles:
        st["kept"][role] = (req, rows)


def _step(run, st) -> None:
    """One engine step; the finished requests' clients submit their next."""
    eng, rec = st["eng"], st["rec"]
    before = {id(s): i for i, s in enumerate(eng.slots) if s is not None}
    done0 = len(eng.finished)
    rec.prefilled = []
    rec.step_rows = rec.step_keys = 0
    t0 = time.time()
    live = eng.step()
    t1 = time.time()
    admitted = [i for i, s in enumerate(eng.slots)
                if s is not None and id(s) not in before]
    for req in eng.finished[done0:]:
        if st["window"] is not None:
            _keep(st, req, before[id(req)])
        eng.submit(st["traffic"].next())
    if sorted(admitted) != sorted(rec.prefilled):
        _refuse(f"slots prefilled {rec.prefilled} are not the slots "
                f"admitted {admitted}")
    w = st["window"]
    if w is not None:
        prefilled = bool(rec.prefilled)
        run.spans.records.append(
            ("lm.step.prefill" if prefilled else "lm.step", t0, t1))
        w["steps"] += 1
        w["tokens"] += live + len(rec.prefilled)
        if not prefilled:
            w["decode_only_steps"] += 1
            w["decode_only_rows"] += rec.step_rows
            w["decode_only_keys"] += rec.step_keys


def window(run, st):
    rec = st["rec"]
    c0 = dict(rec.c)
    st["window"] = dict.fromkeys(
        ("steps", "tokens", "finished", "short", "decode_only_steps",
         "decode_only_rows", "decode_only_keys"), 0)
    try:
        w0 = time.time()
        p0 = time.perf_counter()
        deadline = p0 + run.seconds
        while True:
            _step(run, st)
            if time.perf_counter() >= deadline:
                break
        _sync(run.device)
        p1 = time.perf_counter()
    finally:
        _restore(st)
    run.window_wall = (w0, w0 + (p1 - p0))
    run.window_s = p1 - p0
    w = st["window"]
    c = {k: rec.c[k] - c0[k] for k in rec.c}
    flops = lm_roofline.flops(run.config, **c)
    run.e2e["tokens_per_s"] = w["tokens"] / run.window_s
    run.e2e["mfu"] = 100.0 * flops / (run.window_s
                                      * lm_roofline.PEAK_BF16_FLOPS)
    run.counters.update(c)
    run.counters.update({k: w[k] for k in w if k != "short"})
    run.counters["flops"] = flops
    decode = [t - s for name, s, t in run.spans.records if name == "lm.step"]
    run.counters["decode_step_ms_median"] = (
        1e3 * float(np.median(decode)) if decode else 0.0)
    run.counters["prefill_steps_s"] = sum(
        t - s for name, s, t in run.spans.records
        if name == "lm.step.prefill")
    run.attempted = w["finished"]


def check(run, st):
    cfg, w = run.config, st["window"]
    kept = {id(req): (req, rows) for req, rows in st["kept"].values()}
    del st["eng"], st["rec"]
    run.check("requests_short", w["short"], 0)
    run.check("requests_unchecked", int(not kept), 0)
    reqs = sorted(kept.values(), key=lambda kr: kr[0].rid)
    seqs = [np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
            for r, _ in reqs]
    refs = lm_dense.logits(st["wt"], cfg, seqs,
                           [len(r.prompt) - 1 for r, _ in reqs])
    gap = pre = dec = 0.0
    for (req, rows), ref in zip(reqs, refs):
        got = rows.to(torch.float32)
        err = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).cpu()
        out = torch.as_tensor(req.out, device=ref.device).long()
        gaps = ref.amax(-1) - ref.gather(-1, out[:, None])[:, 0]
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        med = float(err[1:].median())   # every request has 3+ tokens
        gap = max(gap, float(gaps.max()))
        pre = max(pre, float(err[0]))
        dec = max(dec, med)
        print(f"cabench: request {req.rid}: prompt {len(req.prompt)}, "
              f"{len(req.out)} tokens; gap max {float(gaps.max()):.6g}; "
              f"relative L2 error prefill {float(err[0]):.6g}, decode "
              f"median {med:.6g} max {float(err.max()):.6g}; argmax agrees "
              f"at {agree} of {len(err)}", file=sys.stderr, flush=True)
    limits = cfg["limits"]
    run.check("served_gap", gap, limits["served_gap"])
    run.check("prefill_logits_err", pre, limits["prefill_logits_err"])
    run.check("decode_logits_err", dec, limits["decode_logits_err"])
