"""Closed loop of chat clients of the port's LM serve engine
(``repro_torch.serve.lm_engine.ServeEngine``) serving DeepSeek-V3 as one
chip of an expert-parallel deployment.

The traffic is ``lm_serve``'s (``Traffic``: lengths in strata of
``stratum``, ids uniform over the vocabulary, greedy decoding with
``eos`` -1), and so are the engine step and its spans (``_step``:
``lm.step``, or ``lm.step.prefill`` where it prefilled), the window (set-up
fills every slot and runs ``warmup_steps`` steps; the window steps the
engine until ``--seconds`` have passed and ends on a synchronise),
``tokens_per_s`` and ``mfu`` (over ``roofline.lm_mla_moe.flops``).

The configuration file holds every number of the published config.json
under its own key; the program's model is its registered ``arch``
(``deepseek-v3``) with the file's depth (``num_hidden_layers``: the first
dense layers and the MoE layers after them), no MTP module, and the
expert share ``[ep_rank * n, (ep_rank + 1) * n)`` of ``n =
n_routed_experts`` experts (``ep_size`` chips share a layer's experts;
the router keeps ``n * ep_size``).  Any other published value that
differs from the registered model (or, for the CPU checks, its smoke
twin) is refused.  The weights are drawn on the device from the seed,
one call a leaf, in the configuration's ``dtype`` (matrices with
``init_std``, norm gains about 1 with ``norm_std``, the gate's
correction bias with ``gate_bias_std``), by the reference's names
(``reference.lm_mla_moe.shapes``), and given to the program in its tree,
which must be the program's own.

``correct``: the checked requests are chosen at admission, from the
seed, among the candidates: requests whose finish step falls in the
window's first ``check_steps`` steps (counted from the window's start,
whether or not the window holds that many).  No end token ends a request early,
so a request of n new tokens admitted in step s finishes in step s + n -
2 (its prefill gives its first token, step s's decode its second).  They are the
``pick``-th candidate admitted (``pick`` drawn from the seed below
``check_first``), the candidate with the longest prompt plus answer and
the one with the most new tokens (the first admitted of equals).  Only
their logits are recorded (``Recorder``: at most ``BUFFERS`` buffers of
``new_tokens[1] + 1`` rows), copied on the device as the engine calls
``prefill`` and ``decode_step``.  The roles are fixed when the window
ends; where a chosen request is still running, the check steps the
engine on, untimed and untraced, until each has finished or the
``check_steps``-th step has passed.  Then the engine is freed and
``reference.lm_mla_moe`` (plain float32, TF32 off) runs over each
checked request's prompt and tokens, teacher forced, and is compared as
the chat cell's driver compares: ``served_gap``,
``prefill_logits_err``, ``decode_logits_err`` (the median over a
request's decode positions, the largest over the requests) against the
configuration's ``limits``; ``requests_short`` and
``requests_unchecked`` (chosen requests that had not finished by the
``check_steps``-th step) against 0.

Hooks: ``model_cfg``, ``prefill`` and ``decode_step``, as ``lm_serve``'s
(the controls and faults of ``cabench/control_lm_mla_moe.py``).
"""
from __future__ import annotations

import dataclasses
import resource
import sys
import time

import numpy as np
import torch

from cabench.drivers.lm_serve import Traffic, _restore, _step, _sync
from cabench.reference import lm_mla_moe as reference
from cabench.roofline import lm_mla_moe as roofline

# The published config.json's keys: each is compared with the registered
# model, except those that state the cut and the deployment.
PUBLISHED = ("attention_bias", "ep_size", "first_k_dense_replace",
             "hidden_act", "hidden_size", "intermediate_size",
             "kv_lora_rank", "max_position_embeddings", "model_type",
             "moe_intermediate_size", "moe_layer_freq", "n_group",
             "n_routed_experts", "n_shared_experts", "norm_topk_prob",
             "num_attention_heads", "num_experts_per_tok",
             "num_hidden_layers", "num_key_value_heads",
             "num_nextn_predict_layers", "q_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "rms_norm_eps", "rope_scaling",
             "rope_theta", "routed_scaling_factor", "scoring_func",
             "tie_word_embeddings", "topk_group", "topk_method",
             "v_head_dim", "vocab_size")
CONFIG_KEYS = ("arch",) + PUBLISHED + (
    "ep_rank", "deployment", "dtype", "cache_dtype", "slots", "max_len",
    "init_std", "norm_std", "gate_bias_std", "limits")
TRAFFIC_KEYS = ("clients", "prompt_len", "new_tokens", "eos", "stratum",
                "warmup_steps", "check_first", "check_steps")
LIMITS = ("served_gap", "prefill_logits_err", "decode_logits_err")
NORMS = ("n1", "n2", "qn", "kvn", "final_norm")
BUFFERS = 4
ROLES = ("drawn", "longest", "most_new")


def _refuse(msg: str):
    from cabench.harness import BenchError
    raise BenchError(msg)


def published(r) -> dict:
    """The config.json values of registered model ``r`` (a
    ``repro_torch`` ``ModelCfg`` of the published gate and YaRN), less the
    depth, the experts held and the MTP module, which the cut sets."""
    m, e, y = r.mla, r.moe, r.mla.yarn
    return {"attention_bias": r.qkv_bias, "hidden_act": "silu",
            "first_k_dense_replace": e.first_dense,
            "hidden_size": r.d_model, "intermediate_size": r.d_ff,
            "kv_lora_rank": m.kv_lora, "model_type": "deepseek_v3",
            "moe_intermediate_size": e.d_ff_expert, "moe_layer_freq": 1,
            "n_group": e.n_groups, "n_shared_experts": e.n_shared,
            "norm_topk_prob": True, "num_attention_heads": r.n_heads,
            "num_experts_per_tok": e.top_k, "num_key_value_heads":
            r.n_kv_heads, "q_lora_rank": m.q_lora,
            "qk_nope_head_dim": m.nope_dim, "qk_rope_head_dim": m.rope_dim,
            "rms_norm_eps": r.norm_eps,
            "rope_scaling": {"beta_fast": y.beta_fast,
                             "beta_slow": y.beta_slow, "factor": y.factor,
                             "mscale": y.mscale,
                             "mscale_all_dim": y.mscale_all_dim,
                             "original_max_position_embeddings":
                                 y.original_max_pos, "type": "yarn"},
            "rope_theta": r.rope_theta,
            "routed_scaling_factor": e.route_scale,
            "scoring_func": "sigmoid", "tie_word_embeddings":
            r.tie_embeddings, "topk_group": e.topk_groups,
            "topk_method": "noaux_tc", "v_head_dim": m.v_dim,
            "vocab_size": r.vocab}


def model_cfg(config: dict):
    """The program's model configuration of ``config``."""
    from repro_torch.configs import get_config, get_smoke
    arch = config["arch"]
    try:
        from repro_torch.models import GroupGateMoECfg, YarnMLACfg
        regs = [get_config(arch), get_smoke(arch)]
    except (ImportError, KeyError) as err:
        _refuse(f"the program has no published {arch!r}: {err!r}")
    regs = [r for r in regs if isinstance(r.moe, GroupGateMoECfg)
            and isinstance(r.mla, YarnMLACfg)]
    differ = [{k: (config[k], v) for k, v in published(r).items()
               if config[k] != v} for r in regs]
    match = [r for r, d in zip(regs, differ) if not d]
    if not match:
        _refuse(f"the configuration's published values are not those of "
                f"the program's registered {arch!r} (nor its smoke twin): "
                f"{differ}")
    reg = match[0]
    n, ep, rank = (config["n_routed_experts"], config["ep_size"],
                   config["ep_rank"])
    if n * ep != reg.moe.n_experts or not 0 <= rank < ep:
        _refuse(f"{n} experts on each of {ep} chips (rank {rank}) are not "
                f"the router's {reg.moe.n_experts}")
    depth = config["num_hidden_layers"]
    if not reg.moe.first_dense < depth <= reg.n_layers:
        _refuse(f"{depth} layers: not the {reg.moe.first_dense} dense ones "
                f"and some of the MoE layers of {reg.n_layers}")
    if config["num_nextn_predict_layers"]:
        _refuse("the engine serves the main model's logits: hold no MTP")
    if config["max_len"] > config["max_position_embeddings"]:
        _refuse(f"max_len {config['max_len']} exceeds the model's positions")
    if not isinstance(config["deployment"], dict):
        _refuse("the configuration states no deployment")
    return dataclasses.replace(
        reg, n_layers=depth, mtp=False, dtype=config["dtype"],
        moe=dataclasses.replace(reg.moe, held=n, first_expert=rank * n))


def draw_weights(config: dict, seed: int, device) -> dict:
    """The model's weights by the reference's names, drawn on ``device``
    from ``seed`` in the configuration's ``dtype``, one call a leaf."""
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    out = {}
    for name, shape in reference.shapes(config).items():
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        std = ("norm_std" if name in NORMS else
               "gate_bias_std" if name == "bias" else "init_std")
        out[name] = t.mul_(config[std])
    return out


def program_tree(wt: dict, config: dict) -> dict:
    """The same tensors in the program's parameter tree (views: the dense
    prefix's layers and the MoE layers of each stacked leaf)."""
    nd = config["first_k_dense_replace"]
    attn = ("wdq", "qn", "wuq", "wdkv", "kvn", "wkr", "wuk", "wuv", "wo")

    def block(sl, ffn):
        return {"n1": {"w": wt["n1"][sl]}, "n2": {"w": wt["n2"][sl]},
                "attn": {k: wt[k][sl] for k in attn}, "ffn": ffn}

    return {"embed": wt["embed"], "head": wt["head"],
            "final_norm": {"w": wt["final_norm"]},
            "prefix": block(slice(0, nd),
                            {k: wt[k] for k in ("wg", "wu", "wd")}),
            "layers": {"0_e": block(slice(nd, None), {
                "router": wt["router"], "bias": wt["bias"],
                "wg": wt["ewg"], "wu": wt["ewu"], "wd": wt["ewd"],
                "shared": {"wg": wt["swg"], "wu": wt["swu"],
                           "wd": wt["swd"]}})}}


def _refuse_other_tree(tree, cfg, dtype) -> None:
    from repro_torch.models import lm
    meta, _ = lm.abstract_params(cfg, dtype)
    want = lm.tree_map(lambda t: (tuple(t.shape), t.dtype), meta)
    got = lm.tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
    if want != got:
        _refuse(f"the program's parameter tree {want} is not the drawn one "
                f"{got}")


class Recorder:
    """Wraps the engine's ``prefill`` and ``decode_step``: chooses the
    checked requests as they are admitted, keeps their logits rows in at
    most ``BUFFERS`` buffers (a request that loses every role frees its
    buffer), and counts the tokens, prompts and keys the entry points
    take.  ``lm_serve._step`` reads ``prefilled``, ``step_rows`` and
    ``step_keys``, and keeps a finished request's rows from ``rows``: here
    an empty last axis, since the rows live in ``bufs``."""

    def __init__(self, eng, tr: dict, vocab: int, dtype, device, pick: int,
                 first_step: int):
        self.eng, self.tr = eng, tr
        self.r = tr["new_tokens"][1] + 1
        self.bufs = torch.empty((BUFFERS, self.r, vocab), dtype=dtype,
                                device=device)
        self.rows = torch.empty((eng.bs, self.r, 0), dtype=dtype,
                                device=device)
        self.pick, self.first_step = pick, first_step
        self.closed = False             # the roles are fixed
        self.steps = 0                  # engine steps that decoded
        self.pending: list = []         # requests this step admits
        self.candidates = 0
        self.role = dict.fromkeys(ROLES)    # role -> request
        self.buf_of: dict = {}              # id(request) -> buffer
        self.prefilled: list = []
        self.c = dict.fromkeys(("prompts", "prompt_tokens", "prompt_keys",
                                "decode_rows", "decode_keys"), 0)
        self.step_rows = self.step_keys = 0

    def chosen(self) -> list:
        """The requests holding a role, each once, in admission order."""
        reqs = {id(r): r for r in self.role.values() if r is not None}
        return sorted(reqs.values(), key=lambda r: r.rid)

    def _admit(self, req) -> int:
        """The buffer of ``req`` if it takes a role, else -1."""
        finish = self.steps + req.max_new - 2
        if self.closed or not (self.first_step <= finish
                < self.first_step + self.tr["check_steps"]):
            return -1
        k = self.candidates
        self.candidates += 1
        size = (len(req.prompt) + req.max_new, req.max_new)
        better = {"drawn": k == self.pick,
                  "longest": self.role["longest"] is None or size[0] > len(
                      self.role["longest"].prompt)
                  + self.role["longest"].max_new,
                  "most_new": self.role["most_new"] is None
                  or size[1] > self.role["most_new"].max_new}
        taken = [role for role in ROLES if better[role]]
        if not taken:
            return -1
        for role in taken:
            self.role[role] = req
        held = {id(r) for r in self.role.values() if r is not None}
        for rid in [i for i in self.buf_of if i not in held]:
            del self.buf_of[rid]
        free = sorted(set(range(BUFFERS)) - set(self.buf_of.values()))
        self.buf_of[id(req)] = free[0]
        return free[0]

    def prefill(self, inner):
        def call(params, cfg, batch, *a, **kw):
            last, cache = inner(params, cfg, batch, *a, **kw)
            req = self.pending.pop(0)
            slot = self.eng.slots.index(None)
            buf = self._admit(req)
            if buf >= 0:
                self.bufs[buf, 0].copy_(last[0])
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
            src, dst = [], []
            for i in live:
                buf = self.buf_of.get(id(eng.slots[i]))
                if buf is not None:
                    src.append(i)
                    dst.append(buf * self.r + len(eng.slots[i].out))
            if src:
                dev = logits.device
                self.bufs.view(-1, self.bufs.shape[-1]).index_copy_(
                    0, torch.as_tensor(dst, device=dev),
                    logits[torch.as_tensor(src, device=dev)])
            self.steps += 1
            self.step_rows = len(live)
            self.step_keys = int(sum(eng.pos[i] + 1 for i in live))
            self.c["decode_rows"] += self.step_rows
            self.c["decode_keys"] += self.step_keys
            return logits, cache
        return call


def step(run, st) -> None:
    """``lm_serve._step`` with the requests the step admits made known to
    the recorder first."""
    st["rec"].pending = list(st["eng"].queue)
    _step(run, st)


def setup(run):
    from repro_torch.serve import ServeEngine, lm_engine
    cfg, tr = run.config, run.traffic
    if tr["new_tokens"][0] < 3:
        _refuse("requests of fewer than 3 new tokens are not offered")
    if tr["stratum"] & (tr["stratum"] - 1):
        _refuse(f"stratum {tr['stratum']} is not a power of 2")
    if tr["prompt_len"][1] + tr["new_tokens"][1] > cfg["max_len"]:
        _refuse(f"a request of {tr['prompt_len'][1]} + "
                f"{tr['new_tokens'][1]} tokens outgrows max_len "
                f"{cfg['max_len']}")
    if tr["clients"] > cfg["slots"]:
        _refuse(f"{tr['clients']} clients for {cfg['slots']} slots")
    missing = set(LIMITS) - set(cfg["limits"])
    if missing:
        _refuse(f"the configuration states no limit for {sorted(missing)}")
    mcfg = run.hooks.get("model_cfg", lambda c: c)(model_cfg(cfg))
    wt = draw_weights(cfg, run.seed, run.device)
    tree = program_tree(wt, cfg)
    _refuse_other_tree(tree, mcfg, getattr(torch, cfg["dtype"]))
    eng = ServeEngine(tree, mcfg, batch_size=cfg["slots"],
                      max_len=cfg["max_len"],
                      cache_dtype=getattr(torch, cfg["cache_dtype"]),
                      greedy=True, device=run.device)
    pick = int(np.random.default_rng(run.seed % 2 ** 63 + 1)
               .integers(tr["check_first"]))
    rec = Recorder(eng, tr, cfg["vocab_size"], getattr(torch, cfg["dtype"]),
                   run.device, pick, tr["warmup_steps"])
    st = {"wt": wt, "eng": eng, "rec": rec, "inner": {},
          "traffic": Traffic(tr, cfg["vocab_size"], run.seed),
          "pick": pick, "kept": {}, "window": None}
    for name in ("prefill", "decode_step"):
        inner = st["inner"][name] = getattr(lm_engine, name)
        hook = run.hooks.get(name, lambda f: f)
        setattr(lm_engine, name, getattr(rec, name)(hook(inner)))
    try:
        for _ in range(tr["clients"]):
            eng.submit(st["traffic"].next())
        for _ in range(tr["warmup_steps"]):
            step(run, st)
        _sync(run.device)
    except BaseException:
        _restore(st)
        raise
    return st


def window(run, st):
    rec = st["rec"]
    c0 = dict(rec.c)
    st["window"] = dict.fromkeys(
        ("steps", "tokens", "finished", "short", "decode_only_steps",
         "decode_only_rows", "decode_only_keys"), 0)
    u0 = resource.getrusage(resource.RUSAGE_SELF)
    try:
        w0 = time.time()
        p0 = time.perf_counter()
        deadline = p0 + run.seconds
        while True:
            step(run, st)
            if time.perf_counter() >= deadline:
                break
        _sync(run.device)
        p1 = time.perf_counter()
    except BaseException:
        _restore(st)
        raise
    u1 = resource.getrusage(resource.RUSAGE_SELF)
    run.window_wall = (w0, w0 + (p1 - p0))
    run.window_s = p1 - p0
    w = st["window"]
    c = {k: rec.c[k] - c0[k] for k in rec.c}
    # The host's share of the window, to tell its speed from the work
    # where runs spread: CPU seconds in and out of the kernel, page faults.
    run.counters["host_user_s"] = u1.ru_utime - u0.ru_utime
    run.counters["host_sys_s"] = u1.ru_stime - u0.ru_stime
    run.counters["minor_faults"] = u1.ru_minflt - u0.ru_minflt
    flops = roofline.flops(run.config, **c)
    run.e2e["tokens_per_s"] = w["tokens"] / run.window_s
    run.e2e["mfu"] = 100.0 * flops / (run.window_s
                                      * roofline.PEAK_BF16_FLOPS)
    run.counters.update(c)
    run.counters.update({k: w[k] for k in w if k != "short"})
    run.counters["flops"] = flops
    run.counters["candidates"] = rec.candidates
    decode = [t - s for name, s, t in run.spans.records if name == "lm.step"]
    run.counters["decode_step_ms_median"] = (
        1e3 * float(np.median(decode)) if decode else 0.0)
    run.counters["decode_step_ms_q1_q3"] = (
        [1e3 * float(q) for q in np.percentile(decode, [25, 75])]
        if decode else [])
    run.counters["prefill_steps_s"] = sum(
        t - s for name, s, t in run.spans.records
        if name == "lm.step.prefill")
    run.attempted = w["finished"]


def drain(run, st) -> None:
    """Step the engine on, after the window and outside it, until every
    chosen request has finished or the ``check_steps``-th step of the
    window has passed; the recorder takes no new role."""
    rec = st["rec"]
    rec.closed = True
    st["window"] = None
    last = rec.first_step + run.traffic["check_steps"]
    try:
        while (rec.steps < last
               and not all(r.done for r in rec.chosen())):
            step(run, st)
    finally:
        _restore(st)


def check(run, st):
    cfg, w, rec = run.config, st["window"], st["rec"]
    drain(run, st)
    chosen = rec.chosen()
    done = [r for r in chosen if r.done]
    rows = {id(r): rec.bufs[rec.buf_of[id(r)], :len(r.out)] for r in done}
    rec.eng = None
    del st["eng"]
    run.check("requests_short", w["short"], 0)
    run.check("requests_unchecked",
              len(chosen) - len(done) + int(not chosen), 0)
    seqs = [np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
            for r in done]
    refs = reference.logits(st["wt"], cfg, seqs,
                            [len(r.prompt) - 1 for r in done])
    gap = pre = dec = 0.0
    for req, ref in zip(done, refs):
        got = rows[id(req)].to(torch.float32)
        err = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).cpu()
        out = torch.as_tensor(req.out, device=ref.device).long()
        gaps = ref.amax(-1) - ref.gather(-1, out[:, None])[:, 0]
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        med = float(err[1:].median())   # every request has 3+ tokens
        gap = max(gap, float(gaps.max()))
        pre = max(pre, float(err[0]))
        dec = max(dec, med)
        roles = [k for k, v in rec.role.items() if v is req]
        print(f"cabench: request {req.rid} ({', '.join(roles)}): prompt "
              f"{len(req.prompt)}, {len(req.out)} tokens; gap max "
              f"{float(gaps.max()):.6g}; relative L2 error prefill "
              f"{float(err[0]):.6g}, decode median {med:.6g} max "
              f"{float(err.max()):.6g}; argmax agrees at {agree} of "
              f"{len(err)}", file=sys.stderr, flush=True)
    limits = cfg["limits"]
    run.check("served_gap", gap, limits["served_gap"])
    run.check("prefill_logits_err", pre, limits["prefill_logits_err"])
    run.check("decode_logits_err", dec, limits["decode_logits_err"])
