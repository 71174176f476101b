"""Model assembly for the attention families: parameter init, forward,
prefill and per-row decode.

Layer heterogeneity is a repeating ``cfg.layer_pattern`` cycle of kinds
``a`` (global attention) and ``l`` (sliding-window attention); parameters
are stacked per pattern position (``params["layers"][f"{ci}_{kind}"]``,
each leaf with a leading ``(n_cycles,)`` dim, the reference's layout) and
the forward pass loops over the cycles.

Families ``moe``, ``ssm``, ``hybrid`` and ``encdec``, and MLA attention,
are not ported yet: every entry point refuses them with
``NotImplementedError`` naming the ROADMAP item that ports them.
Training (``loss_fn``) is ROADMAP item 11e.

The decode cache is updated in place: ``decode_step`` returns the cache
it was given.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.config import ModelCfg
from repro_torch.models.mlp import init_mlp, mlp_block

# Where each unported part of the reference's model zoo is queued.
UNPORTED = {"moe": "11b (experts and MLA)", "mla": "11b (experts and MLA)",
            "ssm": "11c (SSM and hybrid)", "hybrid": "11c (SSM and hybrid)",
            "encdec": "11d (encoder-decoder)"}
KINDS = ("a", "l")


def check_supported(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is an attention-family
    model (kinds ``a``/``l`` only, no MLA, experts, SSM or encoder)."""
    part = cfg.family if cfg.family in UNPORTED else None
    if part is None and cfg.mla:
        part = "mla"
    if part is None and (cfg.moe or cfg.ssm or cfg.enc_layers
                         or cfg.shared_attn_period or cfg.mtp
                         or set(cfg.cycle) - set(KINDS)):
        part = "moe" if cfg.moe else ("ssm" if cfg.ssm else "encdec")
    if part is not None:
        raise NotImplementedError(
            f"{cfg.name}: {part} is not ported to repro_torch yet (ROADMAP "
            f"§1 item {UNPORTED[part]}); the port runs the attention "
            f"families, layer kinds {KINDS}")


def layer(stack, i: int):
    """Layer ``i``'s parameters (views) from a stacked tree."""
    if isinstance(stack, dict):
        return {k: layer(v, i) for k, v in stack.items()}
    return stack[i]


def tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_block(init: cm.Init, cfg: ModelCfg, kind: str):
    """One layer's parameters; kind: a = attention, l = local attention."""
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  f"(the port runs kinds {KINDS})")
    d = cfg.d_model
    p: Dict[str, Any] = {"n1": cm.init_norm(init, d, cfg.norm)}
    p["attn"] = attn.init_attn(init, cfg)
    p["n2"] = cm.init_norm(init, d, cfg.norm)
    p["ffn"] = init_mlp(init, d, cfg.d_ff)
    if cfg.post_norms:
        p["pn1"] = cm.init_norm(init, d, cfg.norm)
        p["pn2"] = cm.init_norm(init, d, cfg.norm)
    return p


def block_apply(p, x, cfg: ModelCfg, kind: str, *, positions):
    """Pre-norm causal residual block."""
    h = cm.apply_norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    window = cfg.local_window if kind == "l" else 0
    a = attn.attn_block(p["attn"], h, cfg, positions=positions,
                        window=window)
    if cfg.post_norms:
        a = cm.apply_norm(a, p["pn1"], cfg.norm, cfg.norm_eps)
    x = x + a
    h = cm.apply_norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    f = mlp_block(p["ffn"], h)
    if cfg.post_norms:
        f = cm.apply_norm(f, p["pn2"], cfg.norm, cfg.norm_eps)
    return x + f


# ---------------------------------------------------------------------------
# Parameter init for the whole model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelCfg, seed: int = 0, *, device="cpu",
                dtype=torch.float32):
    """The model's parameters, drawn in ``dtype`` on ``device`` from one
    seeded generator (shapes and scales of the reference's init; the
    values are the port's own)."""
    cfg.validate()
    check_supported(cfg)
    root = cm.Init(seed, dtype, device)
    d = cfg.d_model
    tree: Dict[str, Any] = {"embed": root.normal((cfg.vocab, d))}
    tree["layers"] = {
        f"{ci}_{kind}": init_block(cm.StackedInit(root, cfg.n_cycles), cfg,
                                   kind)
        for ci, kind in enumerate(cfg.cycle)}
    tree["final_norm"] = cm.init_norm(root, d, cfg.norm)
    if not cfg.tie_embeddings:
        tree["head"] = root.normal((d, cfg.vocab))
    return tree


def param_numel(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    w = params["embed"]
    x = w.to(cm.cdtype(cfg))[torch.as_tensor(tokens).to(w.device,
                                                       torch.int64)]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _head(params, cfg, x):
    x = cm.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
    if cfg.logit_softcap:
        logits = cm.softcap(logits.to(torch.float32),
                            cfg.logit_softcap).to(x.dtype)
    # Logits stay in the compute dtype, as in the reference.
    return logits


def _stack(x, params, cfg, *, positions):
    """Apply the layer stack: cycles in order, each cycle's kinds in
    pattern order."""
    names = sorted(params["layers"])
    for i in range(cfg.n_cycles):
        for kind, name in zip(cfg.cycle, names):
            x = block_apply(layer(params["layers"][name], i), x, cfg, kind,
                            positions=positions)
    return x


def cast_params_for_compute(params, cfg: ModelCfg):
    """Cast fp32 matrices (every leaf of 2 or more dims, stacked norms
    included, as in the reference) to the compute dtype once, up front."""
    dt = cm.cdtype(cfg)
    if dt == torch.float32:
        return params
    return tree_map(lambda p: p.to(dt)
                    if (p.dtype == torch.float32 and p.dim() >= 2) else p,
                    params)


def forward(params, cfg: ModelCfg, batch: Dict[str, torch.Tensor]):
    """Returns (logits (B,S,V) in the compute dtype, aux_loss scalar); the
    aux loss (the experts' balance term in the reference) is 0 for the
    attention families."""
    check_supported(cfg)
    params = cast_params_for_compute(params, cfg)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    x = _stack(x, params, cfg, positions=positions)
    return _head(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with stacked caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelCfg, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu"):
    """Stacked KV caches matching the layer stacks: ``cache["layers"][name]
    = {"k", "v"}``, each ``(n_cycles, batch, max_len, n_kv_heads, hd)``
    (the batch axis is always axis 1)."""
    check_supported(cfg)
    return {"layers": {
        f"{ci}_{k}": {
            kk: torch.zeros((cfg.n_cycles, batch, max_len, cfg.n_kv_heads,
                             cfg.hd), dtype=dtype, device=device)
            for kk in ("k", "v")}
        for ci, k in enumerate(cfg.cycle)}}


def _decode_block(p, x, cfg, kind, cache, pos):
    """Single-token residual block against a cache."""
    h = cm.apply_norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    window = cfg.local_window if kind == "l" else 0
    a, cache = attn.attn_decode(p["attn"], h, cfg, cache, pos, window=window)
    if cfg.post_norms:
        a = cm.apply_norm(a, p["pn1"], cfg.norm, cfg.norm_eps)
    x = x + a
    h = cm.apply_norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    f = mlp_block(p["ffn"], h)
    if cfg.post_norms:
        f = cm.apply_norm(f, p["pn2"], cfg.norm, cfg.norm_eps)
    return x + f, cache


def decode_step(params, cfg: ModelCfg, cache, token, pos):
    """token: (B,) ints; pos: scalar or (B,); returns (logits (B,V), cache),
    the cache updated in place at each row's position."""
    check_supported(cfg)
    params = cast_params_for_compute(params, cfg)
    x = _embed(params, cfg, torch.as_tensor(token)[:, None])
    pv = attn.pos_vec(pos, x.shape[0], x.device)
    names = sorted(params["layers"])
    for i in range(cfg.n_cycles):
        for kind, name in zip(cfg.cycle, names):
            x, _ = _decode_block(layer(params["layers"][name], i), x, cfg,
                                 kind, layer(cache["layers"][name], i), pv)
    return _head(params, cfg, x)[:, 0], cache


def _capture_kv(p, h, cfg, positions, c):
    """Compute this layer's prompt K/V and store it into its cache slice
    [0, S) in place."""
    hh = cm.apply_norm(h, p["n1"], cfg.norm, cfg.norm_eps)
    _, k, v = attn._qkv(p["attn"], hh, cfg, positions=positions)
    s = k.shape[1]
    c["k"][:, :s] = k.to(c["k"].dtype)
    c["v"][:, :s] = v.to(c["v"].dtype)
    return c


def _prefill_attn_stack(stack, cache_stack, x, cfg, kinds, positions):
    """Run the stacked layers over the prompt, capturing each layer's K/V
    into its cache before applying it."""
    names = sorted(stack)
    for i in range(cfg.n_cycles):
        for kind, name in zip(kinds, names):
            p = layer(stack[name], i)
            _capture_kv(p, x, cfg, positions, layer(cache_stack[name], i))
            x = block_apply(p, x, cfg, kind, positions=positions)
    return x, cache_stack


def prefill(params, cfg: ModelCfg, batch, max_len: int,
            cache_dtype=torch.bfloat16):
    """Run the full prompt, build the decode cache, return the last
    position's logits and the cache."""
    check_supported(cfg)
    params = cast_params_for_compute(params, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    cache = init_cache(cfg, b, max_len, cache_dtype, device=x.device)
    positions = torch.arange(s, device=x.device)
    x, cache["layers"] = _prefill_attn_stack(
        params["layers"], cache["layers"], x, cfg, cfg.cycle, positions)
    logits = _head(params, cfg, x)
    return logits[:, -1], cache
