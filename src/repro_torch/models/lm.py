"""Model assembly for the decoder-only families: parameter init, forward,
prefill and per-row decode.

Layer heterogeneity is a repeating ``cfg.layer_pattern`` cycle of kinds
``a`` (global attention), ``l`` (sliding-window attention), ``e``
(attention + mixture of experts) and ``m`` (Mamba-2); parameters are
stacked per pattern position (``params["layers"][f"{ci}_{kind}"]``, each
leaf with a leading ``(n_cycles,)`` dim, the reference's layout) and the
forward pass loops over the cycles.  As in the reference:

* deepseek's dense prefix is a second, shorter stack (``params["prefix"]``,
  ``first_dense`` layers of kind ``a`` at ``cfg.d_ff``), and its MTP
  subtree (``params["mtp"]``) is initialised for shape parity; only
  training (ROADMAP §1, item 11e) reads it;
* ``hybrid`` (zamba2) groups the mamba layers by ``shared_attn_period``
  and applies one of the shared transformer blocks (round-robin over
  ``n_shared_blocks``) after each group;
* attention is MLA when ``cfg.mla`` is set.

The encoder-decoder family is not ported yet: every entry point refuses
it with ``NotImplementedError`` naming ROADMAP item 11d.  Training
(``loss_fn``) is item 11e.

The decode cache is updated in place: ``decode_step`` returns the cache
it was given.  Trees are nested dicts (and tuples, for an SSM cache's
``(state, conv)``) of tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelCfg
from repro_torch.models.mlp import init_mlp, mlp_block

# Where each unported part of the reference's model zoo is queued.
UNPORTED = {"encdec": "11d (encoder-decoder)"}
KINDS = ("a", "l", "e", "m")


def check_supported(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` for the families the port does not
    run yet (the encoder-decoder)."""
    if cfg.family == "encdec" or cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encdec is not ported to repro_torch yet (ROADMAP "
            f"§1 item {UNPORTED['encdec']}); the port runs the decoder-only "
            f"families, layer kinds {KINDS}")


def layer(stack, i):
    """Layer ``i``'s parameters or cache (views) from a stacked tree."""
    return tree_map(lambda t: t[i], stack)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_block(init: cm.Init, cfg: ModelCfg, kind: str, *, d_ff: int = 0):
    """One layer's parameters.  kind: a = attention, l = local attention,
    e = attention + experts, m = mamba; ``d_ff`` (default ``cfg.d_ff``)
    is the dense feed-forward width."""
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported "
                                  f"(the port runs kinds {KINDS})")
    d = cfg.d_model
    p: Dict[str, Any] = {"n1": cm.init_norm(init, d, cfg.norm)}
    if kind == "m":
        p["ssm"] = ssm_mod.init_ssm(init, cfg)
        return p
    p["attn"] = attn.init_mla(init, cfg) if cfg.mla else attn.init_attn(
        init, cfg)
    p["n2"] = cm.init_norm(init, d, cfg.norm)
    if kind == "e":
        p["ffn"] = moe_mod.init_moe(init, cfg)
    else:
        p["ffn"] = init_mlp(init, d, d_ff or cfg.d_ff)
    if cfg.post_norms:
        p["pn1"] = cm.init_norm(init, d, cfg.norm)
        p["pn2"] = cm.init_norm(init, d, cfg.norm)
    return p


def block_apply(p, x, cfg: ModelCfg, kind: str, *, positions):
    """Pre-norm causal residual block.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = cm.apply_norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    if kind == "m":
        return x + ssm_mod.ssm_block(p["ssm"], h, cfg), aux
    if cfg.mla:
        a = attn.mla_block(p["attn"], h, cfg, positions=positions)
    else:
        window = cfg.local_window if kind == "l" else 0
        a = attn.attn_block(p["attn"], h, cfg, positions=positions,
                            window=window)
    if cfg.post_norms:
        a = cm.apply_norm(a, p["pn1"], cfg.norm, cfg.norm_eps)
    x = x + a
    h = cm.apply_norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    if kind == "e":
        f, aux = moe_mod.moe_block(p["ffn"], h, cfg)
    else:
        f = mlp_block(p["ffn"], h)
    if cfg.post_norms:
        f = cm.apply_norm(f, p["pn2"], cfg.norm, cfg.norm_eps)
    return x + f, aux


# ---------------------------------------------------------------------------
# Parameter init for the whole model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelCfg, seed: int = 0, *, device=None,
                dtype=torch.float32):
    """The model's parameters, drawn in ``dtype`` on ``device`` (None: the
    card) from one seeded generator (shapes and scales of the reference's
    init; the values are the port's own, except the SSM's ``A_log`` and
    ``dt_bias``, which are the reference's numpy draws)."""
    cfg.validate()
    check_supported(cfg)
    root = cm.Init(seed, dtype, device)
    d = cfg.d_model
    tree: Dict[str, Any] = {"embed": root.normal((cfg.vocab, d))}
    if cfg.moe and cfg.moe.first_dense:
        tree["prefix"] = init_block(
            cm.StackedInit(root, cfg.moe.first_dense), cfg, "a",
            d_ff=cfg.d_ff)
    tree["layers"] = {
        f"{ci}_{kind}": init_block(cm.StackedInit(root, cfg.n_cycles), cfg,
                                   kind)
        for ci, kind in enumerate(cfg.cycle)}
    if cfg.shared_attn_period:
        tree["shared"] = init_block(
            cm.StackedInit(root, cfg.n_shared_blocks), cfg, "a",
            d_ff=cfg.shared_d_ff)
    tree["final_norm"] = cm.init_norm(root, d, cfg.norm)
    if not cfg.tie_embeddings:
        tree["head"] = root.normal((d, cfg.vocab))
    if cfg.mtp:
        tree["mtp"] = {"proj": root.normal((2 * d, d)),
                       "block": init_block(root, cfg, "a", d_ff=cfg.d_ff),
                       "norm": cm.init_norm(root, d, cfg.norm)}
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


def _stack(x, stacks, cfg, *, positions, kinds=None):
    """Apply a dict of layer stacks: cycles in order, each cycle's kinds in
    pattern order.  Returns (x, summed aux loss)."""
    kinds = kinds or cfg.cycle
    names = sorted(stacks)
    n = next(tree_leaves(stacks)).shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        for kind, name in zip(kinds, names):
            x, a = block_apply(layer(stacks[name], i), x, cfg, kind,
                               positions=positions)
            aux = aux + a
    return x, aux


def _groups(cfg):
    """zamba2's grouping: (groups, layers a group, the shared block of
    each group)."""
    period = cfg.shared_attn_period
    n_groups = cfg.n_cycles // period
    return n_groups, period, [g % cfg.n_shared_blocks
                              for g in range(n_groups)]


def _hybrid_stack(params, x, cfg, *, positions):
    """zamba2: groups of ``shared_attn_period`` mamba layers, a shared
    transformer block (round-robin over ``n_shared_blocks``) after each."""
    (stack,) = params["layers"].values()
    n_groups, period, shared_of = _groups(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        for j in range(period):
            x, a = block_apply(layer(stack, g * period + j), x, cfg, "m",
                               positions=positions)
            aux = aux + a
        x, a = block_apply(layer(params["shared"], shared_of[g]), x, cfg,
                           "a", positions=positions)
        aux = aux + a
    return x, aux


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
    """Returns (logits (B,S,V) in the compute dtype, aux_loss float32
    scalar: the experts' summed balance term, 0 without experts)."""
    check_supported(cfg)
    params = cast_params_for_compute(params, cfg)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "prefix" in params:
        x, a = _stack(x, {"0": params["prefix"]}, cfg, positions=positions,
                      kinds=("a",))
        aux = aux + a
    if cfg.family == "hybrid":
        x, a = _hybrid_stack(params, x, cfg, positions=positions)
    else:
        x, a = _stack(x, params["layers"], cfg, positions=positions)
    return _head(params, cfg, x), aux + a


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with stacked caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelCfg, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Stacked caches matching the layer stacks, every layer's in its own
    storage, on ``device`` (None: the card):

    * attention families: ``cache["layers"][name]`` (and
      ``cache["prefix"]``) of ``{"k", "v"}`` leaves ``(n, batch, max_len,
      n_kv_heads, hd)``, or MLA's ``{"c", "kr"}`` ``(n, batch, max_len,
      kv_lora | rope_dim)``;
    * ssm: ``cache["ssm"] = (state (n_cycles, batch, H, N, P) float32,
      conv (n_cycles, batch, K, C))``;
    * hybrid: ``cache["ssm"]`` with leading ``(groups, period)`` dims
      (batch axis 2) and ``cache["shared"]``, one K/V cache a group.
    """
    check_supported(cfg)
    device = cm.device_or_card(device)

    def stk(lead, one):
        # Zeroed stacks shaped like one layer's cache (never expanded
        # views: the caches are written in place).
        return tree_map(lambda t: t.new_zeros(tuple(lead) + t.shape), one)

    if cfg.family in ("ssm", "hybrid"):
        one = ssm_mod.init_ssm_cache(dtype, cfg, batch, device)
        if cfg.family == "ssm":
            return {"ssm": stk((cfg.n_cycles,), one)}
        n_groups, period, _ = _groups(cfg)
        return {"ssm": stk((n_groups, period), one),
                "shared": stk((n_groups,), attn.init_decode_cache(
                    dtype, cfg, batch, max_len, device))}

    one = (attn.init_mla_cache(dtype, cfg, batch, max_len, device) if cfg.mla
           else attn.init_decode_cache(dtype, cfg, batch, max_len, device))
    cache: Dict[str, Any] = {}
    if cfg.moe and cfg.moe.first_dense:
        cache["prefix"] = stk((cfg.moe.first_dense,), one)
    cache["layers"] = {f"{ci}_{k}": stk((cfg.n_cycles,), one)
                       for ci, k in enumerate(cfg.cycle)}
    return cache


def _decode_block(p, x, cfg, kind, cache, pos):
    """Single-token residual block against a cache (updated in place)."""
    h = cm.apply_norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    if kind == "m":
        o, _ = ssm_mod.ssm_decode(p["ssm"], h, cfg, cache)
        return x + o
    if cfg.mla:
        a, _ = attn.mla_decode(p["attn"], h, cfg, cache, pos)
    else:
        window = cfg.local_window if kind == "l" else 0
        a, _ = attn.attn_decode(p["attn"], h, cfg, cache, pos,
                                window=window)
    if cfg.post_norms:
        a = cm.apply_norm(a, p["pn1"], cfg.norm, cfg.norm_eps)
    x = x + a
    h = cm.apply_norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    if kind == "e":
        f, _ = moe_mod.moe_block(p["ffn"], h, cfg)
    else:
        f = mlp_block(p["ffn"], h)
    if cfg.post_norms:
        f = cm.apply_norm(f, p["pn2"], cfg.norm, cfg.norm_eps)
    return x + f


def decode_step(params, cfg: ModelCfg, cache, token, pos):
    """token: (B,) ints; pos: scalar or (B,); returns (logits (B,V), cache),
    the cache updated in place at each row's position."""
    check_supported(cfg)
    params = cast_params_for_compute(params, cfg)
    x = _embed(params, cfg, torch.as_tensor(token)[:, None])
    pv = attn.pos_vec(pos, x.shape[0], x.device)

    if cfg.family == "hybrid":
        (stack,) = params["layers"].values()
        n_groups, period, shared_of = _groups(cfg)
        for g in range(n_groups):
            for j in range(period):
                x = _decode_block(layer(stack, g * period + j), x, cfg, "m",
                                  layer(cache["ssm"], (g, j)), pv)
            x = _decode_block(layer(params["shared"], shared_of[g]), x, cfg,
                              "a", layer(cache["shared"], g), pv)
        return _head(params, cfg, x)[:, 0], cache
    if cfg.family == "ssm":
        (stack,) = params["layers"].values()
        for i in range(cfg.n_cycles):
            x = _decode_block(layer(stack, i), x, cfg, "m",
                              layer(cache["ssm"], i), pv)
        return _head(params, cfg, x)[:, 0], cache

    if "prefix" in params:
        for i in range(cfg.moe.first_dense):
            x = _decode_block(layer(params["prefix"], i), x, cfg, "a",
                              layer(cache["prefix"], i), pv)
    names = sorted(params["layers"])
    for i in range(cfg.n_cycles):
        for kind, name in zip(cfg.cycle, names):
            x = _decode_block(layer(params["layers"][name], i), x, cfg,
                              kind, layer(cache["layers"][name], i), pv)
    return _head(params, cfg, x)[:, 0], cache


def _capture_kv(p, h, cfg, positions, c):
    """Compute this layer's prompt K/V (MLA: the latent and rotated key)
    and store it into its cache slice [0, S) in place."""
    hh = cm.apply_norm(h, p["n1"], cfg.norm, cfg.norm_eps)
    if cfg.mla:
        new = dict(zip(("c", "kr"), attn._mla_latent(p["attn"], hh, cfg,
                                                     positions)))
    else:
        _, k, v = attn._qkv(p["attn"], hh, cfg, positions=positions)
        new = {"k": k, "v": v}
    for kk, t in new.items():
        c[kk][:, :t.shape[1]] = t.to(c[kk].dtype)
    return c


def _prefill_attn_stack(stack, cache_stack, x, cfg, kinds, positions):
    """Run the stacked layers over the prompt, capturing each layer's K/V
    into its cache before applying it."""
    names = sorted(stack)
    n = next(tree_leaves(stack)).shape[0]
    for i in range(n):
        for kind, name in zip(kinds, names):
            p = layer(stack[name], i)
            _capture_kv(p, x, cfg, positions, layer(cache_stack[name], i))
            x, _ = block_apply(p, x, cfg, kind, positions=positions)
    return x


def prefill(params, cfg: ModelCfg, batch, max_len: int,
            cache_dtype=torch.bfloat16):
    """Run the full prompt, build the decode cache, return the last
    position's logits and the cache.

    Attention families capture each layer's prompt K/V (MLA: the latent)
    into the cache; the SSM and hybrid families run the chunked SSD
    forward with ``return_state`` (prompts right-padded to the chunk size
    with dt masked to zero, so the captured state is exact)."""
    check_supported(cfg)
    params = cast_params_for_compute(params, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = params["embed"].device
    cache = init_cache(cfg, b, max_len, cache_dtype, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_ssm(params, cfg, tokens, cache, cache_dtype)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)
    if "prefix" in params:
        x = _prefill_attn_stack({"0": params["prefix"]},
                                {"0": cache["prefix"]}, x, cfg, ("a",),
                                positions)
    x = _prefill_attn_stack(params["layers"], cache["layers"], x, cfg,
                            cfg.cycle, positions)
    logits = _head(params, cfg, x)
    return logits[:, -1], cache


def _prefill_ssm(params, cfg, tokens, cache, cache_dtype):
    """SSM / hybrid prefill: the prompt right-padded to the chunk size,
    dt masked at the pad, each mamba layer's state and conv buffer at the
    prompt's end (and the shared blocks' K/V over the padded prompt)
    written into the cache; logits at position s - 1."""
    tokens = torch.as_tensor(tokens)
    b, s = tokens.shape
    ck = cfg.ssm.chunk
    pad = (-s) % ck
    toks_p = F.pad(tokens, (0, pad))
    x = _embed(params, cfg, toks_p)
    mask = (torch.arange(s + pad, device=x.device) < s)[None, :]
    positions = torch.arange(s + pad, device=x.device)
    (stack,) = params["layers"].values()

    def mamba(h, p, dst):
        hh = cm.apply_norm(h, p["n1"], cfg.norm, cfg.norm_eps)
        o, (st, cv) = ssm_mod.ssm_block(p["ssm"], hh, cfg, mask=mask,
                                        return_state=True, real_len=s)
        dst[0].copy_(st)
        dst[1].copy_(cv.to(cache_dtype))
        return h + o

    if cfg.family == "ssm":
        for i in range(cfg.n_cycles):
            x = mamba(x, layer(stack, i), layer(cache["ssm"], i))
    else:
        n_groups, period, shared_of = _groups(cfg)
        for g in range(n_groups):
            for j in range(period):
                x = mamba(x, layer(stack, g * period + j),
                          layer(cache["ssm"], (g, j)))
            sp = layer(params["shared"], shared_of[g])
            _capture_kv(sp, x, cfg, positions, layer(cache["shared"], g))
            x, _ = block_apply(sp, x, cfg, "a", positions=positions)
    logits = _head(params, cfg, x[:, s - 1:s, :])
    return logits[:, 0], cache
