"""Model assembly: parameter init, training forward/loss, prefill and
per-row decode, for every family of the reference's model zoo.

Layer heterogeneity is a repeating ``cfg.layer_pattern`` cycle of kinds
``a`` (global attention), ``l`` (sliding-window attention), ``e``
(attention + mixture of experts) and ``m`` (Mamba-2); parameters are
stacked per pattern position (``params["layers"][f"{ci}_{kind}"]``, each
leaf with a leading ``(n_cycles,)`` dim, the reference's layout) and the
forward pass loops over the cycles.  As in the reference:

* deepseek's dense prefix is a second, shorter stack (``params["prefix"]``,
  ``first_dense`` layers of kind ``a`` at ``cfg.d_ff``), and its depth-1
  multi-token-prediction subtree (``params["mtp"]``) adds a term to
  ``loss_fn``;
* ``hybrid`` (zamba2) groups the mamba layers by ``shared_attn_period``
  and applies one of the shared transformer blocks (round-robin over
  ``n_shared_blocks``) after each group;
* ``encdec`` (seamless) adds a non-causal encoder stack
  (``params["enc_layers"]``, ``params["enc_norm"]``) over precomputed
  frame embeddings (the audio frontend is a stub, as in the reference)
  and a cross-attention sub-block (``nx``, ``xattn``) in every decoder
  layer; ``prefill`` fills ``cache["cross"]`` with each decoder layer's
  encoder-side K/V, which ``decode_step`` reads and passes through;
* attention is MLA when ``cfg.mla`` is set.

Training (``loss_fn``) runs ``forward(train=True)``: with ``cfg.remat``
each cycle (each zamba2 group) is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
around its scan bodies.  Gradients are autograd's through plain PyTorch.

The decode cache is updated in place: ``decode_step`` returns the cache
it was given.  Trees are nested dicts (and tuples, for an SSM cache's
``(state, conv)``) of tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelCfg
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.parallel import context

KINDS = ("a", "l", "e", "m")


def layer(stack, i):
    """Layer ``i``'s parameters or cache (views) from a stacked tree."""
    return tree_map(lambda t: t[i], stack)


def unstack(stack):
    """Every layer's tree of a stacked tree, as a list: one ``unbind`` a
    leaf, whose backward stacks the layers' gradients once (indexing each
    layer apart would add a zero-filled full stack per layer)."""
    if isinstance(stack, dict):
        per = {k: unstack(v) for k, v in stack.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    if isinstance(stack, tuple):
        per = [unstack(v) for v in stack]
        return [tuple(v[i] for v in per) for i in range(len(per[0]))]
    return list(stack.unbind(0))


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


def tree_unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in ``tree_leaves``
    order, by ``values`` (an iterable)."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        return next(it)

    return build(tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_block(init: cm.Init, cfg: ModelCfg, kind: str, *,
               cross: bool = False, d_ff: int = 0):
    """One layer's parameters.  kind: a = attention, l = local attention,
    e = attention + experts, m = mamba; ``cross`` adds a cross-attention
    sub-block (the encoder-decoder's decoder layers); ``d_ff`` (default
    ``cfg.d_ff``) is the dense feed-forward width."""
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
    if cross:
        p["nx"] = cm.init_norm(init, d, cfg.norm)
        p["xattn"] = attn.init_attn(init, cfg, cross=True)
    p["n2"] = cm.init_norm(init, d, cfg.norm)
    if kind == "e":
        p["ffn"] = moe_mod.init_moe(init, cfg)
    else:
        p["ffn"] = init_mlp(init, d, d_ff or cfg.d_ff)
    if cfg.post_norms:
        p["pn1"] = cm.init_norm(init, d, cfg.norm)
        p["pn2"] = cm.init_norm(init, d, cfg.norm)
    return p


def block_apply(p, x, cfg: ModelCfg, kind: str, *, positions, causal=True,
                enc_out=None):
    """Pre-norm residual block (causal unless ``causal`` is False: the
    encoder's); a block with a cross-attention sub-block attends to
    ``enc_out`` after its self-attention.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.seq_parallel:
        x = context.constrain(x, ("batch", "seq", None))
    h = cm.apply_norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    if kind == "m":
        return x + ssm_mod.ssm_block(p["ssm"], h, cfg), aux
    if cfg.mla:
        a = attn.mla_block(p["attn"], h, cfg, positions=positions)
    else:
        window = cfg.local_window if kind == "l" else 0
        a = attn.attn_block(p["attn"], h, cfg, positions=positions,
                            causal=causal, window=window)
    if cfg.post_norms:
        a = cm.apply_norm(a, p["pn1"], cfg.norm, cfg.norm_eps)
    x = x + a
    if "xattn" in p and enc_out is not None:
        hx = cm.apply_norm(x, p["nx"], cfg.norm, cfg.norm_eps)
        x = x + attn.attn_block(p["xattn"], hx, cfg, positions=None,
                                causal=False, kv_x=enc_out, rope=False)
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
    root = cm.Init(seed, dtype, device)
    d = cfg.d_model
    tree: Dict[str, Any] = {"embed": root.normal((cfg.vocab, d),
                                                ("vocab", "embed"))}
    if cfg.moe and cfg.moe.first_dense:
        tree["prefix"] = init_block(
            cm.StackedInit(root, cfg.moe.first_dense), cfg, "a",
            d_ff=cfg.d_ff)
    tree["layers"] = {
        f"{ci}_{kind}": init_block(cm.StackedInit(root, cfg.n_cycles), cfg,
                                   kind, cross=cfg.enc_layers > 0)
        for ci, kind in enumerate(cfg.cycle)}
    if cfg.shared_attn_period:
        tree["shared"] = init_block(
            cm.StackedInit(root, cfg.n_shared_blocks), cfg, "a",
            d_ff=cfg.shared_d_ff)
    if cfg.enc_layers:
        tree["enc_layers"] = init_block(
            cm.StackedInit(root, cfg.enc_layers), cfg, "a", d_ff=cfg.d_ff)
        tree["enc_norm"] = cm.init_norm(root, d, cfg.norm)
    tree["final_norm"] = cm.init_norm(root, d, cfg.norm)
    if not cfg.tie_embeddings:
        tree["head"] = root.normal((d, cfg.vocab), ("embed", "vocab"))
    if cfg.mtp:
        tree["mtp"] = {"proj": root.normal((2 * d, d), (None, "embed")),
                       "block": init_block(root, cfg, "a", d_ff=cfg.d_ff),
                       "norm": cm.init_norm(root, d, cfg.norm)}
    return tree


def abstract_params(cfg: ModelCfg, dtype=torch.float32):
    """``(params, logical axes)``: ``init_params``'s tree on the ``meta``
    device (shapes and dtypes, no storage) and beside it the reference's
    tree of logical axis tuples, one name or None per dim of each leaf."""
    with cm.record_axes() as rec:
        tree = init_params(cfg, device="meta", dtype=dtype)
    return tree, tree_map(lambda t: rec[id(t)][1], tree)


def param_axes(cfg: ModelCfg):
    """The logical axes tree beside ``init_params(cfg)``'s tree."""
    return abstract_params(cfg)[1]


def param_numel(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    # F.embedding, not indexing: its backward sums a token's rows in a
    # fixed order on the CPU too (indexing's accumulates across threads).
    w = params["embed"]
    tokens = torch.as_tensor(tokens).to(w.device, torch.int64)
    if isinstance(w, DTensor) and context.current_rules() is not None:
        x = _sharded_embed(w.to(cm.cdtype(cfg)), tokens)
    else:
        x = F.embedding(tokens, w.to(cm.cdtype(cfg)))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _sharded_embed(w, tokens):
    """The vocab-parallel lookup of ``tokens`` (B, S) in a DTensor table
    (V, D): each device looks up the rows of its vocab shard (zeros for
    tokens outside it) in a ``local_map``, and the rows are summed over
    the vocab's mesh dims onto the batch placement."""
    rules = context.current_rules()
    mesh = w.device_mesh
    tok_pl = rules.sharding(tokens.shape, ("batch", None))
    w_pl = rules.sharding(w.shape, ("vocab", None))
    vdims = [j for j, pl in enumerate(w_pl) if pl.is_shard()]
    vl = w.shape[0] // math.prod(mesh.size(j) for j in vdims)
    rows_pl = tuple(Partial() if wp.is_shard() else tp
                    for tp, wp in zip(tok_pl, w_pl))

    def lookup(tab, tok):
        if not vdims:
            return F.embedding(tok, tab)
        v0 = vl * mesh.get_local_rank(vdims[0])
        hit = (tok >= v0) & (tok < v0 + vl)
        rows = F.embedding(torch.where(hit, tok - v0, 0), tab)
        return torch.where(hit[..., None], rows, 0.0)

    x = local_map(
        lookup, out_placements=(rows_pl,),
        in_placements=(w_pl, tok_pl),
        in_grad_placements=(tuple(
            wp if wp.is_shard() else Partial() if tp.is_shard() else wp
            for tp, wp in zip(tok_pl, w_pl)), tok_pl),
        device_mesh=mesh, redistribute_inputs=True)(w, tokens)
    return context.constrain(x, ("batch", None, None))


def _head(params, cfg, x):
    x = cm.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    x = context.constrain(x, ("batch", None, None))
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = cm.einsum("bsd,dv->bsv", x, w.to(x.dtype),
                       ("batch", None, None), (None, "vocab"))
    if cfg.logit_softcap:
        logits = cm.softcap(logits.to(torch.float32),
                            cfg.logit_softcap).to(x.dtype)
    # Logits stay in the compute dtype, as in the reference; sharded, they
    # keep the batch on the data axes and the vocab on the model axis.
    return context.constrain(logits, ("batch", None, "vocab"))


def _stack(x, stacks, cfg, *, positions, causal=True, enc_out=None,
           kinds=None, remat=False):
    """Apply a dict of layer stacks: cycles in order, each cycle's kinds in
    pattern order; with ``remat`` each cycle is recomputed in the backward
    pass.  Returns (x, summed aux loss)."""
    kinds = kinds or cfg.cycle
    per = [unstack(stacks[name]) for name in sorted(stacks)]

    def cycle(h, aux, i):
        for kind, layers in zip(kinds, per):
            h, a = block_apply(layers[i], h, cfg, kind, positions=positions,
                               causal=causal, enc_out=enc_out)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(len(per[0])):
        x, aux = (checkpoint(cycle, x, aux, i, use_reentrant=False) if remat
                  else cycle(x, aux, i))
    return x, aux


def _groups(cfg):
    """zamba2's grouping: (groups, layers a group, the shared block of
    each group)."""
    period = cfg.shared_attn_period
    n_groups = cfg.n_cycles // period
    return n_groups, period, [g % cfg.n_shared_blocks
                              for g in range(n_groups)]


def _hybrid_stack(params, x, cfg, *, positions, remat=False):
    """zamba2: groups of ``shared_attn_period`` mamba layers, a shared
    transformer block (round-robin over ``n_shared_blocks``) after each;
    with ``remat`` each group is recomputed in the backward pass."""
    (stack,) = params["layers"].values()
    n_groups, period, shared_of = _groups(cfg)
    mamba, shared = unstack(stack), unstack(params["shared"])

    def group(h, aux, g):
        for j in range(period):
            h, a = block_apply(mamba[g * period + j], h, cfg, "m",
                               positions=positions)
            aux = aux + a
        h, a = block_apply(shared[shared_of[g]], h, cfg, "a",
                           positions=positions)
        return h, aux + a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        x, aux = (checkpoint(group, x, aux, g, use_reentrant=False) if remat
                  else group(x, aux, g))
    return x, aux


def cast_params_for_compute(params, cfg: ModelCfg):
    """Cast fp32 matrices (every leaf of 2 or more dims, stacked norms
    included, as in the reference) to the compute dtype once, up front.
    The cast is differentiable: gradients reach the fp32 masters."""
    dt = cm.cdtype(cfg)
    if dt == torch.float32:
        return params
    return tree_map(lambda p: p.to(dt)
                    if (p.dtype == torch.float32 and p.dim() >= 2) else p,
                    params)


def _encode(params, cfg, frames, remat=False):
    """The encoder over precomputed frame embeddings (B, T, D): non-causal
    blocks with rope at the frame positions, then ``enc_norm``."""
    x = torch.as_tensor(frames, device=params["embed"].device).to(
        cm.cdtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _stack(x, {"0": params["enc_layers"]}, cfg, positions=positions,
                  causal=False, kinds=("a",), remat=remat)
    return cm.apply_norm(x, params["enc_norm"], cfg.norm, cfg.norm_eps)


def forward(params, cfg: ModelCfg, batch: Dict[str, torch.Tensor], *,
            train: bool = False):
    """Returns (logits (B,S,V) in the compute dtype, aux_loss float32
    scalar: the experts' summed balance term, 0 without experts).  The
    encoder-decoder reads ``batch["frames"]`` (B, T, D).  ``train``
    recomputes each cycle in the backward pass when ``cfg.remat`` is set
    (the values are the same)."""
    params = cast_params_for_compute(params, cfg)
    remat = train and cfg.remat
    enc_out = (_encode(params, cfg, batch["frames"], remat)
               if cfg.enc_layers else None)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "prefix" in params:
        x, a = _stack(x, {"0": params["prefix"]}, cfg, positions=positions,
                      kinds=("a",), remat=remat)
        aux = aux + a
    if cfg.family == "hybrid":
        x, a = _hybrid_stack(params, x, cfg, positions=positions,
                             remat=remat)
    else:
        x, a = _stack(x, params["layers"], cfg, positions=positions,
                      enc_out=enc_out, remat=remat)
    return _head(params, cfg, x), aux + a


def _xent(logits, labels):
    """Mean cross-entropy ``logsumexp - gold`` in float32 over logits
    (B,S,V) of any float dtype (bf16 ones are upcast here, so their
    cotangent stays bf16) and int labels (B,S).  The gold logit comes
    from ``torch.gather``: the same value as the reference's one-hot
    masked sum, which is a device for GSPMD's vocab sharding, not for one
    card."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    idx = torch.as_tensor(labels, device=lf.device).to(torch.int64)
    if isinstance(lf, DTensor):
        # Vocab-sharded logits: the reference's one-hot masked sum, which
        # keeps every dim aligned with the logits' placement (a gather
        # along the sharded vocab has no sharding strategy to use).
        vocab = torch.arange(lf.shape[-1], device=idx.device)
        gold = torch.sum(torch.where(vocab == idx[..., None], lf, 0.0),
                         dim=-1)
    else:
        gold = torch.gather(lf, -1, idx[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_fn(params, cfg: ModelCfg, batch):
    """Training loss and its metrics: ``(loss, {"ce", "aux", "loss"})``,
    plus ``"mtp_ce"`` with deepseek's depth-1 multi-token prediction:
    ``h_t`` from the embeddings of ``x_t`` and ``x_{t+1}`` through one
    extra block predicts ``x_{t+2}`` with the main head, weighted by
    ``cfg.mtp_weight`` (the reference's lightweight approximation)."""
    params = cast_params_for_compute(params, cfg)
    logits, aux = forward(params, cfg, batch, train=True)
    dev = logits.device
    labels = torch.as_tensor(batch["labels"], device=dev).to(torch.int64)
    ce = _xent(logits, labels)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp and "mtp" in params:
        dt = cm.cdtype(cfg)
        tokens = torch.as_tensor(batch["tokens"], device=dev).to(torch.int64)
        x = _embed(params, cfg, tokens)
        nxt = F.pad(tokens[:, 1:], (0, 1))
        h2 = torch.cat([x, _embed(params, cfg, nxt)], dim=-1)
        h2 = torch.einsum("bsd,dp->bsp", h2, params["mtp"]["proj"].to(dt))
        h2, _ = block_apply(params["mtp"]["block"], h2, cfg, "a",
                            positions=torch.arange(tokens.shape[1],
                                                   device=dev))
        h2 = cm.apply_norm(h2, params["mtp"]["norm"], cfg.norm, cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits2 = torch.einsum("bsd,dv->bsv", h2, w.to(dt))
        lbl2 = F.pad(labels[:, 1:], (0, 1))
        mtp_ce = _xent(logits2[:, :-1], lbl2[:, :-1])
        loss = loss + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


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
      (batch axis 2) and ``cache["shared"]``, one K/V cache a group;
    * encdec: also ``cache["cross"]``, ``{"k", "v"}`` of length 0, as in
      the reference: ``prefill`` fills it at the encoder's true length.
    """
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
    if cfg.enc_layers:
        cache["cross"] = stk((cfg.n_cycles,), attn.init_decode_cache(
            dtype, cfg, batch, 0, device))
    return cache


def cache_axes(cfg: ModelCfg):
    """Logical axis names mirroring ``init_cache``'s structure (for the
    sharding rules).  KV caches prefer kv-head sharding; when the head
    count does not divide the mesh axis the rules fall back to splitting
    the sequence (flash-decoding style)."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    mla_ax = {"c": ("layers", "batch", "kv_seq", None),
              "kr": ("layers", "batch", "kv_seq", None)}
    gqa_ax = {"k": kv, "v": kv}

    if cfg.family == "hybrid":
        ssm_state = (None, None, "batch", "heads", None, None)
        ssm_conv = (None, None, "batch", None, "d_ff")
        return {"ssm": (ssm_state, ssm_conv),
                "shared": {"k": kv, "v": kv}}
    if cfg.family == "ssm":
        return {"ssm": ((None, "batch", "heads", None, None),
                        (None, "batch", None, "d_ff"))}
    per = mla_ax if cfg.mla else gqa_ax
    out = {"layers": {f"{ci}_{k}": per for ci, k in enumerate(cfg.cycle)}}
    if cfg.moe and cfg.moe.first_dense:
        out["prefix"] = per
    if cfg.enc_layers:
        out["cross"] = {"k": kv, "v": kv}
    return out


def _decode_block(p, x, cfg, kind, cache, pos, enc_feats=None):
    """Single-token residual block against a cache (updated in place);
    a cross-attention sub-block reads ``enc_feats``, the layer's static
    encoder-side K/V."""
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
    if "xattn" in p and enc_feats is not None:
        hx = cm.apply_norm(x, p["nx"], cfg.norm, cfg.norm_eps)
        cx, _ = attn.attn_decode(p["xattn"], hx, cfg, enc_feats, pos,
                                 cross=True)
        x = x + cx
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
    the cache updated in place at each row's position (the encoder-decoder's
    ``cache["cross"]`` is read, not written)."""
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
        enc = layer(cache["cross"], i) if cfg.enc_layers else None
        for kind, name in zip(cfg.cycle, names):
            x = _decode_block(layer(params["layers"][name], i), x, cfg,
                              kind, layer(cache["layers"][name], i), pv,
                              enc_feats=enc)
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


def _prefill_attn_stack(stack, cache_stack, x, cfg, kinds, positions,
                        enc_out=None):
    """Run the stacked layers over the prompt, capturing each layer's K/V
    into its cache before applying it."""
    names = sorted(stack)
    n = next(tree_leaves(stack)).shape[0]
    for i in range(n):
        for kind, name in zip(kinds, names):
            p = layer(stack[name], i)
            _capture_kv(p, x, cfg, positions, layer(cache_stack[name], i))
            x, _ = block_apply(p, x, cfg, kind, positions=positions,
                               enc_out=enc_out)
    return x


def prefill(params, cfg: ModelCfg, batch, max_len: int,
            cache_dtype=torch.bfloat16):
    """Run the full prompt, build the decode cache, return the last
    position's logits and the cache.

    Attention families capture each layer's prompt K/V (MLA: the latent)
    into the cache; the SSM and hybrid families run the chunked SSD
    forward with ``return_state`` (prompts right-padded to the chunk size
    with dt masked to zero, so the captured state is exact).  The
    encoder-decoder encodes ``batch["frames"]`` first and stores each
    decoder layer's cross K/V of the encoder's output in
    ``cache["cross"]`` (in ``cache_dtype``; no bias or QK norm, as the
    reference's)."""
    params = cast_params_for_compute(params, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = params["embed"].device
    enc_out = (_encode(params, cfg, batch["frames"]) if cfg.enc_layers
               else None)
    cache = init_cache(cfg, b, max_len, cache_dtype, device=dev)
    if isinstance(params["embed"], DTensor):
        cache = context.distribute(cache, cache_axes(cfg))
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_ssm(params, cfg, tokens, cache, cache_dtype)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)
    if "prefix" in params:
        x = _prefill_attn_stack({"0": params["prefix"]},
                                {"0": cache["prefix"]}, x, cfg, ("a",),
                                positions)
    x = _prefill_attn_stack(params["layers"], cache["layers"], x, cfg,
                            cfg.cycle, positions, enc_out=enc_out)
    if cfg.enc_layers:
        (stack,) = params["layers"].values()
        dt = cm.cdtype(cfg)
        cache["cross"] = {
            kk: cm.einsum("btd,ldhk->lbthk", enc_out,
                          stack["xattn"][w].to(dt), ("batch", "seq", None),
                          ("layers", None, "kv_heads", None)).to(cache_dtype)
            for kk, w in (("k", "wk"), ("v", "wv"))}
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
