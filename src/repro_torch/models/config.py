"""Model configuration dataclasses for the architecture zoo.

One frozen dataclass describes any of the 10 assigned architectures (plus
reduced smoke variants).  Heterogeneous layer stacks are expressed as a
repeating ``layer_pattern`` cycle (e.g. gemma2's local/global alternation)
plus an optional dense prefix (deepseek's first-3-dense); parameters are
stacked per pattern position and the forward pass loops over the cycles.
These are whole copies of the reference's dataclasses, so every
registered config loads; ``models.lm`` refuses the families it does not
run yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts
    d_ff_expert: int = 0         # per-expert hidden size
    first_dense: int = 0         # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class GroupGateMoECfg(MoECfg):
    """DeepSeek-V3's published expert layer (arXiv:2412.19437 §2.1.2; its
    ``inference/model.py::Gate``): sigmoid scores over every expert, the
    choice biased by a per-expert correction, ``topk_groups`` of
    ``n_groups`` groups kept by the sum of each group's top 2, the top k
    experts of the kept groups, their unbiased scores normalised to sum 1
    times ``route_scale``; no token dropped.  The layer holds the experts
    ``[first_expert, first_expert + held)`` of the ``n_experts`` its
    router scores (``held`` 0: all of them), as one chip of an
    expert-parallel deployment does.  A subclass, so the twins of the JAX
    package's configurations keep exactly its fields."""
    n_groups: int = 1
    topk_groups: int = 1
    route_scale: float = 1.0
    held: int = 0
    first_expert: int = 0

    @property
    def n_held(self) -> int:
        return self.held or self.n_experts


@dataclasses.dataclass(frozen=True)
class YarnCfg:
    """YaRN's rotary scaling (arXiv:2309.00071) as DeepSeek-V3 sets it
    (``rope_scaling`` of its config.json)."""
    factor: float = 40.0
    original_max_pos: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class YarnMLACfg(MLACfg):
    """MLA whose rotary dims take YaRN's frequencies and whose softmax
    scale takes YaRN's mscale squared (a subclass, as above)."""
    yarn: YarnCfg = YarnCfg()


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention flavour
    qkv_bias: bool = False       # qwen2.5
    qk_norm: bool = False        # chameleon
    rope_frac: float = 1.0       # stablelm partial rotary (0.25)
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0    # gemma2 (50.0)
    logit_softcap: float = 0.0   # gemma2 (30.0)
    local_window: int = 0        # gemma2 sliding window (4096)
    # layer stack: cycle of kinds, repeated; 'a'=global attn block,
    # 'l'=local attn block, 'e'=moe block, 'm'=mamba2 block
    layer_pattern: Tuple[str, ...] = ("a",)
    post_norms: bool = False     # gemma2 post-attn/post-ffn extra norms
    norm: str = "rms"            # rms | layer
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma-style sqrt(d_model) embed scaling
    # sub-configs
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # zamba2: shared transformer blocks applied every k mamba layers
    shared_attn_period: int = 0
    n_shared_blocks: int = 0
    shared_d_ff: int = 0
    # encoder-decoder (seamless)
    enc_layers: int = 0
    # deepseek multi-token prediction (1 extra depth)
    mtp: bool = False
    mtp_weight: float = 0.3
    # numerics / memory
    dtype: str = "bfloat16"      # activation/compute dtype
    remat: bool = True           # checkpoint each layer in training
    # --- beyond-paper perf knobs (see EXPERIMENTS.md §Perf) ---
    # pad q-heads up to a TP-divisible count with zero-masked dummy heads
    # (mathematically identical logits AND gradients; trades ~pad/heads
    # extra attention flops for full 16-way head sharding)
    pad_heads: int = 0
    # sequence parallelism: shard activations over ('model') along seq,
    # replicate block weights on 'model', all-gather K/V per layer --
    # replaces per-layer TP all-reduces (wins for small-d_model archs)
    seq_parallel: bool = False
    # which input modality the stub frontend provides ("tokens" or "frames")
    frontend: str = "tokens"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype``."""
        return getattr(torch, self.dtype)

    @property
    def cycle(self) -> Tuple[str, ...]:
        return self.layer_pattern

    @property
    def n_cycles(self) -> int:
        body = self.n_layers - (self.moe.first_dense if self.moe else 0)
        assert body % len(self.cycle) == 0, (self.name, body, self.cycle)
        return body // len(self.cycle)

    def validate(self) -> "ModelCfg":
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
        if self.family in ("ssm", "hybrid"):
            assert self.ssm is not None
        if self.moe:
            assert self.moe.d_ff_expert > 0
        _ = self.n_cycles  # divisibility check
        return self


def param_count(cfg: ModelCfg) -> dict:
    """Analytic parameter counts: total and active-per-token (for MoE).

    Used for 6*N*D model-FLOPs accounting in the roofline tables.
    """
    d, v = cfg.d_model, cfg.vocab
    embed = v * d * (1 if cfg.tie_embeddings else 2)

    def attn_params() -> int:
        if cfg.mla:
            m = cfg.mla
            qk = m.nope_dim + m.rope_dim
            return (d * m.q_lora + m.q_lora * cfg.n_heads * qk
                    + d * (m.kv_lora + m.rope_dim)
                    + m.kv_lora * cfg.n_heads * (m.nope_dim + m.v_dim)
                    + cfg.n_heads * m.v_dim * d)
        hd = cfg.hd
        return (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * d)

    def dense_ffn(d_ff: int) -> int:
        return 3 * d * d_ff  # SwiGLU: gate, up, down

    per_kind = {}
    per_kind["a"] = attn_params() + dense_ffn(cfg.d_ff)
    per_kind["l"] = per_kind["a"]
    if cfg.moe:
        e = cfg.moe
        per_kind["e"] = (attn_params() + d * e.n_experts
                         + (e.n_experts + e.n_shared) * dense_ffn(e.d_ff_expert) // 1)
    if cfg.ssm:
        s = cfg.ssm
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        conv_ch = d_in + 2 * s.n_groups * s.d_state
        per_kind["m"] = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
                         + conv_ch * s.conv_dim + 2 * nheads + d_in * d)

    total = embed
    active = embed
    prefix = cfg.moe.first_dense if cfg.moe else 0
    total += prefix * per_kind["a"]
    active += prefix * per_kind["a"]
    for k in cfg.cycle:
        n = cfg.n_cycles
        total += n * per_kind[k]
        if k == "e":
            e = cfg.moe
            act_ffn = (e.top_k + e.n_shared) * dense_ffn(e.d_ff_expert)
            active += n * (attn_params() + d * e.n_experts + act_ffn)
        else:
            active += n * per_kind[k]
    if cfg.shared_attn_period:
        shared = cfg.n_shared_blocks * (attn_params() + dense_ffn(cfg.shared_d_ff))
        total += shared
        active += shared
    if cfg.enc_layers:
        # encoder self-attn+ffn, decoder extra cross-attn
        total += cfg.enc_layers * per_kind["a"]
        active += cfg.enc_layers * per_kind["a"]
        cross = attn_params()
        total += cfg.n_layers * cross
        active += cfg.n_layers * cross
    return {"total": int(total), "active": int(active)}
