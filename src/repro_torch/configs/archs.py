"""The 10 assigned architecture configs (full) + reduced smoke variants.

Every full config follows the assignment table verbatim (layers, d_model,
heads, kv-heads, d_ff, vocab); flavour details (head_dim, rope theta,
softcaps, MoE wiring, MLA dims, SSD dims) follow the cited public configs.
Smoke variants keep the exact same *structure* (layer pattern, family,
feature flags) at toy width/depth so one CPU forward/train step runs in
seconds.
"""
from __future__ import annotations

from repro_torch.models.config import MLACfg, MoECfg, ModelCfg, SSMCfg

FULL = {}
SMOKE = {}


def _reg(full: ModelCfg, smoke: ModelCfg):
    FULL[full.name] = full.validate()
    SMOKE[full.name] = smoke.validate()


# --- internlm2-20b: dense GQA [arXiv:2403.17297] ---------------------------
_reg(
    ModelCfg(name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
             n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544,
             head_dim=128, rope_theta=1e6),
    ModelCfg(name="internlm2-20b", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
             head_dim=16, rope_theta=1e6, dtype="float32"),
)

# --- gemma2-27b: local/global alternating, softcaps [arXiv:2408.00118] -----
_reg(
    ModelCfg(name="gemma2-27b", family="dense", n_layers=46, d_model=4608,
             n_heads=32, n_kv_heads=16, d_ff=36864, vocab=256000,
             head_dim=128, layer_pattern=("l", "a"), local_window=4096,
             attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
             embed_scale=True, tie_embeddings=True),
    ModelCfg(name="gemma2-27b", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, d_ff=256, vocab=512, head_dim=16,
             layer_pattern=("l", "a"), local_window=16, attn_softcap=50.0,
             logit_softcap=30.0, post_norms=True, embed_scale=True,
             tie_embeddings=True, dtype="float32"),
)

# --- qwen2.5-14b: GQA + QKV bias [hf:Qwen/Qwen2.5] --------------------------
_reg(
    ModelCfg(name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
             n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064,
             head_dim=128, qkv_bias=True, rope_theta=1e6),
    ModelCfg(name="qwen2.5-14b", family="dense", n_layers=4, d_model=120,
             n_heads=6, n_kv_heads=2, d_ff=256, vocab=512, head_dim=20,
             qkv_bias=True, rope_theta=1e6, dtype="float32"),
)

# --- stablelm-3b: MHA, partial rotary, LayerNorm [hf:stabilityai] -----------
_reg(
    ModelCfg(name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
             n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
             head_dim=80, rope_frac=0.25, norm="layer"),
    ModelCfg(name="stablelm-3b", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=8, d_ff=256, vocab=512, head_dim=16,
             rope_frac=0.25, norm="layer", dtype="float32"),
)

# --- chameleon-34b: early-fusion VLM, VQ image tokens in vocab, qk-norm -----
# [arXiv:2405.09818]; modality frontend is token ids (stub per assignment).
_reg(
    ModelCfg(name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
             n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536,
             head_dim=128, qk_norm=True),
    ModelCfg(name="chameleon-34b", family="vlm", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=2, d_ff=256, vocab=512, head_dim=16,
             qk_norm=True, dtype="float32"),
)

# --- seamless-m4t-medium: enc-dec, audio frontend stubbed [arXiv:2308.11596]
_reg(
    ModelCfg(name="seamless-m4t-medium", family="encdec", n_layers=12,
             d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
             vocab=256206, head_dim=64, enc_layers=12, frontend="frames"),
    ModelCfg(name="seamless-m4t-medium", family="encdec", n_layers=2,
             d_model=128, n_heads=8, n_kv_heads=8, d_ff=256, vocab=512,
             head_dim=16, enc_layers=2, frontend="frames", dtype="float32"),
)

# --- llama4-scout-17b-a16e: MoE 16e top-1 + shared expert [hf:meta-llama] ---
_reg(
    ModelCfg(name="llama4-scout-17b-a16e", family="moe", n_layers=48,
             d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
             head_dim=128, layer_pattern=("e",), rope_theta=5e5,
             moe=MoECfg(n_experts=16, top_k=1, n_shared=1, d_ff_expert=8192)),
    ModelCfg(name="llama4-scout-17b-a16e", family="moe", n_layers=4,
             d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
             head_dim=16, layer_pattern=("e",), rope_theta=5e5,
             moe=MoECfg(n_experts=4, top_k=1, n_shared=1, d_ff_expert=256),
             dtype="float32"),
)

# --- deepseek-v3-671b: MLA, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437]
# d_ff=18432 is the dense-prefix/shared width of the public config; the
# assignment's d_ff=2048 is the per-routed-expert width.
_reg(
    ModelCfg(name="deepseek-v3-671b", family="moe", n_layers=61,
             d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
             vocab=129280, layer_pattern=("e",), mtp=True,
             mla=MLACfg(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                        v_dim=128),
             moe=MoECfg(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048,
                        first_dense=3)),
    ModelCfg(name="deepseek-v3-671b", family="moe", n_layers=5,
             d_model=128, n_heads=8, n_kv_heads=8, d_ff=384,
             vocab=512, layer_pattern=("e",), mtp=True,
             mla=MLACfg(q_lora=64, kv_lora=32, rope_dim=16, nope_dim=16,
                        v_dim=16),
             moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64,
                        first_dense=1),
             dtype="float32"),
)

# --- mamba2-2.7b: SSD, attention-free [arXiv:2405.21060] --------------------
_reg(
    ModelCfg(name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
             n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280, head_dim=64,
             layer_pattern=("m",),
             ssm=SSMCfg(d_state=128, head_dim=64, expand=2, conv_dim=4,
                        chunk=256)),
    ModelCfg(name="mamba2-2.7b", family="ssm", n_layers=4, d_model=128,
             n_heads=1, n_kv_heads=1, d_ff=0, vocab=512, head_dim=16,
             layer_pattern=("m",),
             ssm=SSMCfg(d_state=16, head_dim=16, expand=2, conv_dim=4,
                        chunk=16),
             dtype="float32"),
)

# --- zamba2-2.7b: Mamba2 backbone + 2 shared attn blocks [arXiv:2411.15242]
_reg(
    ModelCfg(name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
             n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
             layer_pattern=("m",), shared_attn_period=6, n_shared_blocks=2,
             shared_d_ff=10240,
             ssm=SSMCfg(d_state=64, head_dim=64, expand=2, conv_dim=4,
                        chunk=256)),
    ModelCfg(name="zamba2-2.7b", family="hybrid", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=8, d_ff=256, vocab=512, head_dim=16,
             layer_pattern=("m",), shared_attn_period=2, n_shared_blocks=2,
             shared_d_ff=256,
             ssm=SSMCfg(d_state=16, head_dim=16, expand=2, conv_dim=4,
                        chunk=16),
             dtype="float32"),
)

# --- repro-100m: in-house config for the end-to-end training example --------
_reg(
    ModelCfg(name="repro-100m", family="dense", n_layers=12, d_model=768,
             n_heads=12, n_kv_heads=12, d_ff=2048, vocab=32768, head_dim=64,
             tie_embeddings=True),
    ModelCfg(name="repro-100m", family="dense", n_layers=2, d_model=128,
             n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, head_dim=32,
             tie_embeddings=True, dtype="float32"),
)
