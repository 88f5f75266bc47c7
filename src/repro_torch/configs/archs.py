"""The 10 assigned architectures (exact configs from the assignment) plus the
paper's own CNN teacher/student zoo (see repro_torch.models.cnn for those).

The JAX package's ``configs/archs.py`` with the same numbers; the tiny
configs use ``torch.float32``. Each entry is selectable via --arch <id> in
``repro_torch.launch.serve``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, register

# --- MoE LMs ---------------------------------------------------------------
MOONSHOT = register(ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, n_experts=64, top_k=6,
))

GROK1 = register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, n_experts=8, top_k=2,
))

# --- dense LMs ---------------------------------------------------------------
PHI3_MINI = register(ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064,
))

TINYLLAMA = register(ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab=32000,
))

GRANITE = register(ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152,
))

LLAMA32_1B = register(ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=128256, rope_theta=500000.0,
))

# --- SSM ---------------------------------------------------------------------
MAMBA2_130M = register(ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    pos="none", subquadratic=True,
))

# --- VLM (backbone only; patch embeddings are a stub input) ------------------
QWEN2_VL = register(ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, pos="mrope", mrope_sections=(16, 24, 24),
    embed_inputs=True,
    # 28 heads don't divide the 16-wide model axis; param layout pads to 32
    # (4 inert heads, wo slice zeroed) so TP shards whole heads.
    pad_heads_to=32,
))

# --- hybrid (Jamba): attn:mamba = 1:7, MoE every other layer ------------------
JAMBA = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, n_experts=16, top_k=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    attn_period=8, moe_period=2, pos="none",  # jamba uses no rope on attn; keep rope off
    subquadratic=True,
))

# --- audio enc-dec (Whisper): conv frontend is a stub ------------------------
WHISPER_MEDIUM = register(ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, n_enc_layers=24, n_dec_layers=24,
    pos="sincos", norm="layernorm", act="gelu",
    embed_inputs=True,  # encoder consumes precomputed frame embeddings
))

ALL = [MOONSHOT, GROK1, PHI3_MINI, TINYLLAMA, GRANITE, LLAMA32_1B,
       MAMBA2_130M, QWEN2_VL, JAMBA, WHISPER_MEDIUM]


def tiny_version(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-tiny",
        n_layers=min(cfg.n_layers, 2 if cfg.family != "hybrid" else cfg.attn_period),
        d_model=128,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=512,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        attn_block_q=64, attn_block_kv=64, ssm_chunk=32,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2))
    if cfg.n_experts:
        kw["n_experts"] = 4
        kw["top_k"] = 2
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 32
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
        kw["n_dec_layers"] = 2
    if cfg.family == "hybrid":
        kw["n_layers"] = cfg.attn_period  # one full period
    if cfg.pos == "mrope":
        kw["mrope_sections"] = (4, 6, 6)  # sums to head_dim//2 = 16
    return cfg.with_(**kw)
