"""The LM architectures of ``repro.configs.archs``, same numbers.

Every family of the reference is carried: dense, MoE (granite,
llama4), hybrid (zamba2, mamba2), ssm (rwkv6), audio (whisper) and vlm
(llama-3.2-vision, served on the legacy decode loop, as in the
reference).
"""
from __future__ import annotations

from .base import ArchConfig

ZAMBA2_7B = ArchConfig(
    # [arXiv:2411.15242; unverified] — Mamba2 backbone + shared attn blocks.
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6,
    attn_window=4096,        # TPU adaptation: windowed shared attention
    sub_quadratic=True,      # Mamba2 backbone -> long_500k runs
    source="arXiv:2411.15242")

MAMBA2 = ArchConfig(
    # [arXiv:2405.21060; unverified] — pure SSD backbone, no attention:
    # shared_attn_every=0 drops the hybrid family's shared block, so
    # every layer is one selective-scan mixer with O(1) decode state.
    name="mamba2", family="hybrid",
    n_layers=64, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=10240,
    vocab=50288, head_dim=128,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=0,
    sub_quadratic=True, source="arXiv:2405.21060")

DEEPSEEK_7B = ArchConfig(
    # [arXiv:2401.02954; hf] — llama-arch dense.
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab=102400, source="arXiv:2401.02954")

OLMO_1B = ArchConfig(
    # [arXiv:2402.00838; hf] — non-parametric LayerNorm.
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, norm="nonparametric", source="arXiv:2402.00838")

SMOLLM_360M = ArchConfig(
    # [hf:HuggingFaceTB/SmolLM-360M; hf] — small llama-arch, GQA 15/5.
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152, head_dim=64, source="hf:HuggingFaceTB/SmolLM-360M")

LLAMA3_8B = ArchConfig(
    # [arXiv:2407.21783; unverified] — GQA, 128k vocab.
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, rope_theta=500000.0, source="arXiv:2407.21783")

RWKV6_7B = ArchConfig(
    # [arXiv:2404.05892; hf] — Finch, attention-free, data-dependent decay.
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, head_dim=64, norm="layernorm",
    sub_quadratic=True, source="arXiv:2404.05892")

WHISPER_BASE = ArchConfig(
    # [arXiv:2212.04356; unverified] — enc-dec; conv frontend is a stub.
    name="whisper-base", family="audio",
    n_layers=6, n_encoder_layers=6, encoder_seq=1500,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    norm="layernorm", gated_mlp=False, activation="gelu",
    tie_embeddings=True, max_pos=32768, source="arXiv:2212.04356")

GRANITE_MOE_1B = ArchConfig(
    # [hf:ibm-granite/granite-3.0-1b-a400m-base; hf] — 32 experts top-8.
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, n_experts=32, top_k=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base")

LLAMA4_MAVERICK = ArchConfig(
    # [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — MoE 128e top-1.
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, n_experts=128, top_k=1, moe_every=2,
    rope_theta=500000.0, source="hf:meta-llama/Llama-4-Scout-17B-16E")

LLAMA32_VISION_11B = ArchConfig(
    # [hf:meta-llama/Llama-3.2-11B-Vision; unverified] — cross-attn image
    # layers every 5th layer; vision tower is a stub.
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, cross_attn_every=5, n_vision_tokens=1601,
    rope_theta=500000.0, source="hf:meta-llama/Llama-3.2-11B-Vision")

ALL_ARCHS = (ZAMBA2_7B, MAMBA2, DEEPSEEK_7B, OLMO_1B, SMOLLM_360M,
             LLAMA3_8B, RWKV6_7B, WHISPER_BASE, GRANITE_MOE_1B,
             LLAMA4_MAVERICK, LLAMA32_VISION_11B)
