"""The dense LM architectures of ``repro.configs.archs``, same numbers.

Only the dense family is carried: the other families (MoE, SSM, hybrid,
audio, VLM) wait for their model modules (ROADMAP A.9); their names are
listed so ``get_config`` can say so.
"""
from __future__ import annotations

from .base import ArchConfig

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

ALL_ARCHS = (DEEPSEEK_7B, OLMO_1B, SMOLLM_360M, LLAMA3_8B)

# The reference's other architectures and their families (not ported).
UNPORTED_ARCHS = {
    "zamba2-7b": "hybrid", "mamba2": "hybrid", "rwkv6-7b": "ssm",
    "whisper-base": "audio", "granite-moe-1b-a400m": "moe",
    "llama4-maverick-400b-a17b": "moe", "llama-3.2-vision-11b": "vlm",
}
