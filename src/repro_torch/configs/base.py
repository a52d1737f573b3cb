"""Architecture configuration, after ``repro.configs.base``.

``ArchConfig`` carries the LM configs (every field the reference has, so
the registry entries read the same); ``CNNConfig`` the paper's own CNNs.
``smoke()`` derives the reduced same-family config the CPU tests use;
``ShapeSpec`` names an input shape (a training run's batch and length)
and ``LM_SHAPES`` the reference's assigned cells, which ``shapes()``
filters by ``sub_quadratic`` (the sharding plan's inputs).
The reference's ``jdtype`` / ``kv_jdtype`` are ``tdtype`` /
``kv_tdtype`` here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

__all__ = ["ArchConfig", "ShapeSpec", "LM_SHAPES", "CNNLayer", "CNNConfig"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_KV_DTYPES = dict(_DTYPES, float8=torch.float8_e4m3fn)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    # MoE.
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1
    # SSM (Mamba2).
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # Hybrid (zamba2): shared attention block applied every N layers.
    shared_attn_every: int = 0
    attn_window: int | None = None       # sliding window for the attn block
    # Encoder-decoder (whisper): n_layers is the decoder depth.
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # VLM: a cross-attention sub-block every N layers.
    cross_attn_every: int = 0
    n_vision_tokens: int = 0
    # Norm / misc.
    norm: str = "rmsnorm"                # rmsnorm | layernorm | nonparametric
    gated_mlp: bool = True
    activation: str = "silu"
    rope_theta: float = 10000.0
    max_pos: int = 0                     # >0: learned absolute positions
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_dtype: str = ""                   # "" -> same as dtype; "float8"
    sub_quadratic: bool = False          # True -> long_500k runnable
    source: str = ""                     # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype of ``dtype`` (``repro``'s ``jdtype``)."""
        return _DTYPES[self.dtype]

    @property
    def kv_tdtype(self) -> torch.dtype:
        """The KV-cache dtype (``repro``'s ``kv_jdtype``); float8 is
        ``torch.float8_e4m3fn``."""
        if not self.kv_dtype:
            return self.tdtype
        return _KV_DTYPES[self.kv_dtype]

    def n_params(self) -> float:
        """Analytic parameter count (embeddings included once)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        qkv = D * (self.n_heads + 2 * self.n_kv_heads) * self.hd
        o = self.n_heads * self.hd * D
        glu = 3 if self.gated_mlp else 2
        if self.family == "ssm":     # rwkv6-style
            block = 6 * D * D + 2 * D * F
        elif self.family == "hybrid":   # mamba2 backbone
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            block = D * (2 * di + 2 * N + H) + di * D
        else:
            dense_mlp = glu * D * F
            if self.n_experts:
                n_moe = L // self.moe_every
                mlp_total = (n_moe * (dense_mlp * self.n_experts
                                      + D * self.n_experts)
                             + (L - n_moe) * dense_mlp)
                block = qkv + o + mlp_total / L
            else:
                block = qkv + o + dense_mlp
        total = L * block + V * D * (1 if self.tie_embeddings else 2)
        if self.shared_attn_every:
            total += qkv + o + 3 * D * F
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (qkv + o + 2 * D * F)
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (qkv + o)
        return float(total)

    def n_active_params(self) -> float:
        """Parameters one token reads: an MoE layer counts its top-k
        experts' MLPs, not all of them."""
        if not self.n_experts:
            return self.n_params()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        glu = 3 if self.gated_mlp else 2
        n_moe = L // self.moe_every
        dense = dataclasses.replace(self, n_experts=0, top_k=0)
        return float(dense.n_params() - n_moe * glu * D * F
                     + n_moe * glu * D * F * self.top_k)

    def shapes(self) -> tuple[ShapeSpec, ...]:
        """The assigned cells of this arch: ``long_500k`` only for a
        sub-quadratic one."""
        return tuple(s for s in LM_SHAPES
                     if s.name != "long_500k" or self.sub_quadratic)

    def skipped_shapes(self) -> tuple[str, ...]:
        return () if self.sub_quadratic else ("long_500k",)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        def shrink(v, lo, hi):
            return max(lo, min(v, hi))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=shrink(self.n_layers, 2, 4),
            d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2)
            if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq=16 if self.n_encoder_layers else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            dtype="float32",
        )


@dataclass(frozen=True)
class CNNLayer:
    kind: str            # conv | maxpool | avgpool | fc
    c_out: int = 0
    k: int = 1
    stride: int = 1
    pad: int = 0
    activation: str | None = "relu"
    bypass_of: int | None = None   # layer index whose output is added
    bypass_first: bool = True      # ResNet order: add bypass, then ReLU
    input_of: int | None = None    # take input from this layer (default:
                                   # the previous one); enables parallel
                                   # paths like projection shortcuts


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_ch: int
    layers: tuple[CNNLayer, ...]
    n_classes: int = 1000
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype of ``dtype`` (``repro``'s ``jdtype``)."""
        return _DTYPES[self.dtype]
