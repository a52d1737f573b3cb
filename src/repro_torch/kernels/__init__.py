"""Kernels: each Pallas kernel of a ported path becomes a CUDA kernel
written for Hopper, beside its plain PyTorch version."""
from .conv2d import avgpool2d_ref, conv2d, conv2d_ref, maxpool2d_ref
from .decode_attention import (decode_attention, decode_attention_ref,
                               ring_kv_len, ring_positions)
from .flash_attention import flash_attention, flash_ref
from .matmul import matmul, matmul_ref

__all__ = ["conv2d", "conv2d_ref", "maxpool2d_ref", "avgpool2d_ref",
           "matmul", "matmul_ref", "flash_attention", "flash_ref",
           "decode_attention", "decode_attention_ref", "ring_kv_len",
           "ring_positions"]
