"""Kernels: each Pallas kernel of a ported path becomes a CUDA kernel
written for Hopper, beside its plain PyTorch version."""
from .conv2d import avgpool2d_ref, conv2d, conv2d_ref, maxpool2d_ref
from .matmul import matmul, matmul_ref

__all__ = ["conv2d", "conv2d_ref", "maxpool2d_ref", "avgpool2d_ref",
           "matmul", "matmul_ref"]
