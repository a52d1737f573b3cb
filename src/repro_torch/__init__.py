"""PyTorch/CUDA port of ``repro``, the compile-to-Program system.

Same layout and names as ``src/repro/``; imports torch and never jax,
nor anything of ``repro``.  Plain tensor code is PyTorch; each Pallas
kernel on a ported path is a CUDA kernel written for Hopper (sm_90a),
built at first use from ``kernels/csrc/``.
"""
