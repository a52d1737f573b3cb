"""Public WKV6 wrapper + decode step (counterpart of
``repro/kernels/rwkv6/ops.py``)."""
from __future__ import annotations

import torch

from ..common import use_kernel
from .kernel import wkv6_cuda
from .ref import wkv6_chunked, wkv6_ref

__all__ = ["wkv6", "wkv6_decode_step"]


def wkv6(r, k, v, w, u, *, s0=None, return_state: bool = False,
         impl: str = "auto"):
    """The WKV6 recurrence.  Shapes as in ref.py.

    impl: "auto" (the CUDA kernel on a CUDA tensor, the block-parallel
    ``wkv6_chunked`` on a CPU one) | "cuda" | "reference" (the chunked
    form) | "sequential" (the step-by-step oracle).  The reference's
    Pallas branch takes a VMEM chunk; the CUDA kernels take theirs from
    ``kernel.wkv_plan``."""
    if impl == "sequential":
        return wkv6_ref(r, k, v, w, u, s0=s0, return_state=return_state)
    if not use_kernel(impl, r):
        return wkv6_chunked(r, k, v, w, u, s0=s0, return_state=return_state)
    y, s_fin = wkv6_cuda(r, k, v, w, u, s0=s0)
    if return_state:
        return y, s_fin
    return y


def wkv6_decode_step(S, r_t, k_t, v_t, w_t, u):
    """One step for serving, in plain torch as in the reference.  S: (B,
    H, D, D); r/k/v/w_t: (B, H, D); u: (H, D).  Returns (y_t, S_new)."""
    Sf = S.float()
    rf, kf, vf, wf = (a.float() for a in (r_t, k_t, v_t, w_t))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhi,bhij->bhj",
                     rf, Sf + u.float()[None, :, :, None] * kv)
    S_new = wf[..., :, None] * Sf + kv
    return y.to(r_t.dtype), S_new
