"""Public Mamba2 scan wrapper: dispatch, D-skip, decode step
(counterpart of ``repro/kernels/mamba2/ops.py``)."""
from __future__ import annotations

import torch

from ..common import use_kernel
from .kernel import mamba2_scan_cuda
from .ref import mamba2_scan_chunked, mamba2_scan_ref

__all__ = ["mamba2_scan", "mamba2_decode_step"]


def mamba2_scan(x, dt, A, B, C, *, D_skip=None, h0=None,
                return_state: bool = False, impl: str = "auto",
                chunk: int = 256):
    """Selective state-space scan.  Shapes as in ref.py.

    impl: "auto" (the CUDA kernel on a CUDA tensor, the block-parallel
    ``mamba2_scan_chunked`` on a CPU one) | "cuda" | "reference" (the
    chunked form, in chunks of ``min(chunk, 256)``) | "sequential" (the
    step-by-step oracle).  The kernels take their chunk from
    ``kernel.ssd_plan`` and need none to divide L.  Their branch adds
    D-skip after the kernel as the reference's Pallas branch does: the
    product in f32, rounded to y's type, then added."""
    if impl == "sequential":
        return mamba2_scan_ref(x, dt, A, B, C, D_skip=D_skip, h0=h0,
                               return_state=return_state)
    if not use_kernel(impl, x):
        return mamba2_scan_chunked(x, dt, A, B, C, D_skip=D_skip, h0=h0,
                                   return_state=return_state,
                                   chunk=min(chunk, 256))
    y, h_fin = mamba2_scan_cuda(x, dt, A, B, C, h0=h0)
    if D_skip is not None:
        y = y + (D_skip.float()[None, None, :, None]
                 * x.float()).to(y.dtype)
    if return_state:
        return y, h_fin
    return y


def mamba2_decode_step(h, x_t, dt_t, A, B_t, C_t, *, D_skip=None):
    """One recurrence step for serving.  h: (Bt, H, N, P); x_t: (Bt, H, P);
    dt_t: (Bt, H); B_t, C_t: (Bt, N).  Returns (y_t, h_new)."""
    hf, xf, dtf = h.float(), x_t.float(), dt_t.float()
    decay = torch.exp(A.float()[None, :] * dtf)                    # (Bt, H)
    dBx = torch.einsum("bn,bhp->bhnp", B_t.float(), xf * dtf[..., None])
    h_new = hf * decay[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), h_new)
    if D_skip is not None:
        y = y + D_skip.float()[None, :, None] * xf
    return y.to(x_t.dtype), h_new
