"""Public flash-attention wrapper (counterpart of
``repro/kernels/flash_attention/ops.py``): the schedule's blocks, the
reference's padding rule, and the kernel / plain-version dispatch.

The (block_q, block_kv) pair is the TPU schedule's VMEM block (about
512 x 512 at the smollm-360m prefill).  It is taken verbatim for the
reference's padding rule -- ``block_q`` falls back to 128 when it does
not divide ``Sq``, q and kv are zero-padded to block multiples, and
padded keys are masked through ``kv_len`` -- while the CUDA kernel cuts
the work into its own 64 x 64 CTA tiles (``csrc/flash_attention.cu``).

On a CUDA tensor the call goes through ``_FlashTrainable``, the
counterpart of the reference's ``_flash_trainable`` custom VJP: its
forward is the forward kernel, keeping the logsumexp, and its backward
the backward kernel (``csrc/flash_attention_bwd.cu``).  ``F.pad`` carries
the gradient back through the padding; padded keys stay masked through
``kv_len`` in the backward as in the forward.  Under ``torch.no_grad()``
(serving) only the forward kernel runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.hw import TPU_V5E, HardwareModel
from ..common import use_kernel
from .bwd_kernel import flash_attention_bwd_cuda
from .kernel import flash_attention_cuda, flash_plan
from .ref import flash_ref

__all__ = ["flash_attention", "attention_block_sizes", "launch_key"]


class _FlashTrainable(torch.autograd.Function):
    """The forward kernel, differentiable through the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, kv_len):
        out, lse = flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                        window=window, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(scale=scale, causal=causal, window=window,
                        kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:            # the kernel reads D contiguous
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                              **ctx.args)
        return dq, dk, dv, None, None, None, None


def attention_block_sizes(Sq: int, Skv: int, D: int, dtype_bytes: int,
                          hw: HardwareModel = TPU_V5E, *,
                          window: int | None = None) -> tuple[int, int]:
    """(block_q, block_kv) from the compiler's chooser
    (core/tiling.py::select_attention_blocks), as the reference picks
    them for a direct (non-Program) call."""
    from ...core.tiling import select_attention_blocks
    return select_attention_blocks(Sq, Skv, D, dtype_bytes, hw,
                                   window=window)


def _pads(Sq: int, Skv: int, block_q: int, block_kv: int):
    """(q rows, kv rows) the reference's padding rule adds: ``block_q``
    falls back to 128 where it does not divide ``Sq``."""
    block_q = min(block_q, Sq) if Sq % min(block_q, Sq) == 0 else 128
    return (-Sq) % block_q, (-Skv) % block_kv


def launch_key(q_shape, kv_shape, dtype, *, causal: bool,
               window: int | None, kv_len: int | None, block_q: int,
               block_kv: int) -> tuple:
    """What one ``flash_attention`` call on CUDA tensors launches for q
    (B,Hq,Sq,D) and k, v (B,Hkv,Skv,D) in ``dtype`` under the schedule's
    blocks: two calls with equal keys make the same launches.  The
    kernel cuts its own 64-row tiles (``flash_plan``), so the blocks
    reach it only through the padding rule (``_pads``): blocks that pad
    alike are one launch.  The plan is taken for aligned operands, as a
    padded copy is."""
    pad_q, pad_kv = _pads(q_shape[2], kv_shape[2], block_q, block_kv)
    qs = (*q_shape[:2], q_shape[2] + pad_q, q_shape[3])
    kvs = (*kv_shape[:2], kv_shape[2] + pad_kv, kv_shape[3])
    if pad_kv and kv_len is None:
        kv_len = kv_shape[2]             # the padded keys are masked
    return ("flash_attention", str(dtype), qs, kvs, causal, window, kv_len,
            flash_plan(qs, kvs, dtype))


def flash_attention(q, k, v, *, scale: float | None = None,
                    causal: bool = False, window: int | None = None,
                    kv_len: int | None = None, impl: str = "auto",
                    block_q: int | None = None, block_kv: int | None = None,
                    hw: HardwareModel = TPU_V5E):
    """Softmax attention, q (B,Hq,Sq,D), kv (B,Hkv,Skv,D) -> (B,Hq,Sq,D).

    impl: "auto" (kernel on a CUDA tensor, plain version on a CPU one) |
    "cuda" | "reference".  The default scale is ``D ** -0.5``.  Both
    paths are differentiable in q, k and v: the kernel path through the
    backward kernel, the plain one through ``flash_ref``'s recompute."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if not use_kernel(impl, q):
        return flash_ref(q, k, v, scale=scale, causal=causal, window=window,
                         kv_len=kv_len)
    Sq, Skv = q.shape[2], k.shape[2]
    if block_q is None or block_kv is None:
        bq, bkv = attention_block_sizes(Sq, Skv, D, q.element_size(), hw,
                                        window=window)
        block_q = block_q or bq
        block_kv = block_kv or bkv
    pad_q, pad_kv = _pads(Sq, Skv, block_q, block_kv)
    if pad_kv and kv_len is None:
        kv_len = Skv
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, pad_kv))
    out = _FlashTrainable.apply(q, k, v, scale, causal, window, kv_len)
    return out[:, :, :Sq] if pad_q else out
