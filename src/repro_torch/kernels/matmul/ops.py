"""Public wrapper for the scheduled matmul (counterpart of
``repro/kernels/matmul/ops.py``): schedule lookup, leading-batch-dim
folding, and the kernel / plain-version dispatch."""
from __future__ import annotations

import torch

from ...core.dataflow import Dataflow, choose_matmul_dataflow
from ...core.hw import TPU_V5E
from ..common import use_kernel
from .kernel import matmul_cuda
from .ref import matmul_ref

__all__ = ["matmul"]


def _ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           bias: torch.Tensor | None = None,
           activation: str | None = None,
           bypass: torch.Tensor | None = None,
           impl: str = "auto",
           dataflow: Dataflow | None = None,
           block: tuple[int, int, int] | None = None) -> torch.Tensor:
    """``epilogue(a @ b)`` with schedule-driven tiling.

    a: (..., K); b: (K, N); bias: (N,); bypass: broadcastable to out.
    impl: "auto" (kernel on a CUDA tensor, plain version on a CPU one) |
    "cuda" | "reference".  Without the schedule's ``dataflow`` and
    ``block`` they are chosen for ``TPU_V5E``, the hardware the port's
    Programs are compiled for.  The kernel takes float32 or bfloat16,
    with b, bias and bypass in ``a``'s type, the output's.  A bf16 ``b``
    that is the transpose of a contiguous (N, K) tensor (a tied head's
    ``embed.T``) reaches the kernel as that tensor, read transposed,
    never copied.
    """
    if not use_kernel(impl, a):
        return matmul_ref(a, b, bias=bias, activation=activation,
                          bypass=bypass)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    M, K = a2.shape
    N = b.shape[-1]
    if dataflow is None or block is None:
        dec = choose_matmul_dataflow(M, K, N, a.element_size(), TPU_V5E)
        dataflow = dataflow or dec.dataflow
        block = block or (dec.tiling.bm, dec.tiling.bk, dec.tiling.bn)
    bm, bk, bn = block
    block = (min(bm, _ceil_mult(M, 128)), min(bk, _ceil_mult(K, 128)),
             min(bn, _ceil_mult(N, 128)))
    byp = None
    if bypass is not None:
        byp = bypass.reshape(-1, N).expand(M, N).contiguous()
    bt = (a.dtype == torch.bfloat16 and not b.is_contiguous()
          and b.T.is_contiguous())
    out = matmul_cuda(a2.contiguous(), b.T if bt else b.contiguous(),
                      dataflow=dataflow, block=block, bias=bias,
                      activation=activation, bypass=byp, b_transposed=bt)
    return out.reshape(*lead, N)

