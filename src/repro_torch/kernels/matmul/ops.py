"""Public wrapper for the scheduled matmul (counterpart of
``repro/kernels/matmul/ops.py``): schedule lookup, leading-batch-dim
folding, and the kernel / plain-version dispatch."""
from __future__ import annotations

import torch

from ...core.dataflow import Dataflow, choose_matmul_dataflow
from ...core.hw import TPU_V5E
from ..common import use_kernel
from .kernel import matmul_cuda, matmul_plan
from .ref import matmul_ref

__all__ = ["matmul", "launch_key"]


def _ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _clamp_block(block, M: int, K: int, N: int) -> tuple[int, int, int]:
    """The schedule's block cut to the product's extents, in multiples
    of 128 (what the kernel receives)."""
    bm, bk, bn = block
    return (min(bm, _ceil_mult(M, 128)), min(bk, _ceil_mult(K, 128)),
            min(bn, _ceil_mult(N, 128)))


def launch_key(M: int, K: int, N: int, dtype, *, dataflow: Dataflow,
               block: tuple[int, int, int],
               b_transposed: bool = False) -> tuple:
    """What one ``matmul`` call of an (M,K) x (K,N) product in ``dtype``
    launches under the schedule's ``dataflow`` and ``block``: two calls
    with equal keys make the same launches.  From ``matmul_plan``: the
    skinny path reads every weight byte once in any order and takes
    neither decision; the wgmma and simt paths take the dataflow's CTA
    raster, and the block only as the output-stationary raster's block
    of tiles (``csrc/matmul.cu::raster_args``).  The plan is taken for
    aligned operands, as the executor's are."""
    plan = matmul_plan(M, K, N, dtype, aligned=True,
                       b_transposed=b_transposed)
    key = ("matmul", str(dtype), M, K, N, b_transposed, plan)
    if plan.path == "skinny":
        return key
    if dataflow is not Dataflow.OUTPUT_STATIONARY:
        return key + (dataflow.value,)
    bm, _, bn = _clamp_block(block, M, K, N)
    tm, tn, _ = plan.tile
    return key + (dataflow.value, max(1, -(-bm // tm)),
                  max(1, -(-bn // tn)))


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
    block = _clamp_block(block, M, K, N)
    byp = None
    if bypass is not None:
        byp = bypass.reshape(-1, N).expand(M, N).contiguous()
    bt = (a.dtype == torch.bfloat16 and not b.is_contiguous()
          and b.T.is_contiguous())
    out = matmul_cuda(a2.contiguous(), b.T if bt else b.contiguous(),
                      dataflow=dataflow, block=block, bias=bias,
                      activation=activation, bypass=byp, b_transposed=bt)
    return out.reshape(*lead, N)

