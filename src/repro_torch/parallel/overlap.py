"""Compute/communication overlap primitives: the ring collective matmuls
(counterpart of ``repro/parallel/overlap.py``).

The paper splits DMA transfers into chunks so loads hide under MAC
latency; the interconnect's analogue is the collective matmul: instead
of one blocking all-gather of the weight shards followed by one big
matmul, the ring is walked one shard at a time, each hop's transfer
posted (``dist.batch_isend_irecv``) before the partial product it
overlaps.  Every partial product goes through the port's
``kernels.matmul`` op, so on the card each ring step runs the
hand-written matmul kernel.

The reference runs these inside ``shard_map`` over a named mesh axis
(``parallel/compat.py`` carries that API across jax versions).  Here
each rank runs its own body, so there is no ``shard_map`` and nothing to
carry: the axis is the process group of one mesh dimension
(``DeviceMesh.get_group``), and ``placement.group_size_rank`` gives its
size and this rank's place in it.  At a group of one the ring is a single product with no
transfer.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.matmul import matmul
from .placement import group_size_rank

__all__ = ["all_gather_matmul", "matmul_reduce_scatter"]


def _shift(t: torch.Tensor, group, g: int, idx: int):
    """Post the ring hop of ``t`` (to the next rank, from the previous
    one); returns (the receive buffer, the pending requests)."""
    recv = torch.empty_like(t)
    nxt = dist.get_global_rank(group, (idx + 1) % g)
    prv = dist.get_global_rank(group, (idx - 1) % g)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, nxt, group),
                                   dist.P2POp(dist.irecv, recv, prv, group)])
    return recv, reqs


def all_gather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group, *,
                      impl: str = "auto") -> torch.Tensor:
    """x (M, K) the same on every rank of ``group``; w_shard (K, N/g)
    this rank's column block.

    Computes ``x @ W_full`` (M, N) with the weight all-gather unrolled
    around the ring: each step posts the hop of the shard in hand, then
    multiplies it, so the transfer overlaps the product -- the
    weight-gathered (ICI-Kloop) execution with T4 chunking applied."""
    g, idx = group_size_rank(group)
    M, Nl = x.shape[0], w_shard.shape[1]
    buf = torch.empty((M, Nl * g), dtype=x.dtype, device=x.device)
    w, own = w_shard.contiguous(), idx
    for step in range(g):
        pending = _shift(w, group, g, idx) if step != g - 1 else None
        buf[:, own * Nl:(own + 1) * Nl] = matmul(x, w, impl=impl)
        if pending is not None:
            w, reqs = pending
            for r in reqs:
                r.wait()
        own = (own - 1) % g
    return buf


def matmul_reduce_scatter(x_shard: torch.Tensor, w_shard: torch.Tensor,
                          group, *, impl: str = "auto") -> torch.Tensor:
    """x_shard (M, K/g) this rank's columns of X; w_shard (K/g, N) its
    rows of W.

    Computes the K-contracted ``X_full @ W_full`` reduce-scattered over
    N: returns this rank's (M, N/g) slice.  The ring accumulates the
    partial products (each in x's type, summed in f32) while they
    travel; each hop's transfer overlaps the next partial product (the
    activation-gathered / ICI-Mloop direction)."""
    g, idx = group_size_rank(group)
    N = w_shard.shape[1]
    assert N % g == 0, (N, g)
    Nl = N // g
    acc = torch.zeros((x_shard.shape[0], Nl), dtype=torch.float32,
                      device=x_shard.device)
    for step in range(g):
        # The accumulator visiting this rank at step t ends its journey
        # at the rank that owns slice (idx - step - 1): every visitor
        # adds its partial for that slice.
        target = (idx - step - 1) % g
        w_slice = w_shard[:, target * Nl:(target + 1) * Nl].contiguous()
        acc = acc + matmul(x_shard, w_slice, impl=impl).float()
        if step != g - 1:
            acc, reqs = _shift(acc, group, g, idx)
            for r in reqs:
                r.wait()
    return acc.to(x_shard.dtype)
