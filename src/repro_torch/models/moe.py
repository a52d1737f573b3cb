"""Capacity-bounded top-k MoE dispatch (counterpart of the single-device
body of ``repro/models/moe.py``: ``_moe_local`` and ``moe_mlp``).

The router runs in f32: softmax, top-k, renormalised gate weights.  Each
(token, choice) pair takes a rank inside its expert by a stable sort of
the expert ids; pairs ranked at or past the expert's capacity (the
paper's load-balancing bound, ``core/balance.py::moe_capacity``) are
dropped onto a sentinel row.  The kept rows are scattered into an
``(E * cap + 1, D)`` buffer, the expert FFN runs as batched products
over ``(E, cap, D)`` with f32 accumulation (the reference's
``preferred_element_type=f32``), and the outputs are gathered back and
summed with the gate weights.

Every shape is static and nothing is read back to the host, so a CUDA
graph can capture the dispatch: the counts are a ``scatter_add_`` into
``E + 1`` bins (``torch.bincount`` sizes its output from the data), the
pad rows of a right-padded prefill route to the sentinel expert ``E``
through ``torch.where`` (no boolean-mask indexing), and the prefill's
``valid_count`` and the capacity it implies stay device tensors.

Under a sharded step's mesh (``parallel.activation_rules``, installed by
``launch/steps.py``) the dispatch follows the reference's choice.  When
the batch axes ("pod", "data") hold more than one shard and each of
their blocks has at least ``max(top_k, 256)`` tokens, the reference
dispatches every block on its own, with that block's capacity
(``_moe_local(..., axes=dp)`` under ``shard_map``), and averages the
statistics over the blocks: a rank whose rows are whole blocks does the
same with no communication.  Otherwise the reference dispatches every
token at once, and a token's capacity and drops depend on every rank's
tokens: the rank gathers the rows of its batch group (``_gather_rows``,
an all-gather autograd sees through, whose backward sums the row
gradients of every rank) and dispatches them all -- or the one block
that holds its rows, where a block spans several ranks -- and keeps its
own rows.  The statistics returned are the rank's blocks' (or the
gathered dispatch's); their mean over the batch group, which the loss
takes by averaging the ranks' losses, is the reference's.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..core.balance import moe_capacity
from ..kernels.common import apply_activation
from ..parallel.act_sharding import current_rules, mesh_sizes
from ..parallel.placement import gather_dim, group_size_rank, mesh_group

__all__ = ["moe_mlp"]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with f32 accumulation and an f32 result."""
    return torch.bmm(a.float(), b.float())


class _GatherRows(torch.autograd.Function):
    """All-gather of the rows of ``x`` over ``group``, in group order;
    the backward sums the gathered gradient over the group and returns
    this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        _, i = group_size_rank(group)
        ctx.group, ctx.rows = group, (i * x.shape[0], x.shape[0])
        return gather_dim(x, 0, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(0, *ctx.rows), None


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherRows.apply(x, group)


def _block_mean(auxs: list) -> dict:
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, activation: str = "silu",
            gated: bool = True, valid_count=None):
    """x: (T, D); router_w: (D, E); w_gate / w_up: (E, D, F); w_down:
    (E, F, D).  Under a sharded step's mesh x is this rank's rows of the
    global (T_global, D) (module docstring).

    ``valid_count`` (an int or an int tensor of one element on x's
    device) marks x as right-padded: only its first ``valid_count`` rows
    are tokens.  Pad rows then claim no expert capacity, and the
    capacity is re-derived at the true token count, so the kept rows
    are bucketed as in an unpadded call.

    Returns (out (T, D) in x's dtype, aux): ``lb_loss`` (the
    load-balance loss), ``imbalance_pct`` (the busiest expert's load
    over the mean, in percent) and ``dropped_frac`` (the share of
    (token, choice) pairs past capacity), each a 0-d f32 tensor."""
    fn = functools.partial(_moe_local, router_w=router_w, w_gate=w_gate,
                           w_up=w_up, w_down=w_down, top_k=top_k,
                           capacity_factor=capacity_factor,
                           activation=activation, gated=gated)
    rules = current_rules()
    if rules is None or rules.mesh is None or valid_count is not None:
        return fn(x, valid_count=valid_count)
    sizes = mesh_sizes(rules.mesh)
    S = sizes.get("pod", 1) * sizes.get("data", 1)
    group = mesh_group(rules.mesh, rules.batch_axes)
    n, i = group_size_rank(group)
    rows = x.shape[0]
    T = rows * n
    if S > 1 and T % S == 0 and T // S >= max(top_k, 256):
        bs = T // S
        if rows % bs == 0:          # whole blocks: each on its own
            outs, auxs = zip(*(fn(blk) for blk in x.split(bs)))
            return torch.cat(outs), _block_mean(list(auxs))
        b, off = divmod(i * rows, bs)   # part of block b, from row off
        out, aux = fn(_gather_rows(x, group).narrow(0, b * bs, bs))
        return out.narrow(0, off, rows), aux
    out, aux = fn(_gather_rows(x, group))
    return out.narrow(0, i * rows, rows), aux


def _moe_local(x, *, router_w, w_gate, w_up, w_down, top_k,
               capacity_factor, activation, gated, valid_count=None):
    """Dispatch + expert FFN on one token block (the reference's
    ``_moe_local``): (out, aux)."""
    T, D = x.shape
    E = router_w.shape[-1]
    dev = x.device
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    cap = min(moe_capacity(T, E, top_k, capacity_factor)
              .capacity_per_expert, T)
    flat_e = top_e.reshape(-1)                              # (T*k,)
    eff_cap = cap
    if valid_count is not None:
        vc = torch.as_tensor(valid_count, device=dev).to(
            torch.int32).reshape(())
        mean = vc.float() * top_k / E
        dyn = torch.clamp(torch.ceil(mean * capacity_factor / 8.0) * 8.0,
                          min=8.0)
        eff_cap = torch.minimum(dyn.to(torch.int32), vc)
        tok_valid = torch.arange(T, device=dev) < vc
        flat_e = torch.where(tok_valid[:, None].expand(T, top_k).reshape(-1),
                             flat_e, torch.full_like(flat_e, E))
    n = T * top_k
    order = torch.argsort(flat_e, stable=True)
    counts_full = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    counts_full.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts_full, 0) - counts_full
    ranks_sorted = torch.arange(n, device=dev) - offsets[flat_e[order]]
    ranks = torch.zeros(n, dtype=torch.int64, device=dev).scatter(
        0, order, ranks_sorted)
    counts = counts_full[:E]
    keep = (ranks < eff_cap) & (flat_e < E)
    slot = torch.where(keep, flat_e * cap + ranks,
                       torch.full_like(ranks, E * cap))

    x_rep = x[:, None].expand(T, top_k, D).reshape(n, D)
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=dev)
    buf = buf.index_put((slot,), x_rep)
    ebuf = buf[:E * cap].reshape(E, cap, D)

    h = apply_activation(_bmm_f32(ebuf, w_gate), activation)
    if gated:
        h = h * _bmm_f32(ebuf, w_up)
    out_e = _bmm_f32(h.to(x.dtype), w_down)                 # (E, cap, D)
    flat_out = torch.cat([out_e.reshape(E * cap, D),
                          torch.zeros((1, D), dtype=torch.float32,
                                      device=dev)])
    gathered = flat_out[slot] * top_p.reshape(-1)[:, None]
    out = gathered.reshape(T, top_k, D).sum(dim=1).to(x.dtype)

    g_counts = counts.float()
    frac_probs = probs.mean(dim=0)
    mean_load = torch.clamp(g_counts.mean(), min=1e-9)
    imbalance = (g_counts.max() / mean_load - 1.0) * 100.0
    frac_tokens = g_counts / torch.clamp(g_counts.sum(), min=1.0)
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    dropped = 1.0 - keep.float().mean()
    return out, {"lb_loss": lb_loss, "imbalance_pct": imbalance,
                 "dropped_frac": dropped}
