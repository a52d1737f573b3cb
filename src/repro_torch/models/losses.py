"""Memory-efficient losses (counterpart of ``repro/models/losses.py``).

``chunked_cross_entropy`` never materialises the full (B, S, V) logits:
the head product and log-softmax run per sequence chunk under
``torch.utils.checkpoint``, so the backward pass recomputes each chunk's
logits instead of saving them (without saving the RNG state: nothing
here draws random numbers, and a CUDA graph cannot read it).  At smollm-360m's vocab (49152) and the
training shape (B = 8, S = 512, one 512-row chunk) a chunk's f32 logits
are 0.8 GB, which the backward recomputes instead of keeping.

With ``group`` (the split train step's vocab-parallel head,
``parallel/split.py``) ``head_w`` is the rank's block of vocab columns,
in the group's rank order, and each chunk's softmax is assembled over
the group: the local max all-reduced MAX (detached: it only steadies the
sum), the sum of exp(logits - max) and the gold logit (taken by the rank
whose block holds the label) each summed through ``from_model``; the
loss is max + log(sum) - gold, and autograd gives each rank its block of
softmax minus one-hot.  The hidden state enters through ``to_model``
once, before the chunks, so its gradient is summed over the group.  A
chunk's recompute in the backward pass re-issues its three all-reduces
in the same order on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..parallel.split import from_model, model_max, to_model

__all__ = ["chunked_cross_entropy"]


def _chunk_nll(hi, head_w, li, mi):
    logits = (hi @ head_w).float()                      # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mi)


def _chunk_nll_split(hi, head_w, li, mi, group):
    logits = (hi @ head_w).float()                      # (B, c, V / g)
    n = logits.shape[-1]
    m = model_max(logits.detach().amax(-1), group)
    s = from_model(torch.exp(logits - m[..., None]).sum(-1), group)
    t = li.long() - dist.get_rank(group) * n
    mine = (t >= 0) & (t < n)
    gold = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    gold = from_model(torch.where(mine, gold, torch.zeros_like(gold)), group)
    return torch.sum((m + torch.log(s) - gold) * mi)


def chunked_cross_entropy(h: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          mask: torch.Tensor | None = None,
                          group=None) -> torch.Tensor:
    """Mean token CE of ``h @ head_w`` against ``labels``.

    h: (B, S, D); head_w: (D, V), or with ``group`` the rank's (D, V / g)
    block of the vocab split over the g ranks of ``group`` (module
    docstring; a group of one is no split); labels: (B, S); mask: (B, S)
    or None.  S must not need padding: chunk is halved until it divides
    S.  The head product runs in the operands' dtype, the softmax in
    f32."""
    B, S, D = h.shape
    c = min(chunk, S)
    while S % c != 0:
        c //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    mask = mask.float()
    nll, extra = _chunk_nll, ()
    if group is not None and dist.get_world_size(group) > 1:
        h = to_model(h, group)
        nll, extra = _chunk_nll_split, (group,)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, c):
        total = total + checkpoint(
            nll, h[:, s0:s0 + c], head_w, labels[:, s0:s0 + c],
            mask[:, s0:s0 + c], *extra, use_reentrant=False,
            preserve_rng_state=False)
    return total / torch.clamp(mask.sum(), min=1.0)
