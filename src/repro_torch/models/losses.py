"""Memory-efficient losses (counterpart of ``repro/models/losses.py``).

``chunked_cross_entropy`` never materialises the full (B, S, V) logits:
the head product and log-softmax run per sequence chunk under
``torch.utils.checkpoint``, so the backward pass recomputes each chunk's
logits instead of saving them (without saving the RNG state: nothing
here draws random numbers, and a CUDA graph cannot read it).  At smollm-360m's vocab (49152) and the
training shape (B = 8, S = 512, one 512-row chunk) a chunk's f32 logits
are 0.8 GB, which the backward recomputes instead of keeping.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_cross_entropy"]


def _chunk_nll(hi, head_w, li, mi):
    logits = (hi @ head_w).float()                      # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mi)


def chunked_cross_entropy(h: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token CE of ``h @ head_w`` against ``labels``.

    h: (B, S, D); head_w: (D, V); labels: (B, S); mask: (B, S) or None.
    S must not need padding: chunk is halved until it divides S.  The
    head product runs in the operands' dtype, the softmax in f32."""
    B, S, D = h.shape
    c = min(chunk, S)
    while S % c != 0:
        c //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    mask = mask.float()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, c):
        total = total + checkpoint(
            _chunk_nll, h[:, s0:s0 + c], head_w, labels[:, s0:s0 + c],
            mask[:, s0:s0 + c], use_reentrant=False,
            preserve_rng_state=False)
    return total / torch.clamp(mask.sum(), min=1.0)
