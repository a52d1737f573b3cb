"""Plain PyTorch oracle for single-token KV-cache decode attention
(counterpart of ``repro/kernels/decode_attention/ref.py``)."""
from __future__ import annotations

import torch

__all__ = ["decode_attention_ref"]

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, kv_len=None,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, D) one new token; k, v: (B, Hkv, S, D) cache; kv_len:
    (B,) valid lengths or None for the full cache.  Ring-cache contract
    (see ops.py): rows at slots ``>= kv_len`` are masked to -1e30."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    if kv_len is not None:
        mask = (torch.arange(S, device=q.device)[None, :]
                < kv_len.to(q.device)[:, None])                  # (B, S)
        s = torch.where(mask[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return o.reshape(B, Hq, D).to(q.dtype)
