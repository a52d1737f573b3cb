"""Plain PyTorch oracles for single-token KV-cache decode attention,
contiguous and paged (counterparts of
``repro/kernels/decode_attention/ref.py`` and of the reference path of
its ``ops.py::paged_decode_attention``)."""
from __future__ import annotations

import torch

__all__ = ["decode_attention_ref", "gather_pages",
           "paged_decode_attention_ref"]

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


def gather_pages(pages, table, scale=None) -> torch.Tensor:
    """The contiguous (B, Hkv, S, D) cache view of a page pool through a
    page table -- THE table-indirection rule, the plain version's half
    of the paged decode.

    pages: (n_pages, page_size, Hkv, D) pool, any dtype; int8 pools are
    dequantized in float32 when ``scale`` -- per-page (n_pages,) float32
    -- is given.  table: (B, pages_per_slot) int.  Row ``s`` of slot
    ``b`` is pool row ``(table[b, s // page_size], s % page_size)``; the
    null page 0 supplies whatever masked writes left there, which only
    backs rows past the caller's ``kv_len``."""
    idx = table.long()
    gathered = pages[idx]        # (B, pages_per_slot, page_size, Hkv, D)
    if scale is not None:
        gathered = gathered.float() * scale[idx][:, :, None, None, None]
    B, P, G, Hkv, D = gathered.shape
    return gathered.reshape(B, P * G, Hkv, D).transpose(1, 2)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, *, kv_len,
                               scale: float | None = None, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Paged decode as ``gather_pages`` + ``decode_attention_ref``, the
    reference's ``impl="reference"`` path."""
    k = gather_pages(k_pages, page_table, k_scale)
    v = gather_pages(v_pages, page_table, v_scale)
    return decode_attention_ref(q, k, v, kv_len=kv_len, scale=scale)
