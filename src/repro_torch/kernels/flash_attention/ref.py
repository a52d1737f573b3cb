"""Plain PyTorch oracle for flash attention (counterpart of
``repro/kernels/flash_attention/ref.py::flash_ref``).

Layout: q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA
by grouping, never by repeating KV).  Causal masking and a causal
sliding window of size W (query i attends keys in (i-W, i]); keys at
``>= kv_len`` are masked.  The reference's chunked online softmax is
kept (same chunk, same -1e30 mask, same 1e-30 clamp), forward only: the
backward comes with training (ROADMAP A.10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flash_ref"]

NEG_INF = -1e30


def _mask(sk0: int, sq: int, bk: int, causal: bool, window: int | None,
          kv_len: int | None, device) -> torch.Tensor:
    """(sq, bk) additive mask for the key chunk at ``sk0``."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = sk0 + torch.arange(bk, device=device)[None, :]
    ok = torch.ones((sq, bk), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    if kv_len is not None:
        ok &= ki < kv_len
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def flash_ref(q, k, v, *, scale: float | None = None, causal: bool = False,
              window: int | None = None, kv_len: int | None = None,
              chunk: int = 512, return_lse: bool = False):
    """Chunked flash attention in f32, cast back to q's dtype.  With
    ``return_lse`` also the per-row logsumexp (B, Hq, Sq) in f32."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    chunk = min(chunk, Skv)
    if Skv % chunk:
        pad = chunk - Skv % chunk
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        kv_len = kv_len if kv_len is not None else Skv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    for sk0 in range(0, k.shape[2], chunk):
        kj = k[:, :, sk0:sk0 + chunk].float()
        vj = v[:, :, sk0:sk0 + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj) * scale
        s = s + _mask(sk0, Sq, chunk, causal, window, kv_len, q.device)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vj)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).reshape(B, Hq, Sq, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, Sq)
    return out
