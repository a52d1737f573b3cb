"""Plain PyTorch oracle for flash attention (counterpart of
``repro/kernels/flash_attention/ref.py::flash_ref``).

Layout: q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA
by grouping, never by repeating KV).  Causal masking and a causal
sliding window of size W (query i attends keys in (i-W, i]); keys at
``>= kv_len`` are masked.  The reference's chunked online softmax is
kept (same chunk, same -1e30 mask, same 1e-30 clamp).  ``flash_ref`` is
differentiable as the reference's is: a ``torch.autograd.Function``
whose backward recomputes each chunk's probabilities from the saved
logsumexp (``_flash_bwd``, the reference's ``_flash_bwd``) instead of
keeping them.  ``flash_bwd_ref`` is that backward as a plain function,
which the CUDA backward kernel is held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flash_ref", "flash_bwd_ref"]

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


def _flash_fwd(q, k, v, scale, causal, window, kv_len, chunk):
    """The chunked online softmax: (out in q's dtype, lse (B,Hq,Sq) f32).
    k and v hold a whole number of chunks."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
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
    return out, (m + torch.log(l)).reshape(B, Hq, Sq)


def _flash_bwd(q, k, v, out, lse, do, scale, causal, window, kv_len, chunk):
    """(dq, dk, dv) by chunked recompute: p = exp(s - lse), delta =
    rowsum(dO * O), every product summed in f32; each gradient in its
    operand's dtype.  k and v hold a whole number of chunks."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    dog = do.reshape(B, Hkv, G, Sq, D).float()
    og = out.reshape(B, Hkv, G, Sq, D).float()
    lse = lse.reshape(B, Hkv, G, Sq)
    delta = (dog * og).sum(dim=-1)                          # (B,Hkv,G,Sq)
    dq = torch.zeros_like(qg)
    dk = torch.zeros((B, Hkv, Skv, D), device=q.device)
    dv = torch.zeros((B, Hkv, Skv, D), device=q.device)
    for sk0 in range(0, Skv, chunk):
        kj = k[:, :, sk0:sk0 + chunk].float()
        vj = v[:, :, sk0:sk0 + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj) * scale
        s = s + _mask(sk0, Sq, chunk, causal, window, kv_len, q.device)
        p = torch.exp(s - lse[..., None])                   # (B,Hkv,G,Sq,c)
        dv[:, :, sk0:sk0 + chunk] = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vj)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kj)
        dk[:, :, sk0:sk0 + chunk] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashRef(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the chunked forward, and a
    backward that recomputes from (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, kv_len, chunk):
        out, lse = _flash_fwd(q, k, v, scale, causal, window, kv_len, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, kv_len, chunk)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _pad_kv(k, v, kv_len, chunk):
    """k, v zero-padded to a whole number of chunks; padded keys masked
    through ``kv_len``."""
    Skv = k.shape[2]
    if Skv % chunk:
        pad = chunk - Skv % chunk
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        kv_len = kv_len if kv_len is not None else Skv
    return k, v, kv_len


def flash_ref(q, k, v, *, scale: float | None = None, causal: bool = False,
              window: int | None = None, kv_len: int | None = None,
              chunk: int = 512, return_lse: bool = False):
    """Chunked flash attention in f32, cast back to q's dtype;
    differentiable in q, k and v.  With ``return_lse`` also the per-row
    logsumexp (B, Hq, Sq) in f32."""
    D, Skv = q.shape[-1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    chunk = min(chunk, Skv)
    k, v, kv_len = _pad_kv(k, v, kv_len, chunk)
    out, lse = _FlashRef.apply(q, k, v, scale, causal, window, kv_len, chunk)
    return (out, lse) if return_lse else out


def flash_bwd_ref(q, k, v, out, lse, do, *, scale: float, causal: bool,
                  window: int | None, kv_len: int | None,
                  chunk: int = 512):
    """The backward of ``flash_ref`` as a plain function: (dq, dk, dv)
    from the forward's ``out`` and ``lse`` and the output gradient
    ``do``."""
    Skv = k.shape[2]
    chunk = min(chunk, Skv)
    kp, vp, kv_len = _pad_kv(k, v, kv_len, chunk)
    dq, dk, dv = _flash_bwd(q, kp, vp, out, lse, do, scale, causal, window,
                            kv_len, chunk)
    return dq, dk[:, :, :Skv], dv[:, :, :Skv]
