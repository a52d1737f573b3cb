"""Plain PyTorch oracles for the RWKV6 (Finch) WKV recurrence
(counterparts of ``repro/kernels/rwkv6/ref.py``).

Per head with head dim D and state S (D_k x D_v):
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with data-dependent per-channel decay w_t in (0, 1) (the model computes
w_t = exp(-exp(w_raw_t))) and a per-channel bonus u for the current
token.
"""
from __future__ import annotations

import torch

__all__ = ["wkv6_ref", "wkv6_chunked"]


def _s_init(s0, B, H, D, device):
    if s0 is not None:
        return s0.float()
    return torch.zeros((B, H, D, D), dtype=torch.float32, device=device)


def wkv6_ref(r, k, v, w, u, *, s0=None, return_state: bool = False):
    """r,k,v,w: (B, L, H, D); u: (H, D).  Returns y (B, L, H, D) [and
    final state (B, H, D, D)].  The sequential oracle: every step in f32,
    y rounded once."""
    B, L, H, D = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    S = _s_init(s0, B, H, D, r.device)
    ys = []
    for t in range(L):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]    # (B,H,D)
        kv = kt[..., :, None] * vt[..., None, :]                   # (B,H,D,D)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + uf[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    y = torch.stack(ys, 1).to(r.dtype)
    if return_state:
        return y, S
    return y


def wkv6_chunked(r, k, v, w, u, *, s0=None, return_state: bool = False,
                 chunk: int = 16):
    """Block-parallel WKV6 (the model path off the card): L/Q chunk
    steps instead of L sequential state updates.

    Within a chunk, pair weights exp(cum_{t-1} - cum_s) are factored as
    (r * e^{cum_prev - m})(k * e^{m - cum}) with the per-channel center
    m = cum at mid-chunk, which keeps both factors within e^{+-Q/2 |log
    w|} -- safe in f32 for Q <= 16 with realistic decay magnitudes."""
    B, L, H, D = r.shape
    Q = min(chunk, L)
    while L % Q != 0:
        Q //= 2
    nc = L // Q
    uf = u.float()
    rr, kk, vv, ww = (a.reshape(B, nc, Q, H, D) for a in (r, k, v, w))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, :, :, None]
    S = _s_init(s0, B, H, D, r.device)
    ys = []
    for c in range(nc):
        rc, kc, vc, wc = (a[:, c].float() for a in (rr, kk, vv, ww))
        lw = torch.log(torch.clamp(wc, min=1e-30))                 # <= 0
        cum = torch.cumsum(lw, dim=1)                              # inclusive
        cum_prev = cum - lw                                        # exclusive
        m = cum[:, Q // 2][:, None]                                # center
        r_t = rc * torch.exp(cum_prev - m)
        k_t = kc * torch.exp(m - cum)
        A = torch.einsum("bqhd,bshd->bqsh", r_t, k_t)              # (B,Q,S,H)
        diag = torch.einsum("bqhd,bqhd->bqh", rc * uf[None, None], kc)
        y = torch.einsum("bqsh,bshd->bqhd",
                         torch.where(mask, A, torch.zeros_like(A)), vc)
        y = y + diag[..., None] * vc
        # inter-chunk: the carried state read out with decayed r
        y = y + torch.einsum("bqhi,bhij->bqhj", rc * torch.exp(cum_prev), S)
        # state update
        total = cum[:, -1][:, None]                                # (B,1,H,D)
        k_s = kc * torch.exp(total - cum)
        S = (S * torch.exp(total[:, 0])[..., None]
             + torch.einsum("bqhi,bqhj->bhij", k_s, vc))
        ys.append(y.to(r.dtype))
    y = torch.stack(ys, 1).reshape(B, L, H, D)
    if return_state:
        return y, S
    return y
