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
    y rounded once.  Every step's outer product and bonus term are
    computed for all steps before the loop: the same values as a step at
    a time, in 4 launches a step, at the cost of two (B, L, H, D, D) f32
    temporaries."""
    B, L, H, D = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]                       # (B,L,H,D,D)
    ukv = u.float()[None, None, :, :, None] * kv
    S = _s_init(s0, B, H, D, r.device)
    ys = []
    for t in range(L):
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], S + ukv[:, t]))
        S = wf[:, t][..., :, None] * S + kv[:, t]
    y = torch.stack(ys, 1).to(r.dtype)
    if return_state:
        return y, S
    return y


def wkv6_chunked(r, k, v, w, u, *, s0=None, return_state: bool = False,
                 chunk: int = 16):
    """Block-parallel WKV6 (the model path off the card): every chunk's
    intra-chunk products at once, then L/Q state steps.

    Within a chunk each pair (q, s < q) carries the per-channel decay
    exp(cum_{q-1} - cum_s), its exponent <= 0, zeroed above the diagonal
    before ``exp``.  The reference factors it as (r e^{cum_prev - m})(k
    e^{m - cum}) around the mid-chunk cum m, whose factors pass f32's
    e^88 once Q/2 |log w| does (w < 1.7e-5 at Q = 16; rwkv6-7b's trained
    decays reach it within a step of random init), and whose gradient is
    then NaN; the pair form is the same function without that limit.
    All chunks at once, not a chunk at a time: a (B, L/Q, Q, Q, H, D)
    tensor, about 1 GB at rwkv6-7b's training shape, against L/Q times
    the launches, which an eager training step waits on (twice the step
    time on an H100)."""
    B, L, H, D = r.shape
    Q = min(chunk, L)
    while L % Q != 0:
        Q //= 2
    nc = L // Q
    rc, kc, vc, wc = (a.float().reshape(B, nc, Q, H, D)
                      for a in (r, k, v, w))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, None, :, :, None]       # (1,1,Q,S,1)
    lw = torch.log(torch.clamp(wc, min=1e-30))                     # <= 0
    cum = torch.cumsum(lw, dim=2)                                  # inclusive
    cum_prev = cum - lw                                            # exclusive
    diff = cum_prev[:, :, :, None] - cum[:, :, None]             # (B,c,Q,S,H,D)
    dec = torch.exp(torch.where(mask[..., None], diff,
                                torch.zeros_like(diff)))
    A = torch.einsum("bcqhd,bcqshd->bcqsh", rc, dec * kc[:, :, None])
    diag = torch.einsum("bcqhd,bcqhd->bcqh", rc * u.float()[None, None], kc)
    y = torch.einsum("bcqsh,bcshd->bcqhd",
                     torch.where(mask, A, torch.zeros_like(A)), vc)
    y = y + diag[..., None] * vc
    # each chunk's own state update, then the states entering the chunks
    total = cum[:, :, -1]                                          # (B,c,H,D)
    upd = torch.einsum("bcqhi,bcqhj->bchij",
                       kc * torch.exp(total[:, :, None] - cum), vc)
    S = _s_init(s0, B, H, D, r.device)
    entering = []
    for c in range(nc):
        entering.append(S)
        S = S * torch.exp(total[:, c])[..., None] + upd[:, c]
    # inter-chunk: the carried state read out with decayed r
    y = y + torch.einsum("bcqhi,bchij->bcqhj", rc * torch.exp(cum_prev),
                         torch.stack(entering, 1))
    y = y.reshape(B, L, H, D).to(r.dtype)
    if return_state:
        return y, S
    return y
