"""Plain PyTorch oracles for the Mamba2 selective state-space scan (SSD)
(counterparts of ``repro/kernels/mamba2/ref.py``).

Per head: state h (N, P); per step t
    h_t = exp(A * dt_t) * h_{t-1} + B_t^T (dt_t * x_t)     (outer product)
    y_t = C_t h_t + D_skip * x_t
A is a negative scalar per head; B_t, C_t are shared across heads
(single group); x (B, L, H, P); dt (B, L, H); B/C (B, L, N).
"""
from __future__ import annotations

import torch

__all__ = ["mamba2_scan_ref", "mamba2_scan_chunked"]


def _h_init(h0, Bt, H, N, P, device):
    if h0 is not None:
        return h0.float()
    return torch.zeros((Bt, H, N, P), dtype=torch.float32, device=device)


def mamba2_scan_ref(x, dt, A, B, C, *, D_skip=None, h0=None,
                    return_state: bool = False):
    """x: (Bt, L, H, P); dt: (Bt, L, H); A: (H,); B, C: (Bt, L, N).
    Returns y (Bt, L, H, P) [and final state (Bt, H, N, P)].  The
    sequential oracle: every step in f32, y rounded once.  Every step's
    decay and input term (elementwise, no sum) are computed for all steps
    before the loop, which keeps the state update and the output sum: the
    same values as a step at a time, in 3 launches a step, at the cost
    of a (Bt, L, H, N, P) f32 temporary."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), B.float(), C.float(), A.float()
    decay = torch.exp(Af[None, None, :] * dtf)[..., None, None]  # (Bt,L,H,1,1)
    dBx = torch.einsum("bln,blhp->blhnp", Bf, xf * dtf[..., None])
    h = _h_init(h0, Bt, H, N, P, x.device)
    ys = []
    for t in range(L):
        h = h * decay[:, t] + dBx[:, t]                            # (Bt,H,N,P)
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    y = torch.stack(ys, 1)
    if D_skip is not None:
        y = y + D_skip.float()[None, None, :, None] * xf
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def mamba2_scan_chunked(x, dt, A, B, C, *, D_skip=None, h0=None,
                        return_state: bool = False, chunk: int = 64):
    """Block-parallel SSD in plain torch -- the TPU kernel's chunk
    decomposition, used as the model path off the card.

    The L-step scan becomes L/Q chunk steps of masked-decay products.
    The roundings are the reference's: large activations stay in the
    input dtype, only the per-head cumsums and the state run in f32, and
    the (Q, S, H) decay matrix is cast to x's dtype before its product
    with x (sums in f32).  All exponents are <= 0: the decay matrix's
    exponent is zeroed above the diagonal before ``exp``, where the
    reference exponentiates cum_q - cum_s > 0 and masks the product
    after.  The forward is the same bits; the reference's gradient there
    is 0 x exp(+large) = NaN once a chunk's decay passes e^88 (zamba2-7b
    at L = 512 with A dt ~ 0.7 reaches e^180), the port's is 0."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    while L % Q != 0:
        Q //= 2
    nc = L // Q
    xr = x.reshape(Bt, nc, Q, H, P)
    dtf = dt.float().reshape(Bt, nc, Q, H)
    Br = B.reshape(Bt, nc, Q, N)
    Cr = C.reshape(Bt, nc, Q, N)
    Af = A.float()
    cdt = x.dtype
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    h = _h_init(h0, Bt, H, N, P, x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xr[:, c], dtf[:, c], Br[:, c], Cr[:, c]
        a = Af[None, None] * dtc                                   # (Bt,Q,H)
        cum = torch.cumsum(a, dim=1)
        total = cum[:, -1]                                         # (Bt,H)
        CB = torch.einsum("bqn,bsn->bqs", Cc.float(), Bc.float())
        diff = cum[:, :, None, :] - cum[:, None, :, :]             # (Bt,Q,S,H)
        dec = torch.exp(torch.where(mask, diff, torch.zeros_like(diff)))
        M = (torch.where(mask, CB[..., None] * dec, torch.zeros_like(dec))
             * dtc[:, None, :, :])
        y = torch.einsum("bqsh,bshp->bqhp", M.to(cdt).float(), xc.float())
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhnp->bqhp", Cc.float(), h)
        w = torch.exp(total[:, None] - cum) * dtc                  # (Bt,Q,H)
        h = (h * torch.exp(total)[..., None, None]
             + torch.einsum("bsh,bsn,bshp->bhnp", w, Bc.float(), xc.float()))
        ys.append(y.to(cdt))
    y = torch.stack(ys, 1).reshape(Bt, L, H, P)
    if D_skip is not None:
        y = y + (D_skip.to(cdt)[None, None, :, None] * x)
    if return_state:
        return y, h
    return y
