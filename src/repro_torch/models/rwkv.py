"""RWKV6 (Finch) on the Program path (counterpart of
``repro/models/rwkv.py``): an attention-free LM with data-dependent
per-channel decay.  Time-mix (the WKV recurrence, kernels/rwkv6) +
channel-mix blocks, token-shift interpolation, LoRA-generated decay.

State per layer for decode: the (H, D, D) WKV state plus the two
token-shift vectors -- O(1) in sequence length.  ``block_prefill`` /
``block_decode`` are the executor's entry points for one coarse ``wkv``
op (prefill runs the recurrence through ``wkv6``, decode through the
plain ``wkv6_decode_step``, as the reference does); ``to_graph`` /
``to_decode_graph`` lower the model and ``_rwkv_state_specs`` mints its
state (registered as the "ssm" state family).  The legacy ``forward``
(with ``return_cache``), ``init_cache`` and ``decode_step`` run the same
block emitters (``_block_seq``, ``_block_step``) as a Python loop over
the layers (the reference's scan); the cache holds every layer's wkv
state and its two shift rows.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.ir import ModelGraph, embed_node, matmul_node, norm_node, wkv_node
from ..core.regions import PersistentSpec, StateCaps, register_state_family
from ..kernels.common import apply_activation
from ..kernels.rwkv6 import wkv6, wkv6_decode_step
from .common import ParamDef, layer_norm, rms_norm

__all__ = ["param_defs", "forward", "init_cache", "decode_step",
           "to_graph", "to_decode_graph", "block_prefill", "block_decode"]

_LORA = 64


def param_defs(cfg: ArchConfig) -> dict:
    dt = cfg.tdtype
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H = D // cfg.hd

    def p(shape, axes, init="normal"):
        return ParamDef((L,) + shape, ("layers",) + axes, dt, init)

    blocks = {
        "ln1": p((D,), ("embed",), "ones"),
        "ln1_b": p((D,), ("embed",), "zeros"),
        "ln2": p((D,), ("embed",), "ones"),
        "ln2_b": p((D,), ("embed",), "zeros"),
        # time mix
        "mu_r": p((D,), ("embed",), "zeros"),
        "mu_k": p((D,), ("embed",), "zeros"),
        "mu_v": p((D,), ("embed",), "zeros"),
        "mu_w": p((D,), ("embed",), "zeros"),
        "mu_g": p((D,), ("embed",), "zeros"),
        "w_base": p((D,), ("embed",), "zeros"),
        "w_lora_a": p((D, _LORA), ("embed", None)),
        "w_lora_b": p((_LORA, D), (None, "embed")),
        "u": p((H, cfg.hd), (None, None), "zeros"),
        "wr": p((D, D), ("embed", "heads")),
        "wk": p((D, D), ("embed", "heads")),
        "wv": p((D, D), ("embed", "heads")),
        "wg": p((D, D), ("embed", "heads")),
        "wo": p((D, D), ("heads", "embed")),
        "ln_x": p((D,), ("embed",), "ones"),
        # channel mix
        "mu_ck": p((D,), ("embed",), "zeros"),
        "mu_cr": p((D,), ("embed",), "zeros"),
        "wc_r": p((D, D), ("embed", "ff")),
        "wc_in": p((D, F), ("embed", "ff")),
        "wc_out": p((F, D), ("ff", "embed")),
    }
    return {
        "embed": ParamDef((cfg.vocab, D), ("vocab", "embed"), dt, "embed"),
        "ln_in": ParamDef((D,), ("embed",), dt, "ones"),
        "ln_in_b": ParamDef((D,), ("embed",), dt, "zeros"),
        "blocks": blocks,
        "final_norm": ParamDef((D,), ("embed",), dt, "ones"),
        "final_norm_b": ParamDef((D,), ("embed",), dt, "zeros"),
        "lm_head": ParamDef((D, cfg.vocab), ("embed", "vocab"), dt),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1}, zeros (or the carried row ``last`` (B, D))
    at t=0."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, xx, mu):
    return x + (xx - x) * mu[None, None]


def _last_row(h, length):
    """h (B, S, D) -> the last *valid* row (B, D): S-1, or length-1 on a
    right-padded block (Program prefill pins (1, max_len)).  ``length``
    is an int or a (1,) int tensor (the graph-safe form: a gather, no
    host read)."""
    if length is None:
        return h[:, -1]
    return h[:, length - 1].reshape(h.shape[0], h.shape[2])


def _decay(xw, p):
    """w = exp(-exp(w_base + tanh(xw A) B)), in f32."""
    w_log = (p["w_base"].float()
             + torch.tanh(xw.float() @ p["w_lora_a"].float())
             @ p["w_lora_b"].float())
    return torch.exp(-torch.exp(w_log))


def _time_mix(h, p, hd, *, impl, wkv_state=None, shift_state=None,
              length=None):
    """Time-mix over a (B, S, D) block from ``wkv_state`` / ``shift_state``
    (zeros where None).  Returns (out, new wkv state, shift row)."""
    B, S, D = h.shape
    H = D // hd
    xx = _shift(h, shift_state)
    r = _lerp(h, xx, p["mu_r"]) @ p["wr"]
    k = _lerp(h, xx, p["mu_k"]) @ p["wk"]
    v = _lerp(h, xx, p["mu_v"]) @ p["wv"]
    g = apply_activation((_lerp(h, xx, p["mu_g"]) @ p["wg"]).float(),
                         "silu")
    w = _decay(_lerp(h, xx, p["mu_w"]), p)             # (B, S, D) in (0,1)
    if length is not None:
        # Right-padded rows are recurrence identities: k = 0 contributes
        # nothing, w = 1 decays nothing, so the state after the scan is
        # exactly the state at the true length (pad-row *outputs* are
        # garbage, but causality keeps them out of every valid row).
        valid = (torch.arange(S, device=h.device) < length)[None, :, None]
        k = torch.where(valid, k, torch.zeros_like(k))
        w = torch.where(valid, w, torch.ones_like(w))

    def heads(a):
        return a.reshape(B, S, H, hd)

    y, s_new = wkv6(heads(r), heads(k), heads(v), heads(w.to(h.dtype)),
                    p["u"], s0=wkv_state, return_state=True, impl=impl)
    y = rms_norm(y.reshape(B, S, D), p["ln_x"])         # per-channel norm
    out = (y.float() * g).to(h.dtype) @ p["wo"]
    return out, s_new, _last_row(h, length)


def _channel_mix(h, p, *, shift_state=None, length=None):
    """Channel-mix over a (B, S, D) block from ``shift_state`` (zeros
    where None).  Returns (out, shift row)."""
    xx = _shift(h, shift_state)
    kx = _lerp(h, xx, p["mu_ck"]) @ p["wc_in"]
    k = torch.square(torch.relu(kx.float()))
    r = torch.sigmoid((_lerp(h, xx, p["mu_cr"]) @ p["wc_r"]).float())
    out = (r * (k.to(h.dtype) @ p["wc_out"]).float()).to(h.dtype)
    return out, _last_row(h, length)


def _block_seq(carry, p_i, hd, *, impl, wkv_state=None, shift_t=None,
               shift_c=None, length=None, want_state=True):
    """One rwkv block over a (B, S, D) sequence -- ln1 + time-mix +
    residual, ln2 + channel-mix + residual -- from the given states
    (zeros where None).  Returns (out, (wkv state, time-mix shift row,
    channel-mix shift row)), the states None unless ``want_state``.  The
    one emitter behind the legacy ``forward`` and the Program's ``wkv``
    prefill op."""
    a_in = layer_norm(carry, p_i["ln1"], p_i["ln1_b"])
    a, s_new, sh1 = _time_mix(a_in, p_i, hd, impl=impl, wkv_state=wkv_state,
                              shift_state=shift_t, length=length)
    carry = carry + a
    c_in = layer_norm(carry, p_i["ln2"], p_i["ln2_b"])
    c, sh2 = _channel_mix(c_in, p_i, shift_state=shift_c, length=length)
    states = (s_new, sh1, sh2) if want_state else (None, None, None)
    return carry + c, states


def forward(params, tokens, cfg: ArchConfig, *, impl: str = "auto",
            return_cache: bool = False, cache_len: int | None = None,
            remat: bool = False, return_hidden: bool = False) -> dict:
    """The legacy forward: tokens (B, S) -> {"logits", "aux": {}[,
    "cache"]}, or with ``return_hidden`` {"logits": None, "hidden": the
    final-norm output (B, S, D), "aux": {}}.  ``remat`` recomputes each
    block in the backward pass, as the reference's
    ``jax.checkpoint(body)``: the wkv kernel runs twice per layer per
    training step.  The cache (``return_cache``) holds each layer's wkv
    state and shift rows and ``pos`` = S (``cache_len`` is not read:
    the state is O(1) in length)."""
    B, S = tokens.shape
    h = params["embed"][tokens.long()].to(cfg.tdtype)
    h = layer_norm(h, params["ln_in"], params["ln_in_b"])
    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    block = functools.partial(_block_seq, hd=cfg.hd, impl=impl,
                              want_state=return_cache)
    states = []
    for i in range(cfg.n_layers):
        p_i = {k: v[i] for k, v in blocks.items()}
        if remat:
            # No forward draws random numbers: no RNG state is kept.
            h, st = checkpoint(block, h, p_i, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            h, st = block(h, p_i)
        states.append(st)
    h = layer_norm(h, params["final_norm"], params["final_norm_b"])
    out = {"logits": None if return_hidden else h @ params["lm_head"],
           "aux": {}}
    if return_hidden:
        out["hidden"] = h
    if return_cache:
        s_stack, sh1, sh2 = (torch.stack(x) for x in zip(*states))
        out["cache"] = {"wkv": s_stack, "shift_t": sh1, "shift_c": sh2,
                        "pos": torch.full((B,), S, dtype=torch.int32,
                                          device=h.device)}
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed legacy cache: per layer the (H, hd, hd) f32 wkv state and
    the two shift rows, and ``pos``."""
    D, L = cfg.d_model, cfg.n_layers
    H, hd = D // cfg.hd, cfg.hd
    row = (L, batch, D)
    return {
        "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros(row, dtype=cfg.tdtype, device=device),
        "shift_c": torch.zeros(row, dtype=cfg.tdtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg: ArchConfig, *,
                impl: str = "auto"):
    """tokens (B,) -> (logits (B, V), new cache): every block one step
    (``_block_step``, plain torch as in the reference).  The cache passed
    in is left as it was."""
    h = params["embed"][tokens.long()].to(cfg.tdtype)
    h = layer_norm(h, params["ln_in"], params["ln_in_b"])
    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    states = []
    for i in range(cfg.n_layers):
        h, st = _block_step(h, {k: v[i] for k, v in blocks.items()},
                            cache["wkv"][i], cache["shift_t"][i],
                            cache["shift_c"][i])
        states.append(st)
    h = layer_norm(h, params["final_norm"], params["final_norm_b"])
    s_new, sh1, sh2 = (torch.stack(x) for x in zip(*states))
    return h @ params["lm_head"], {"wkv": s_new, "shift_t": sh1,
                                   "shift_c": sh2, "pos": cache["pos"] + 1}


def _block_step(carry, p_i, s_i, sh1_i, sh2_i):
    """One rwkv block for one token per sequence -- carry (B, D), wkv
    state (B, H, hd, hd) f32, shift rows (B, D).  Head geometry derives
    from the params (u is (H, hd)), so the executor never consults the
    model config."""
    B, D = carry.shape
    H, hd = p_i["u"].shape
    x1 = layer_norm(carry, p_i["ln1"], p_i["ln1_b"])
    xx = sh1_i

    def mix(mu):
        return x1 + (xx - x1) * mu[None]
    r = (mix(p_i["mu_r"]) @ p_i["wr"]).reshape(B, H, hd)
    k = (mix(p_i["mu_k"]) @ p_i["wk"]).reshape(B, H, hd)
    v = (mix(p_i["mu_v"]) @ p_i["wv"]).reshape(B, H, hd)
    g = apply_activation((mix(p_i["mu_g"]) @ p_i["wg"]).float(), "silu")
    w = _decay(mix(p_i["mu_w"]), p_i).reshape(B, H, hd)
    y, s_new = wkv6_decode_step(s_i, r, k, v.float(), w, p_i["u"])
    y = rms_norm(y.reshape(B, D), p_i["ln_x"])
    carry = carry + (y.float() * g).to(carry.dtype) @ p_i["wo"]
    x2 = layer_norm(carry, p_i["ln2"], p_i["ln2_b"])
    xx2 = sh2_i
    kx = (x2 + (xx2 - x2) * p_i["mu_ck"][None]) @ p_i["wc_in"]
    kk = torch.square(torch.relu(kx.float()))
    rr = torch.sigmoid(((x2 + (xx2 - x2) * p_i["mu_cr"][None])
                        @ p_i["wc_r"]).float())
    carry = carry + (rr * (kk.to(carry.dtype) @ p_i["wc_out"]).float()
                     ).to(carry.dtype)
    return carry, (s_new, x1, x2)


# --- Program lowering (generic named state) ---------------------------------------
def block_prefill(h, p_i, *, impl="auto", length=None):
    """Executor entry for one ``wkv`` prefill op: h (B, S, D) right-
    padded to S with ``length`` valid rows, states zero-initialised
    (prefill always restarts a slot).  Returns (out (B, S, D), (wkv (B,
    H, hd, hd) f32, shift_t (B, D), shift_c (B, D)))."""
    return _block_seq(h, p_i, p_i["u"].shape[1], impl=impl, length=length)


def block_decode(h, p_i, wkv_state, shift_t, shift_c):
    """Executor entry for one ``wkv`` decode op: h (slots, D), one token
    per slot against the per-slot states."""
    return _block_step(h, p_i, wkv_state, shift_t, shift_c)


def _state_names(i: int) -> tuple[str, str, str]:
    """Per-layer persistent state names, in ProgramOp.state_regions
    order (wkv matrix, time-mix shift row, channel-mix shift row)."""
    return (f"l{i}.wkv_s", f"l{i}.shift_t", f"l{i}.shift_c")


def to_graph(cfg: ArchConfig, batch: int = 1, seq: int = 64,
             dtype_bytes: int | None = None,
             write_cache: bool = False) -> ModelGraph:
    """Lower rwkv6 to the compiler IR: embed -> input LN -> one coarse
    ``wkv`` block op per layer (ln1 + time-mix + ln2 + channel-mix,
    both residuals internal) -> final LN -> lm head.  ``write_cache``
    names the per-layer persistent state regions the op scatters at the
    admitted slot."""
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    D = cfg.d_model
    H, hd = D // cfg.hd, cfg.hd
    g = ModelGraph(cfg.name)
    g.add(embed_node("embed", batch * seq, cfg.vocab, D, dtype_bytes=by,
                     param="embed"))
    g.add(norm_node("ln_in", batch * seq * D, dtype_bytes=by,
                    inputs=["embed"], norm="layernorm", param="ln_in",
                    param_b="ln_in_b"))
    prev = "ln_in"
    for i in range(cfg.n_layers):
        g.add(wkv_node(
            f"l{i}.wkv", seq=seq, heads=H, head_dim=hd, d_model=D,
            batch=batch, dtype_bytes=by, inputs=[prev],
            param=f"blocks:{i}",
            **({"states": _state_names(i)} if write_cache else {})))
        prev = f"l{i}.wkv"
    g.add(norm_node("final_norm", batch * seq * D, dtype_bytes=by,
                    inputs=[prev], norm="layernorm", param="final_norm",
                    param_b="final_norm_b"))
    g.add(matmul_node("lm_head", batch * seq, D, cfg.vocab,
                      dtype_bytes=by, inputs=["final_norm"],
                      param="lm_head"))
    return g


def to_decode_graph(cfg: ArchConfig, slots: int = 8, max_len: int = 256,
                    dtype_bytes: int | None = None) -> ModelGraph:
    """One token per slot (M = slots, seq = 1); the same coarse block op
    reads/writes the per-slot states -- O(1) in ``max_len``, which is why
    the spec shapes carry no sequence axis."""
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    D = cfg.d_model
    H, hd = D // cfg.hd, cfg.hd
    g = ModelGraph(cfg.name + ".decode")
    g.add(embed_node("embed", slots, cfg.vocab, D, dtype_bytes=by,
                     param="embed"))
    g.add(norm_node("ln_in", slots * D, dtype_bytes=by, inputs=["embed"],
                    norm="layernorm", param="ln_in", param_b="ln_in_b"))
    prev = "ln_in"
    for i in range(cfg.n_layers):
        g.add(wkv_node(
            f"l{i}.wkv", seq=1, heads=H, head_dim=hd, d_model=D,
            batch=slots, dtype_bytes=by, inputs=[prev],
            param=f"blocks:{i}", states=_state_names(i), decode=True))
        prev = f"l{i}.wkv"
    g.add(norm_node("final_norm", slots * D, dtype_bytes=by,
                    inputs=[prev], norm="layernorm", param="final_norm",
                    param_b="final_norm_b"))
    g.add(matmul_node("lm_head", slots, D, cfg.vocab, dtype_bytes=by,
                      inputs=["final_norm"], param="lm_head"))
    return g


def _rwkv_state_specs(cfg: ArchConfig, slots: int, max_len: int):
    """Per-layer wkv matrix (f32) + the two token-shift rows.  No
    sequence axis anywhere: rwkv state is O(1) in ``max_len``, so none of
    the KV serving features apply -- not pageable, not windowed, not
    chunkable (the recurrence is order-sensitive), not speculatable (no
    length-truncation rollback)."""
    D = cfg.d_model
    H, hd = D // cfg.hd, cfg.hd
    dt = cfg.tdtype
    name = str(dt).removeprefix("torch.")
    specs = []
    for i in range(cfg.n_layers):
        wkv_name, sh1, sh2 = _state_names(i)
        s_shape = (slots, H, hd, hd)
        r_shape = (slots, D)
        specs.append(PersistentSpec(wkv_name, s_shape, "float32",
                                    math.prod(s_shape) * 4))
        specs.append(PersistentSpec(sh1, r_shape, name,
                                    math.prod(r_shape) * dt.itemsize))
        specs.append(PersistentSpec(sh2, r_shape, name,
                                    math.prod(r_shape) * dt.itemsize))
    return tuple(specs), StateCaps()


register_state_family("ssm", _rwkv_state_specs)
