"""Zamba2-style hybrid on the Program path (counterpart of
``repro/models/zamba2.py``): a Mamba2 backbone with one *shared*
attention block applied every ``shared_attn_every`` layers (the same
weights at each application).

Mamba2 mixer per layer: in_proj -> [z | x | B | C | dt], short causal
depthwise conv over (x|B|C), selective scan (kernels/mamba2), gated
RMSNorm, out_proj.  The shared attention block is a full transformer
block (attn + MLP) with a sliding window (``attn_window``).  The pure-SSD
``mamba2`` config is this module with no shared block.

``block_prefill`` / ``block_decode`` are the executor's entry points
for one coarse ``ssm_scan`` op; ``to_graph`` / ``to_decode_graph`` lower
the model to the compiler IR and ``_hybrid_state_specs`` mints its
persistent state (registered as the "hybrid" state family).  The
in_proj / out_proj products are plain ``@`` inside the coarse op, as in
the reference, where XLA takes them.  The legacy ``forward`` (with
``return_cache``), ``init_cache`` and ``decode_step`` run the same
blocks as a Python loop over the layers (the reference's scan): the
cache holds every layer's SSM and conv state and each shared-block
application's K/V ring of ``min(window, S)`` rows.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.ir import (ModelGraph, attention_node, decode_attention_node,
                       elementwise_node, embed_node, matmul_node, norm_node,
                       ssm_scan_node)
from ..core.regions import PersistentSpec, StateCaps, register_state_family
from ..kernels.common import apply_activation
from ..kernels.decode_attention import ring_positions
from ..kernels.mamba2 import mamba2_scan
from .common import ParamDef, Rotary, rms_norm
from .transformer import _attention, _attention_decode, _attn_defs, _mlp

__all__ = ["param_defs", "forward", "init_cache", "decode_step",
           "to_graph", "to_decode_graph", "block_prefill", "block_decode"]

_CONV_K = 4


def _n_apps(cfg: ArchConfig) -> int:
    e = cfg.shared_attn_every
    if not e:          # pure-mamba2 config: no shared attention at all
        return 0
    return (cfg.n_layers + e - 1) // e


def param_defs(cfg: ArchConfig) -> dict:
    dt = cfg.tdtype
    L, D = cfg.n_layers, cfg.d_model
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    blocks = {
        "norm": ParamDef((L, D), ("layers", "embed"), dt, "ones"),
        "in_proj": ParamDef((L, D, 2 * di + 2 * N + H),
                            ("layers", "embed", "ff"), dt),
        "conv_w": ParamDef((L, _CONV_K, conv_ch), ("layers", None, "ff"),
                           dt, init_scale=0.5),
        "A_log": ParamDef((L, H), ("layers", None), torch.float32, "zeros"),
        "dt_bias": ParamDef((L, H), ("layers", None), torch.float32,
                            "zeros"),
        "D_skip": ParamDef((L, H), ("layers", None), torch.float32, "ones"),
        "gate_norm": ParamDef((L, di), ("layers", "ff"), dt, "ones"),
        "out_proj": ParamDef((L, di, D), ("layers", "ff", "embed"), dt),
    }
    defs = {
        "embed": ParamDef((cfg.vocab, D), ("vocab", "embed"), dt, "embed"),
        "blocks": blocks,
        "final_norm": ParamDef((D,), ("embed",), dt, "ones"),
        "lm_head": ParamDef((D, cfg.vocab), ("embed", "vocab"), dt),
    }
    if cfg.shared_attn_every:
        shared = {"attn_norm": ParamDef((D,), ("embed",), dt, "ones")}
        shared.update({k: ParamDef(v.shape[1:], v.axes[1:], v.dtype)
                       for k, v in _attn_defs(cfg, L).items()})
        shared["mlp_norm"] = ParamDef((D,), ("embed",), dt, "ones")
        shared["w_gate"] = ParamDef((D, cfg.d_ff), ("embed", "ff"), dt)
        shared["w_up"] = ParamDef((D, cfg.d_ff), ("embed", "ff"), dt)
        shared["w_down"] = ParamDef((cfg.d_ff, D), ("ff", "embed"), dt)
        defs["shared"] = shared
    return defs


def _mixer_dims(p) -> tuple[int, int, int, int]:
    """(d_inner, ssm_state, ssm_heads, ssm_head_dim) from the param
    shapes alone, so the executor's block entry points never consult
    the model config: A_log is (H,), gate_norm is (di,), and in_proj's
    output splits as [z(di) | x(di) | B(N) | C(N) | dt(H)]."""
    H = p["A_log"].shape[-1]
    di = p["gate_norm"].shape[-1]
    N = (p["in_proj"].shape[-1] - 2 * di - H) // 2
    return di, N, H, di // H


def _split_proj(zxbcdt, di, N):
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w):
    """Depthwise causal conv, kernel _CONV_K.  xBC (B, S, C); conv_w (K, C)."""
    K, S = conv_w.shape[0], xBC.shape[1]
    pad = torch.nn.functional.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S] * conv_w[i][None, None] for i in range(K))
    return apply_activation(out.float(), "silu").to(xBC.dtype)


def _softplus(x):
    """softplus as the reference computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _mamba_mixer(h, p, *, impl, state=None, conv_state=None, length=None):
    """h (B, S, D) -> (out, new_ssm_state, new_conv_state).

    ``length`` marks h as right-padded (Program prefill pins
    (1, max_len)): pad rows become scan identities -- dt = 0 after the
    softplus makes the decay exp(A*0) = 1 and the dB*x contribution 0 --
    so the returned recurrent state is exactly the state at the true
    length, and the conv taps are gathered at rows [length-K+1, length)
    instead of the block tail.  ``length`` is an int or a (1,) int
    tensor on h's device (the graph-safe form: gathers and masks only,
    no host read)."""
    B, S, _ = h.shape
    di, N, H, P = _mixer_dims(p)
    z, xBC, dt = _split_proj(h @ p["in_proj"], di, N)
    if conv_state is not None:      # decode: roll the conv window
        window = torch.cat([conv_state, xBC], dim=1)     # (B, K-1+S, C)
        new_conv_state = window[:, -(_CONV_K - 1):]
        xBC = _causal_conv(window, p["conv_w"])[:, -S:]
    elif length is not None:
        idx = length - (_CONV_K - 1) + torch.arange(_CONV_K - 1,
                                                    device=h.device)
        rows = xBC[:, idx.clamp(0, S - 1)]
        new_conv_state = torch.where((idx >= 0)[None, :, None], rows,
                                     torch.zeros_like(rows))
        xBC = _causal_conv(xBC, p["conv_w"])
    else:
        zeros = torch.zeros((B, _CONV_K - 1, xBC.shape[-1]),
                            dtype=xBC.dtype, device=h.device)
        new_conv_state = torch.cat([zeros, xBC], dim=1)[:, -(_CONV_K - 1):]
        xBC = _causal_conv(xBC, p["conv_w"])
    x, Bm, Cm = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    xh = x.reshape(B, S, H, P)
    dtv = _softplus(dt.float() + p["dt_bias"][None, None])        # (B,S,H)
    if length is not None:
        valid = (torch.arange(S, device=h.device) < length)[None, :, None]
        dtv = torch.where(valid, dtv, torch.zeros_like(dtv))
    A = -torch.exp(p["A_log"])
    y, h_fin = mamba2_scan(xh, dtv, A, Bm, Cm, D_skip=p["D_skip"],
                           h0=state, return_state=True, impl=impl)
    y = y.reshape(B, S, di)
    y = rms_norm(y, p["gate_norm"]) * apply_activation(
        z.float(), "silu").to(y.dtype)
    return y @ p["out_proj"], h_fin, new_conv_state


def block_prefill(h, p_i, *, impl="auto", length=None):
    """Executor entry for one ``ssm_scan`` prefill op -- the whole mamba
    block (pre-norm + mixer + residual) on (B, S, D), recurrent state
    zero-initialised (prefill always restarts a slot).  Returns (out,
    (ssm (B, H, N, P) f32, conv (B, K-1, di+2N)))."""
    mixed, s_fin, c_fin = _mamba_mixer(rms_norm(h, p_i["norm"]), p_i,
                                       impl=impl, length=length)
    return h + mixed, (s_fin, c_fin)


def block_decode(h, p_i, ssm_state, conv_state, *, impl="auto"):
    """Executor entry for one ``ssm_scan`` decode op: h (slots, D), one
    token per slot against the per-slot recurrent states; the scan runs
    with L = 1."""
    mixed, s_new, c_new = _mamba_mixer(
        rms_norm(h, p_i["norm"])[:, None], p_i, impl=impl,
        state=ssm_state, conv_state=conv_state)
    return h + mixed[:, 0], (s_new, c_new)


def forward(params, tokens, cfg: ArchConfig, *, impl: str = "auto",
            return_cache: bool = False, cache_len: int | None = None,
            remat: bool = False, return_hidden: bool = False) -> dict:
    """The legacy forward: tokens (B, S) -> {"logits", "aux": {}[,
    "cache"]}, or with ``return_hidden`` {"logits": None, "hidden": the
    final-norm output (B, S, D), "aux": {}}.  The shared block runs
    before every ``shared_attn_every``-th mamba block.  ``remat``
    recomputes each layer's body (the shared block where it runs, then
    the mamba block) in the backward pass, as the reference's
    ``jax.checkpoint(body)``: the scan and the shared attention's flash
    forward run twice per layer per training step.  The cache
    (``return_cache``) is ``_prefill_cache``'s: its K/V ring holds
    ``attn_window`` rows (S without a window); ``cache_len`` is not
    read, as in the reference."""
    B, S = tokens.shape
    e = cfg.shared_attn_every
    h = params["embed"][tokens.long()].to(cfg.tdtype)
    cos, sin = Rotary(cfg.hd, cfg.rope_theta).freqs(
        torch.arange(S, device=tokens.device))
    shared = params.get("shared")

    def body(x, p_i, is_attn: bool):
        kv = None
        if is_attn:
            a = _attention(rms_norm(x, shared["attn_norm"]), shared, cfg,
                           cos, sin, impl=impl, window=cfg.attn_window,
                           return_kv=return_cache)
            a, kv = a if return_cache else (a, None)
            x = x + a
            m, _ = _mlp(rms_norm(x, shared["mlp_norm"]), shared, cfg)
            x = x + m
        x, (s_fin, c_fin) = block_prefill(x, p_i, impl=impl)
        return x, kv, s_fin, c_fin

    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    kvs, ssm, conv = [], [], []
    for i in range(cfg.n_layers):
        p_i = {k: v[i] for k, v in blocks.items()}
        is_attn = bool(e) and i % e == 0
        if remat:
            # No forward draws random numbers: no RNG state is kept.
            h, kv, s_fin, c_fin = checkpoint(
                body, h, p_i, is_attn, use_reentrant=False,
                preserve_rng_state=False)
        else:
            h, kv, s_fin, c_fin = body(h, p_i, is_attn)
        if is_attn and return_cache:
            kvs.append(kv)
        ssm.append(s_fin)
        conv.append(c_fin)
    h = rms_norm(h, params["final_norm"])
    out = {"logits": None if return_hidden else h @ params["lm_head"],
           "aux": {}}
    if return_hidden:
        out["hidden"] = h
    if return_cache:
        if kvs:
            k_stack = torch.stack([k for k, _ in kvs])
            v_stack = torch.stack([v for _, v in kvs])
        else:
            k_stack = v_stack = torch.zeros(
                (0, B, cfg.n_kv_heads, S, cfg.hd), dtype=cfg.tdtype,
                device=h.device)
        cache = _prefill_cache(cfg, k_stack, v_stack, B, S)
        cache["ssm"] = torch.stack(ssm)
        cache["conv"] = torch.stack(conv)
        out["cache"] = cache
    return out


def _prefill_cache(cfg, k_stack, v_stack, B, S):
    """Convert the prefill K/V (napp, B, KV, S, hd) into the rolling
    window cache of W = ``attn_window`` (or S) rows: for S >= W the last
    W positions, laid out so that row ``pos % W`` holds ``pos``; else
    zero-padded to W."""
    W = cfg.attn_window or S
    if S >= W:
        pos = ring_positions(S, W, S, k_stack.device)
        kw, vw = k_stack[:, :, :, pos], v_stack[:, :, :, pos]
    else:
        kw = torch.nn.functional.pad(k_stack, (0, 0, 0, W - S))
        vw = torch.nn.functional.pad(v_stack, (0, 0, 0, W - S))
    cache = init_cache(cfg, B, W, device=k_stack.device)
    cache.update({"attn_k": kw.to(cfg.kv_tdtype),
                  "attn_v": vw.to(cfg.kv_tdtype),
                  "pos": torch.full((B,), S, dtype=torch.int32,
                                    device=k_stack.device)})
    return cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed legacy cache: per layer the SSM state (f32) and the conv
    window, per shared-block application a K/V ring of ``min(max_len,
    attn_window)`` rows, and ``pos``."""
    L, di, N = cfg.n_layers, cfg.d_inner, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    W = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    kv = (_n_apps(cfg), batch, cfg.n_kv_heads, W, cfg.hd)
    return {
        "ssm": torch.zeros((L, batch, H, N, P), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((L, batch, _CONV_K - 1, di + 2 * N),
                            dtype=cfg.tdtype, device=device),
        "attn_k": torch.zeros(kv, dtype=cfg.kv_tdtype, device=device),
        "attn_v": torch.zeros(kv, dtype=cfg.kv_tdtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg: ArchConfig, *,
                impl: str = "auto"):
    """tokens (B,) -> (logits (B, V), new cache): every mamba block one
    step (the scan at L = 1), each shared-block application one decode
    attention over its own ring.  The cache passed in is left as it
    was."""
    e = cfg.shared_attn_every
    pos = cache["pos"]
    h = params["embed"][tokens.long()].to(cfg.tdtype)
    cos, sin = Rotary(cfg.hd, cfg.rope_theta).freqs(pos)
    shared = params.get("shared")
    kc, vc = list(cache["attn_k"].unbind(0)), list(cache["attn_v"].unbind(0))
    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    ssm, conv = [], []
    for i in range(cfg.n_layers):
        if e and i % e == 0:
            a = i // e
            out, kc[a], vc[a] = _attention_decode(
                rms_norm(h, shared["attn_norm"]), shared, cfg, kc[a], vc[a],
                pos, cos, sin, impl=impl)
            h = h + out
            m, _ = _mlp(rms_norm(h, shared["mlp_norm"])[:, None], shared,
                        cfg)
            h = h + m[:, 0]
        h, (s_new, c_new) = block_decode(
            h, {k: v[i] for k, v in blocks.items()}, cache["ssm"][i],
            cache["conv"][i], impl=impl)
        ssm.append(s_new)
        conv.append(c_new)
    h = rms_norm(h, params["final_norm"])
    new_cache = {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
                 "attn_k": torch.stack(kc) if kc else cache["attn_k"],
                 "attn_v": torch.stack(vc) if vc else cache["attn_v"],
                 "pos": pos + 1}
    return h @ params["lm_head"], new_cache


# --- Program lowering (generic named state) ---------------------------------------
def _emit_shared_block(g, cfg, a: int, resid: str, M: int, by: int,
                       add_attention) -> str:
    """Emit one application of the shared attention block -- standard
    transformer ops against the *unstacked* "shared/..." params (the
    same weights at every application; only the KV regions differ per
    application index ``a``)."""
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    an = f"app{a}.attn_norm"
    g.add(norm_node(an, M * D, dtype_bytes=by, inputs=[resid],
                    norm="rmsnorm", param="shared/attn_norm"))
    g.add(matmul_node(f"app{a}.wq", M, D, H * hd, dtype_bytes=by,
                      inputs=[an], param="shared/wq"))
    g.add(matmul_node(f"app{a}.wk", M, D, KV * hd, dtype_bytes=by,
                      inputs=[an], param="shared/wk"))
    g.add(matmul_node(f"app{a}.wv", M, D, KV * hd, dtype_bytes=by,
                      inputs=[an], param="shared/wv"))
    add_attention(g, a, [f"app{a}.wq", f"app{a}.wk", f"app{a}.wv"])
    wo = f"app{a}.wo"
    g.add(matmul_node(wo, M, H * hd, D, dtype_bytes=by,
                      inputs=[f"app{a}.attn"], bypass_of=resid,
                      param="shared/wo"))
    mn = f"app{a}.mlp_norm"
    g.add(norm_node(mn, M * D, dtype_bytes=by, inputs=[wo],
                    norm="rmsnorm", param="shared/mlp_norm"))
    g.add(matmul_node(f"app{a}.w_gate", M, D, F, dtype_bytes=by,
                      inputs=[mn], fused_activation=cfg.activation,
                      param="shared/w_gate"))
    g.add(matmul_node(f"app{a}.w_up", M, D, F, dtype_bytes=by,
                      inputs=[mn], param="shared/w_up"))
    g.add(elementwise_node(f"app{a}.glu_mul", "mul", M * F, dtype_bytes=by,
                           inputs=[f"app{a}.w_gate", f"app{a}.w_up"]))
    g.add(matmul_node(f"app{a}.w_down", M, F, D, dtype_bytes=by,
                      inputs=[f"app{a}.glu_mul"], bypass_of=wo,
                      param="shared/w_down"))
    return f"app{a}.w_down"


def _mamba_state_names(i: int) -> tuple[str, str]:
    """Per-layer persistent state names, in ProgramOp.state_regions
    order (recurrent SSM state, conv taps)."""
    return (f"l{i}.ssm", f"l{i}.conv")


def to_graph(cfg: ArchConfig, batch: int = 1, seq: int = 64,
             dtype_bytes: int | None = None,
             write_cache: bool = False) -> ModelGraph:
    """Lower the zamba2 hybrid to the compiler IR: the shared attention
    block (every ``shared_attn_every`` layers, *before* that layer's
    mamba block) lowers fine-grained -- it IS a transformer block, so it
    reuses the dense op vocabulary including the windowed ring KV plan,
    one pair of KV regions per application -- while each mamba block is
    one coarse ``ssm_scan`` op (pre-norm + conv + selective scan + gated
    out-proj + residual) against its recurrent state."""
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    D = cfg.d_model
    e = cfg.shared_attn_every
    M = batch * seq

    def add_attention(g, a, qkv):
        cache_meta = ({"k_cache": f"app{a}.k_cache",
                       "v_cache": f"app{a}.v_cache"} if write_cache else {})
        g.add(attention_node(
            f"app{a}.attn", seq_q=seq, seq_kv=seq, heads=cfg.n_heads,
            kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, batch=batch,
            causal=True, dtype_bytes=by, inputs=qkv,
            window=cfg.attn_window, rope_theta=cfg.rope_theta,
            **cache_meta))

    g = ModelGraph(cfg.name)
    g.add(embed_node("embed", M, cfg.vocab, D, dtype_bytes=by,
                     param="embed"))
    resid = "embed"
    for i in range(cfg.n_layers):
        if e and i % e == 0:
            resid = _emit_shared_block(g, cfg, i // e, resid, M, by,
                                       add_attention)
        g.add(ssm_scan_node(
            f"l{i}.mamba", seq=seq, heads=cfg.ssm_heads,
            head_dim=cfg.ssm_head_dim, state=cfg.ssm_state, d_model=D,
            batch=batch, dtype_bytes=by, inputs=[resid],
            param=f"blocks:{i}",
            **({"states": _mamba_state_names(i)} if write_cache else {})))
        resid = f"l{i}.mamba"
    g.add(norm_node("final_norm", M * D, dtype_bytes=by, inputs=[resid],
                    norm="rmsnorm", param="final_norm"))
    g.add(matmul_node("lm_head", M, D, cfg.vocab, dtype_bytes=by,
                      inputs=["final_norm"], param="lm_head"))
    return g


def to_decode_graph(cfg: ArchConfig, slots: int = 8, max_len: int = 256,
                    dtype_bytes: int | None = None) -> ModelGraph:
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    D = cfg.d_model
    e = cfg.shared_attn_every
    W = min(max_len, cfg.attn_window) if cfg.attn_window else max_len

    def add_attention(g, a, qkv):
        g.add(decode_attention_node(
            f"app{a}.attn", cache_len=W, heads=cfg.n_heads,
            kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, slots=slots,
            dtype_bytes=by, inputs=qkv, window=cfg.attn_window,
            rope_theta=cfg.rope_theta, k_cache=f"app{a}.k_cache",
            v_cache=f"app{a}.v_cache"))

    g = ModelGraph(cfg.name + ".decode")
    g.add(embed_node("embed", slots, cfg.vocab, D, dtype_bytes=by,
                     param="embed"))
    resid = "embed"
    for i in range(cfg.n_layers):
        if e and i % e == 0:
            resid = _emit_shared_block(g, cfg, i // e, resid, slots, by,
                                       add_attention)
        g.add(ssm_scan_node(
            f"l{i}.mamba", seq=1, heads=cfg.ssm_heads,
            head_dim=cfg.ssm_head_dim, state=cfg.ssm_state, d_model=D,
            batch=slots, dtype_bytes=by, inputs=[resid],
            param=f"blocks:{i}", states=_mamba_state_names(i),
            decode=True))
        resid = f"l{i}.mamba"
    g.add(norm_node("final_norm", slots * D, dtype_bytes=by,
                    inputs=[resid], norm="rmsnorm", param="final_norm"))
    g.add(matmul_node("lm_head", slots, D, cfg.vocab, dtype_bytes=by,
                      inputs=["final_norm"], param="lm_head"))
    return g


def _hybrid_state_specs(cfg: ArchConfig, slots: int, max_len: int):
    """Per-layer SSM recurrent state (f32, O(1) in ``max_len``) + conv
    taps, plus one ring KV pair per shared-attention *application*.
    Windowed is the only serving capability that survives the mix: the
    ring KV slides, but the recurrent state is neither pageable nor
    chunkable nor rollback-truncatable."""
    di, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    dt, kdt = cfg.tdtype, cfg.kv_tdtype
    W = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    kv_shape = (slots, W, cfg.n_kv_heads, cfg.hd)
    kv_name = str(kdt).removeprefix("torch.")
    kv_size = math.prod(kv_shape) * kdt.itemsize
    specs = []
    for a in range(_n_apps(cfg)):
        specs.append(PersistentSpec(f"app{a}.k_cache", kv_shape, kv_name,
                                    kv_size))
        specs.append(PersistentSpec(f"app{a}.v_cache", kv_shape, kv_name,
                                    kv_size))
    s_shape = (slots, H, N, P)
    c_shape = (slots, _CONV_K - 1, di + 2 * N)
    for i in range(cfg.n_layers):
        ssm_name, conv_name = _mamba_state_names(i)
        specs.append(PersistentSpec(ssm_name, s_shape, "float32",
                                    math.prod(s_shape) * 4))
        specs.append(PersistentSpec(
            conv_name, c_shape, str(dt).removeprefix("torch."),
            math.prod(c_shape) * dt.itemsize))
    return tuple(specs), StateCaps(windowed=True)


register_state_family("hybrid", _hybrid_state_specs)
