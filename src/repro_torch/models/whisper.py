"""Whisper-style encoder-decoder on the Program path (counterpart of
``repro/models/whisper.py``).

As in the reference the modality frontend is a stub: a request carries
precomputed frame embeddings (T_enc, D) standing in for the log-mel +
conv1d stem.  The backbone is faithful: pre-LN layernorm blocks,
non-gated GELU MLPs, sinusoidal encoder positions, learned decoder
positions, a tied decoder head (the embedding read transposed) and
cross-attention in every decoder layer.

``encode`` runs the encoder (a loop over the stacked encoder blocks, the
reference's ``jax.lax.scan``); ``encode_memory`` runs it once per
admitted request and projects each decoder layer's cross K/V, the rows
the serving engine writes into the pair's *read-only* persistent memory
regions at the slot before the prefill Program runs.  ``to_graph`` /
``to_decode_graph`` lower the decoder (the encoder never enters the
per-token instruction stream) and ``_audio_state_specs`` mints its state
(registered as the "audio" state family).  The legacy ``forward`` (the
encoder, then the decoder over ``encoder_frames``; with ``return_cache``
the self K/V, the cross K/V and ``pos``), ``init_cache`` and
``decode_step`` (one decode-attention launch over the self ring and one
over the cross rows per layer) are the reference's, as a Python loop
over the layers.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.ir import (ModelGraph, attention_node, cross_attention_node,
                       decode_attention_node, embed_node, matmul_node,
                       norm_node)
from ..core.regions import PersistentSpec, StateCaps, register_state_family
from ..kernels.decode_attention import decode_attention
from .common import ParamDef, layer_norm
from .transformer import _attention, _attn_defs, _heads, _mlp, _write_cache

__all__ = ["param_defs", "encode", "encode_memory", "to_graph",
           "to_decode_graph", "forward", "init_cache", "decode_step"]


def _ln_defs(cfg, L, name):
    dt = cfg.tdtype
    shape = (L, cfg.d_model) if L else (cfg.d_model,)
    axes = ("layers", "embed") if L else ("embed",)
    return {name: ParamDef(shape, axes, dt, "ones"),
            name + "_b": ParamDef(shape, axes, dt, "zeros")}


def param_defs(cfg: ArchConfig) -> dict:
    dt = cfg.tdtype
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    enc = {}
    enc.update(_ln_defs(cfg, Le, "attn_norm"))
    enc.update(_attn_defs(cfg, Le))
    enc.update(_ln_defs(cfg, Le, "mlp_norm"))
    enc["w_gate"] = ParamDef((Le, cfg.d_model, cfg.d_ff),
                             ("layers", "embed", "ff"), dt)
    enc["w_down"] = ParamDef((Le, cfg.d_ff, cfg.d_model),
                             ("layers", "ff", "embed"), dt)
    dec = {}
    dec.update(_ln_defs(cfg, Ld, "attn_norm"))
    dec.update(_attn_defs(cfg, Ld))
    dec.update(_ln_defs(cfg, Ld, "cross_norm"))
    dec.update({"x" + k: v for k, v in _attn_defs(cfg, Ld).items()})
    dec.update(_ln_defs(cfg, Ld, "mlp_norm"))
    dec["w_gate"] = ParamDef((Ld, cfg.d_model, cfg.d_ff),
                             ("layers", "embed", "ff"), dt)
    dec["w_down"] = ParamDef((Ld, cfg.d_ff, cfg.d_model),
                             ("layers", "ff", "embed"), dt)
    defs = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                          dt, "embed"),
        "pos_embed": ParamDef((cfg.max_pos or 4096, cfg.d_model),
                              (None, "embed"), dt, "embed"),
        "enc_blocks": enc,
        "dec_blocks": dec,
    }
    defs.update(_ln_defs(cfg, None, "enc_final_norm"))
    defs.update(_ln_defs(cfg, None, "final_norm"))
    return defs


def _sinusoid(T: int, D: int, device=None) -> torch.Tensor:
    half = D // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / (half - 1))
    ang = torch.arange(T, device=device)[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _WhisperCfg:
    """Proxy making the shared transformer helpers use layernorm and a
    non-gated GELU MLP."""

    def __init__(self, cfg):
        object.__setattr__(self, "_c", cfg)

    def __getattr__(self, k):
        if k == "norm":
            return "layernorm"
        if k in ("gated_mlp",):
            return False
        if k == "activation":
            return "gelu"
        if k == "n_experts":
            return 0
        return getattr(self._c, k)


def encode(params, frames, cfg: ArchConfig, *, impl: str = "auto"):
    """frames: (B, T_enc, D) stub embeddings -> (B, T_enc, D).  The
    attention is the non-causal flash kernel; the projections are plain
    ``@``, as in the reference."""
    c = _WhisperCfg(cfg)
    dt = cfg.tdtype
    h = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model,
                                  frames.device).to(dt)[None]
    blocks = {k: v.unbind(0) for k, v in params["enc_blocks"].items()}
    for i in range(cfg.n_encoder_layers):
        p_i = {k: v[i] for k, v in blocks.items()}
        a = _attention(layer_norm(h, p_i["attn_norm"], p_i["attn_norm_b"]),
                       p_i, c, None, None, impl=impl, causal=False)
        h = h + a
        m, _ = _mlp(layer_norm(h, p_i["mlp_norm"], p_i["mlp_norm_b"]),
                    p_i, c)
        h = h + m
    return layer_norm(h, params["enc_final_norm"],
                      params["enc_final_norm_b"])


def _cross_kv(params, cfg, enc_out):
    """Each decoder layer's cross K and V of the encoder output: two
    (L, B, KV, T_enc, hd) stacks."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    p = params["dec_blocks"]
    xk = [_heads(enc_out @ w, KV, hd) for w in p["xwk"].unbind(0)]
    xv = [_heads(enc_out @ w, KV, hd) for w in p["xwv"].unbind(0)]
    return torch.stack(xk), torch.stack(xv)


@torch.no_grad()
def encode_memory(params, frames, cfg: ArchConfig, *,
                  impl: str = "auto") -> dict:
    """Run the encoder once and project the per-layer cross K/V -- the
    admission-time write into the decoder Program's *read-only*
    persistent memory regions.  ``frames`` is one request's (T_enc, D)
    stub embedding (or (1, T_enc, D)); returns {region name: (T_enc,
    KV, hd) row} for the engine to place at the admitted slot."""
    if frames.ndim == 2:
        frames = frames[None]
    enc_out = encode(params, frames, cfg, impl=impl)
    xk, xv = _cross_kv(params, cfg, enc_out)        # (L, 1, KV, Te, hd)
    rows = {}
    for i in range(cfg.n_layers):
        rows[f"l{i}.cross_k"] = xk[i, 0].transpose(0, 1)
        rows[f"l{i}.cross_v"] = xv[i, 0].transpose(0, 1)
    return rows


def forward(params, tokens, cfg: ArchConfig, *, encoder_frames=None,
            impl: str = "auto", return_cache: bool = False,
            cache_len: int | None = None, remat: bool = False,
            return_hidden: bool = False) -> dict:
    """The legacy decoder forward over the encoded ``encoder_frames`` (B,
    T_enc, D): tokens (B, S) -> {"logits", "aux": {}[, "cache"]}, or
    with ``return_hidden`` {"logits": None, "hidden": the final-norm
    output (B, S, D), "aux": {}}.  The encoder runs inside, so its
    weights get gradients too.  ``remat`` recomputes each decoder block
    in the backward pass (the encoder's are kept), as the reference's
    ``jax.checkpoint(body)``.  The cache holds the self K/V (L, B, KV,
    cache_len, hd), zero-padded past S, the cross K/V (L, B, KV, T_enc,
    hd) and ``pos``."""
    if encoder_frames is None:
        raise ValueError("whisper needs encoder_frames")
    c = _WhisperCfg(cfg)
    enc_out = encode(params, encoder_frames, cfg, impl=impl)
    B, S = tokens.shape
    h = params["embed"][tokens.long()].to(cfg.tdtype)
    h = h + params["pos_embed"][:S][None].to(cfg.tdtype)

    def body(x, p_i, mem):
        a, kv = _attention(layer_norm(x, p_i["attn_norm"],
                                      p_i["attn_norm_b"]),
                           p_i, c, None, None, impl=impl, causal=True,
                           return_kv=True)
        x = x + a
        xp = {k[1:]: v for k, v in p_i.items() if k.startswith("x")}
        x = x + _attention(layer_norm(x, p_i["cross_norm"],
                                      p_i["cross_norm_b"]),
                           xp, c, None, None, impl=impl, causal=False,
                           kv_override=mem)
        m, _ = _mlp(layer_norm(x, p_i["mlp_norm"], p_i["mlp_norm_b"]),
                    p_i, c)
        return x + m, kv

    blocks = {k: v.unbind(0) for k, v in params["dec_blocks"].items()}
    kvs = []
    for i in range(cfg.n_layers):
        p_i = {k: v[i] for k, v in blocks.items()}
        if remat:
            # No forward draws random numbers: no RNG state is kept.
            h, kv = checkpoint(body, h, p_i, enc_out, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            h, kv = body(h, p_i, enc_out)
        if return_cache:
            kvs.append(kv)
    h = layer_norm(h, params["final_norm"], params["final_norm_b"])
    out = {"logits": None if return_hidden else h @ params["embed"].T,
           "aux": {}}
    if return_hidden:
        out["hidden"] = h
    if return_cache:
        k_stack = torch.stack([k for k, _ in kvs])
        v_stack = torch.stack([v for _, v in kvs])
        CL = cache_len or S
        if CL > S:
            k_stack = torch.nn.functional.pad(k_stack, (0, 0, 0, CL - S))
            v_stack = torch.nn.functional.pad(v_stack, (0, 0, 0, CL - S))
        xk, xv = _cross_kv(params, cfg, enc_out)
        dt = cfg.kv_tdtype
        out["cache"] = {"k": k_stack.to(dt), "v": v_stack.to(dt),
                        "pos": torch.full((B,), S, dtype=torch.int32,
                                          device=h.device),
                        "cross_k": xk.to(dt), "cross_v": xv.to(dt)}
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed legacy cache: self K/V (L, batch, KV, max_len, hd), cross
    K/V (L, batch, KV, T_enc, hd), ``pos``."""
    KV, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    dt = cfg.kv_tdtype
    Te = cfg.encoder_seq

    def zeros(rows):
        return torch.zeros((L, batch, KV, rows, hd), dtype=dt, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len), "cross_k": zeros(Te),
            "cross_v": zeros(Te),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(params, cache, tokens, cfg: ArchConfig, *,
                impl: str = "auto"):
    """tokens (B,) -> (logits (B, V), new cache): per layer the new row
    written at ``pos % max_len``, one decode attention over the ring and
    one over all the cross rows.  The cache passed in is left as it
    was."""
    c = _WhisperCfg(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = params["embed"][tokens.long()].to(cfg.tdtype)
    h = h + params["pos_embed"][pos.long()].to(cfg.tdtype)
    blocks = {k: v.unbind(0) for k, v in params["dec_blocks"].items()}
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p_i = {k: v[i] for k, v in blocks.items()}
        a_in = layer_norm(h, p_i["attn_norm"], p_i["attn_norm_b"])
        q = (a_in @ p_i["wq"]).reshape(B, H, hd)
        k = (a_in @ p_i["wk"]).reshape(B, KV, hd)
        v = (a_in @ p_i["wv"]).reshape(B, KV, hd)
        ck, cv = cache["k"][i], cache["v"][i]
        ck, cv = _write_cache(ck, cv, k.to(ck.dtype), v.to(cv.dtype),
                              pos % ck.shape[2])
        a = decode_attention(q, ck, cv,
                             kv_len=(pos + 1).clamp(max=ck.shape[2]),
                             impl=impl)
        h = h + a.reshape(B, H * hd) @ p_i["wo"]
        x_in = layer_norm(h, p_i["cross_norm"], p_i["cross_norm_b"])
        xq = (x_in @ p_i["xwq"]).reshape(B, H, hd)
        xa = decode_attention(xq, cache["cross_k"][i], cache["cross_v"][i],
                              impl=impl)
        h = h + xa.reshape(B, H * hd) @ p_i["xwo"]
        m, _ = _mlp(layer_norm(h, p_i["mlp_norm"], p_i["mlp_norm_b"])[:, None],
                    p_i, c)
        h = h + m[:, 0]
        ks.append(ck)
        vs.append(cv)
    h = layer_norm(h, params["final_norm"], params["final_norm_b"])
    new_cache = dict(cache)
    new_cache.update({"k": torch.stack(ks), "v": torch.stack(vs),
                      "pos": pos + 1})
    return h @ params["embed"].T, new_cache


def to_graph(cfg: ArchConfig, batch: int = 1, seq: int = 64,
             dtype_bytes: int | None = None,
             write_cache: bool = False) -> ModelGraph:
    """Lower the whisper *decoder* to the compiler IR: pre-LN layernorm
    blocks with a causal self-attention arm (standard dense KV plan)
    and a ``cross_attention`` arm per layer reading the persistent
    encoder memory (``encode_memory`` fills it at admission -- the
    encoder itself runs once per request, outside the token loop, so it
    never appears in the per-token instruction stream).  The tied head
    reuses the embedding table transposed."""
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    Te = cfg.encoder_seq
    M = batch * seq
    g = ModelGraph(cfg.name)
    g.add(embed_node("embed", M, cfg.vocab, D, dtype_bytes=by,
                     param="embed", param_b="pos_embed"))
    resid = "embed"
    for i in range(cfg.n_layers):
        def bp(k, i=i):
            return f"dec_blocks/{k}:{i}"
        an = f"l{i}.attn_norm"
        g.add(norm_node(an, M * D, dtype_bytes=by, inputs=[resid],
                        norm="layernorm", param=bp("attn_norm"),
                        param_b=bp("attn_norm_b")))
        g.add(matmul_node(f"l{i}.wq", M, D, H * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wq")))
        g.add(matmul_node(f"l{i}.wk", M, D, KV * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wk")))
        g.add(matmul_node(f"l{i}.wv", M, D, KV * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wv")))
        cache_meta = ({"k_cache": f"l{i}.k_cache",
                       "v_cache": f"l{i}.v_cache"} if write_cache else {})
        g.add(attention_node(
            f"l{i}.attn", seq_q=seq, seq_kv=seq, heads=H, kv_heads=KV,
            head_dim=hd, batch=batch, causal=True, dtype_bytes=by,
            inputs=[f"l{i}.wq", f"l{i}.wk", f"l{i}.wv"], **cache_meta))
        wo = f"l{i}.wo"
        g.add(matmul_node(wo, M, H * hd, D, dtype_bytes=by,
                          inputs=[f"l{i}.attn"], bypass_of=resid,
                          param=bp("wo")))
        cn = f"l{i}.cross_norm"
        g.add(norm_node(cn, M * D, dtype_bytes=by, inputs=[wo],
                        norm="layernorm", param=bp("cross_norm"),
                        param_b=bp("cross_norm_b")))
        g.add(matmul_node(f"l{i}.xwq", M, D, H * hd, dtype_bytes=by,
                          inputs=[cn], param=bp("xwq")))
        g.add(cross_attention_node(
            f"l{i}.cross", seq_q=seq, mem_len=Te, heads=H, kv_heads=KV,
            head_dim=hd, batch=batch, k_mem=f"l{i}.cross_k",
            v_mem=f"l{i}.cross_v", dtype_bytes=by,
            inputs=[f"l{i}.xwq"]))
        xwo = f"l{i}.xwo"
        g.add(matmul_node(xwo, M, H * hd, D, dtype_bytes=by,
                          inputs=[f"l{i}.cross"], bypass_of=wo,
                          param=bp("xwo")))
        mn = f"l{i}.mlp_norm"
        g.add(norm_node(mn, M * D, dtype_bytes=by, inputs=[xwo],
                        norm="layernorm", param=bp("mlp_norm"),
                        param_b=bp("mlp_norm_b")))
        g.add(matmul_node(f"l{i}.w_gate", M, D, F, dtype_bytes=by,
                          inputs=[mn], fused_activation="gelu",
                          param=bp("w_gate")))
        g.add(matmul_node(f"l{i}.w_down", M, F, D, dtype_bytes=by,
                          inputs=[f"l{i}.w_gate"], bypass_of=xwo,
                          param=bp("w_down")))
        resid = f"l{i}.w_down"
    g.add(norm_node("final_norm", M * D, dtype_bytes=by, inputs=[resid],
                    norm="layernorm", param="final_norm",
                    param_b="final_norm_b"))
    g.add(matmul_node("lm_head", M, D, cfg.vocab, dtype_bytes=by,
                      inputs=["final_norm"], param="embed",
                      transpose_w=True))
    return g


def to_decode_graph(cfg: ArchConfig, slots: int = 8, max_len: int = 256,
                    dtype_bytes: int | None = None) -> ModelGraph:
    """The per-token decode step: one row per slot, the self-attention
    against the slot's KV ring and the cross arm a decode over the
    slot's whole encoder memory."""
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    Te = cfg.encoder_seq
    g = ModelGraph(cfg.name + ".decode")
    g.add(embed_node("embed", slots, cfg.vocab, D, dtype_bytes=by,
                     param="embed", param_b="pos_embed"))
    resid = "embed"
    for i in range(cfg.n_layers):
        def bp(k, i=i):
            return f"dec_blocks/{k}:{i}"
        an = f"l{i}.attn_norm"
        g.add(norm_node(an, slots * D, dtype_bytes=by, inputs=[resid],
                        norm="layernorm", param=bp("attn_norm"),
                        param_b=bp("attn_norm_b")))
        g.add(matmul_node(f"l{i}.wq", slots, D, H * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wq")))
        g.add(matmul_node(f"l{i}.wk", slots, D, KV * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wk")))
        g.add(matmul_node(f"l{i}.wv", slots, D, KV * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wv")))
        g.add(decode_attention_node(
            f"l{i}.attn", cache_len=max_len, heads=H, kv_heads=KV,
            head_dim=hd, slots=slots, dtype_bytes=by,
            inputs=[f"l{i}.wq", f"l{i}.wk", f"l{i}.wv"],
            k_cache=f"l{i}.k_cache", v_cache=f"l{i}.v_cache"))
        wo = f"l{i}.wo"
        g.add(matmul_node(wo, slots, H * hd, D, dtype_bytes=by,
                          inputs=[f"l{i}.attn"], bypass_of=resid,
                          param=bp("wo")))
        cn = f"l{i}.cross_norm"
        g.add(norm_node(cn, slots * D, dtype_bytes=by, inputs=[wo],
                        norm="layernorm", param=bp("cross_norm"),
                        param_b=bp("cross_norm_b")))
        g.add(matmul_node(f"l{i}.xwq", slots, D, H * hd, dtype_bytes=by,
                          inputs=[cn], param=bp("xwq")))
        g.add(cross_attention_node(
            f"l{i}.cross", seq_q=1, mem_len=Te, heads=H, kv_heads=KV,
            head_dim=hd, batch=slots, k_mem=f"l{i}.cross_k",
            v_mem=f"l{i}.cross_v", dtype_bytes=by, decode=True,
            inputs=[f"l{i}.xwq"]))
        xwo = f"l{i}.xwo"
        g.add(matmul_node(xwo, slots, H * hd, D, dtype_bytes=by,
                          inputs=[f"l{i}.cross"], bypass_of=wo,
                          param=bp("xwo")))
        mn = f"l{i}.mlp_norm"
        g.add(norm_node(mn, slots * D, dtype_bytes=by, inputs=[xwo],
                        norm="layernorm", param=bp("mlp_norm"),
                        param_b=bp("mlp_norm_b")))
        g.add(matmul_node(f"l{i}.w_gate", slots, D, F, dtype_bytes=by,
                          inputs=[mn], fused_activation="gelu",
                          param=bp("w_gate")))
        g.add(matmul_node(f"l{i}.w_down", slots, F, D, dtype_bytes=by,
                          inputs=[f"l{i}.w_gate"], bypass_of=xwo,
                          param=bp("w_down")))
        resid = f"l{i}.w_down"
    g.add(norm_node("final_norm", slots * D, dtype_bytes=by,
                    inputs=[resid], norm="layernorm", param="final_norm",
                    param_b="final_norm_b"))
    g.add(matmul_node("lm_head", slots, D, cfg.vocab, dtype_bytes=by,
                      inputs=["final_norm"], param="embed",
                      transpose_w=True))
    return g


def _audio_state_specs(cfg: ArchConfig, slots: int, max_len: int):
    """Per-layer self-attention KV (standard dense ring) plus the
    *read-only* encoder memory pair written once at admission.  No
    serving capability survives the encoder coupling: memory rows are
    admission-bound (not pageable/speculatable) and the cross arm needs
    them before the first decoder row computes (not chunkable)."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    kdt = cfg.kv_tdtype
    name = str(kdt).removeprefix("torch.")
    Te = cfg.encoder_seq
    specs = []
    for i in range(cfg.n_layers):
        for side, rows, ro in (("k_cache", max_len, False),
                               ("v_cache", max_len, False),
                               ("cross_k", Te, True),
                               ("cross_v", Te, True)):
            shape = (slots, rows, KV, hd)
            specs.append(PersistentSpec(
                f"l{i}.{side}", shape, name,
                math.prod(shape) * kdt.itemsize, read_only=ro))
    return tuple(specs), StateCaps()


register_state_family("audio", _audio_state_specs)
