"""Decoder-only transformer LM: dense, MoE and the gated cross-attention
(vlm, llama-3.2-vision) variants, one implementation parameterized by
``ArchConfig`` (counterpart of ``repro/models/transformer.py``), and the
Program-pair entry point of every LM family.

``to_graph`` emits the layer graph (embed -> N x {norm, qkv matmuls,
flash attention, o-proj, MLP matmul chain or one ``moe_dispatch`` op}
-> final norm -> lm head) with the residual adds fused into the
o-/down-projection (or dispatch) writebacks; ``compile_program`` runs
it through graph -> schedule -> regions -> Program, and
``program_forward`` executes the instruction stream through
runtime/executor.py.  ``compile_program_pair`` compiles the stateful
serving pair (batch-1 prefill writing the KV cache, per-token decode)
sharing one persistent region table -- contiguous, rolling-window or
(``paged=True``) the §5.1 paged plan of page pools and a page table,
optionally in int8 pages.  The recurrent families lower through their
own modules' graph builders (``ssm`` through models/rwkv.py, ``hybrid``
through models/zamba2.py), dispatched by ``compile_program_pair``.
``compile_draft_pair`` compiles the speculative-decode draft's pair at
the target's geometry, after its vocab, window and family gates.

MoE configs put their experts in every layer (granite,
``moe_every=1``: the experts stacked in "blocks") or interleave
(llama4, ``moe_every=2``: ``moe_every - 1`` dense layers, then one MoE
layer, whose parameters live in "moe_blocks"); ``_block_path`` maps a
global layer to its group for the forward and the graph alike.

``forward`` is the reference's legacy forward, the training path and
the legacy serving loop's prefill: the stacked ``(L, ...)`` block
parameters run as a Python loop (the reference's ``jax.lax.scan``), each
block optionally under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` with ``nothing_saveable``), every projection a plain
``@``, attention the differentiable ``flash_attention`` and an MoE layer
``models/moe.py``; its ``aux`` holds the MoE layers' mean load-balance
statistics.  A vlm config runs its layers in groups: a gated
cross-attention block over ``vision_embeds`` (non-causal flash, no
RoPE, ``tanh(gate)`` on the residual), then ``cross_attn_every`` self
layers.  ``return_cache`` returns the legacy cache -- ``(L, B, KV, S,
hd)`` K/V padded to ``cache_len`` or converted to a ring for a window,
the ``pos`` vector and, for the vlm, the ``(G, B, KV, Tv, hd)`` cross
K/V -- and ``decode_step`` advances it one token a sequence through the
decode-attention kernel, returning a new cache (the one passed in is
left as it was).  The vlm has no Program lowering (``_require_dense``
names its blockers): the serving engine serves it on that legacy loop,
as the reference does.  The audio family (whisper) lowers through
models/whisper.py, dispatched by ``compile_program_pair``.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.hw import TPU_V5E, HardwareModel
from ..core.ir import (ModelGraph, attention_node, decode_attention_node,
                       elementwise_node, embed_node, matmul_node, moe_node,
                       norm_node)
from ..core.program import Program, ProgramPair, lower_to_program
from ..core.regions import (PAGE_TABLE_REGION, PersistentSpec, StateCaps,
                            allocate_regions, extend_with_persistent,
                            paged_kv_specs, register_state_family,
                            state_specs)
from ..core.schedule import compile_model
from ..kernels.common import apply_activation
from ..kernels.decode_attention import (decode_attention, ring_kv_len,
                                        ring_positions)
from ..kernels.flash_attention import flash_attention
from ..parallel import split
from ..parallel.act_sharding import activation_rules, current_rules
from ..runtime.executor import graphed_runner
from .common import ParamDef, Rotary, apply_rope, layer_norm, rms_norm
from .moe import moe_mlp

__all__ = ["param_defs", "forward", "init_cache", "decode_step",
           "to_graph", "to_decode_graph", "compile_program",
           "compile_program_pair", "compile_draft_pair", "program_forward",
           "kv_cache_len", "LoweringBlocked"]


# --- parameter declaration -------------------------------------------------------
def _norm_defs(cfg: ArchConfig, L: int | None, name: str) -> dict:
    """Norm params; nonparametric LN (OLMo) contributes none."""
    if cfg.norm == "nonparametric":
        return {}
    dt = cfg.tdtype
    shape = (L, cfg.d_model) if L else (cfg.d_model,)
    axes = ("layers", "embed") if L else ("embed",)
    d = {name: ParamDef(shape, axes, dt, "ones")}
    if cfg.norm == "layernorm":
        d[name + "_b"] = ParamDef(shape, axes, dt, "zeros")
    return d


def _stacked(cfg: ArchConfig, L: int | None):
    def p(shape, axes):
        if L:
            return ParamDef((L,) + shape, ("layers",) + axes, cfg.tdtype)
        return ParamDef(shape, axes, cfg.tdtype)
    return p


def _attn_defs(cfg: ArchConfig, L: int | None) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = _stacked(cfg, L)
    return {
        "wq": p((D, H * hd), ("embed", "heads")),
        "wk": p((D, KV * hd), ("embed", "kv_heads")),
        "wv": p((D, KV * hd), ("embed", "kv_heads")),
        "wo": p((H * hd, D), ("heads", "embed")),
    }


def _mlp_defs(cfg: ArchConfig, L: int | None, moe: bool | None = None) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    p = _stacked(cfg, L)
    use_moe = cfg.n_experts > 0 if moe is None else moe
    if use_moe:
        E = cfg.n_experts
        d = {"router": p((D, E), ("embed", None)),
             "w_gate": p((E, D, F), ("experts", "embed", "ff")),
             "w_down": p((E, F, D), ("experts", "ff", "embed"))}
        if cfg.gated_mlp:
            d["w_up"] = p((E, D, F), ("experts", "embed", "ff"))
        return d
    d = {"w_gate": p((D, F), ("embed", "ff")),
         "w_down": p((F, D), ("ff", "embed"))}
    if cfg.gated_mlp:
        d["w_up"] = p((D, F), ("embed", "ff"))
    return d


def _block_defs(cfg: ArchConfig, L: int, moe: bool | None = None) -> dict:
    blocks = {}
    blocks.update(_norm_defs(cfg, L, "attn_norm"))
    blocks.update(_attn_defs(cfg, L))
    blocks.update(_norm_defs(cfg, L, "mlp_norm"))
    blocks.update(_mlp_defs(cfg, L, moe))
    return blocks


def _interleaved(cfg: ArchConfig) -> bool:
    """MoE layers every ``moe_every`` layers, in their own group."""
    return cfg.n_experts > 0 and cfg.moe_every > 1


def param_defs(cfg: ArchConfig) -> dict:
    L = cfg.n_layers
    defs = {"embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                              cfg.tdtype, "embed")}
    if _interleaved(cfg):
        assert L % cfg.moe_every == 0, (L, cfg.moe_every)
        G = L // cfg.moe_every
        defs["blocks"] = _block_defs(cfg, L - G, moe=False)
        defs["moe_blocks"] = _block_defs(cfg, G, moe=True)
    else:
        defs["blocks"] = _block_defs(cfg, L)
    defs.update(_norm_defs(cfg, None, "final_norm"))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab),
                                   ("embed", "vocab"), cfg.tdtype)
    if cfg.cross_attn_every:
        G = cfg.n_layers // cfg.cross_attn_every
        cross = _norm_defs(cfg, G, "attn_norm")
        cross.update(_attn_defs(cfg, G))
        cross["gate"] = ParamDef((G,), ("layers",), cfg.tdtype, "zeros")
        defs["cross_blocks"] = cross
    return defs


# --- the legacy forward (training) ----------------------------------------------
def _norm(h, p, cfg, name):
    if cfg.norm == "nonparametric":
        return layer_norm(h)
    if cfg.norm == "layernorm":
        return layer_norm(h, p[name], p.get(name + "_b"))
    return rms_norm(h, p[name])


def _heads(x, n, hd):
    B, S = x.shape[0], x.shape[1]
    return x.reshape(B, S, n, hd).transpose(1, 2)          # (B, n, S, hd)


def _mm(a, b):
    """``a @ b`` with mixed operand types promoted as JAX promotes them
    (``torch.promote_types``; never a cast down): f32 vision embeddings
    under bf16 weights give f32 K/V, as in the reference."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def _proj(x, p, name):
    """``x @ p[name]`` (promoted as ``_mm``); under a sharded step's
    split, the rank's columns or its reduced rows
    (``parallel/split.py``)."""
    sp = split.active()
    return _mm(x, p[name]) if sp is None else sp.proj(x, p[name], name)


def _attention(h, p, cfg, cos, sin, *, impl, causal=True, window=None,
               kv_override=None, return_kv=False):
    """Self- (or, with ``kv_override`` (B, Skv, D), cross-) attention on
    (B, S, D); RoPE only where ``cos`` is given (on q alone for cross
    attention).  ``return_kv`` also returns the (B, KV, S, hd) K and V
    the attention read.  Under a split, ``h`` enters through
    ``split.enter``."""
    h = split.enter(h, "attn")
    B, S, _ = h.shape
    H, KV = split.local_heads(cfg.n_heads, cfg.n_kv_heads, "flash")
    hd = cfg.hd
    q = _heads(_proj(h, p, "wq"), H, hd)
    src = h if kv_override is None else kv_override
    k = _heads(_proj(src, p, "wk"), KV, hd)
    v = _heads(_proj(src, p, "wv"), KV, hd)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        if kv_override is None:
            k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    out = _proj(out.transpose(1, 2).reshape(B, S, H * hd), p, "wo")
    return (out, (k, v)) if return_kv else out


def _mlp(h, p, cfg):
    """The block's MLP: (output, aux) -- the MoE dispatch's statistics
    for an MoE layer, {} for a dense one.  Under a split, ``h`` enters
    through ``split.enter``."""
    h = split.enter(h, "mlp")
    if "router" in p:
        B, S, D = h.shape
        out, aux = moe_mlp(h.reshape(B * S, D), p["router"], p["w_gate"],
                           p.get("w_up", p["w_gate"]), p["w_down"],
                           top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           activation=cfg.activation, gated=cfg.gated_mlp)
        return out.reshape(B, S, D), aux
    g = apply_activation(_proj(h, p, "w_gate"), cfg.activation)
    if cfg.gated_mlp:
        g = g * _proj(h, p, "w_up")
    return _proj(g, p, "w_down"), {}


def _block(h, p, cos, sin, *, cfg, impl, window, return_kv=False):
    """One decoder block: (h, aux), or (h, aux, (k, v)) with
    ``return_kv``."""
    a = _attention(_norm(h, p, cfg, "attn_norm"), p, cfg, cos, sin,
                   impl=impl, window=window, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    h = h + a
    m, aux = _mlp(_norm(h, p, cfg, "mlp_norm"), p, cfg)
    return (h + m, aux, kv) if return_kv else (h + m, aux)


def _cross_block(h, p, cfg, vis, *, impl):
    """Gated cross-attention sub-block (llama-3.2-vision style): no RoPE,
    non-causal over the vision rows, ``tanh(gate)`` on the residual."""
    a = _attention(_norm(h, p, cfg, "attn_norm"), p, cfg, None, None,
                   impl=impl, causal=False, kv_override=vis)
    return h + torch.tanh(p["gate"]).to(h.dtype) * a


def forward(params, tokens, cfg: ArchConfig, *, vision_embeds=None,
            impl: str = "auto", return_cache: bool = False,
            cache_len: int | None = None, remat: bool = False,
            return_hidden: bool = False) -> dict:
    """tokens (B, S) -> {"logits": (B, S, V), "aux": {...}[, "cache"]},
    or with ``return_hidden`` {"logits": None, "hidden": the final-norm
    output (B, S, D), "aux": {...}}.  ``aux`` holds each MoE statistic
    averaged over the MoE layers ({} for a dense config).  ``remat``
    recomputes each block in the backward pass instead of keeping its
    activations, so the flash forward runs twice per layer per training
    step.  A vlm config needs ``vision_embeds`` (B, Tv, D).  Under a
    sharded step's split (``parallel/split.py``) the blocks' collectives
    run in layer order on every rank, and under ``remat`` each block's
    recompute in the backward pass re-issues its own in the same order on
    every rank (the backward visits the blocks in one order everywhere).

    ``return_cache`` adds the legacy decode cache: K/V (L, B, KV,
    cache_len, hd) in the KV dtype, zero-padded past S, or for a window
    shorter than S the ring of the last window rows (``ring_positions``,
    the Program prefill's rule); ``pos`` (B,) = S; for the vlm the cross
    K/V of every group (``_cross_kv``)."""
    per = cfg.cross_attn_every
    if per and vision_embeds is None:
        raise ValueError("vlm arch requires vision_embeds")
    B, S = tokens.shape
    rules = current_rules()

    def keep_rules():
        return contextlib.nullcontext(), activation_rules(rules)
    h = split.embed_rows(params["embed"], tokens).to(cfg.tdtype)
    cos, sin = Rotary(cfg.hd, cfg.rope_theta).freqs(
        torch.arange(S, device=tokens.device))
    block = functools.partial(_block, cfg=cfg, impl=impl,
                              window=cfg.attn_window, return_kv=return_cache)
    groups = {g: {k: v.unbind(0) for k, v in params[g].items()}
              for g in ("blocks", "moe_blocks", "cross_blocks")
              if g in params}
    auxs, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        if per and i % per == 0:
            cross_p = {k: v[i // per]
                       for k, v in groups["cross_blocks"].items()}
            h = _cross_block(h, cross_p, cfg, vision_embeds, impl=impl)
        grp, gi, is_moe = _block_path(cfg, i)
        p_i = {k: v[gi] for k, v in groups[grp].items()}
        if remat:
            # No forward draws random numbers, and jax.checkpoint keeps
            # no RNG state: not saving it keeps the step capturable.  The
            # recompute runs under this step's activation rules (autograd
            # may run it on a thread of its own, outside this context).
            out = checkpoint(block, h, p_i, cos, sin, use_reentrant=False,
                             preserve_rng_state=False,
                             context_fn=keep_rules)
        else:
            out = block(h, p_i, cos, sin)
        h, aux = out[:2]
        if return_cache:
            ks.append(split.kv_block(out[2][0]))
            vs.append(split.kv_block(out[2][1]))
        if is_moe:
            auxs.append(aux)
    h = _norm(h, params, cfg, "final_norm")
    out = {"logits": None,
           "aux": {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]} if auxs else {}}
    if return_hidden:
        out["hidden"] = h
    else:
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        out["logits"] = h @ head
    if return_cache:
        out["cache"] = _prefill_cache(params, cfg, torch.stack(ks),
                                      torch.stack(vs), cache_len,
                                      vision_embeds)
    return out


def _prefill_cache(params, cfg, k_stack, v_stack, cache_len,
                   vision_embeds) -> dict:
    """``forward``'s legacy cache from the (L, B, KV, S, hd) K/V stacks:
    padded to ``cache_len`` rows, or the ring of the last rows when a
    window keeps fewer than S."""
    B, S = k_stack.shape[1], k_stack.shape[3]
    CL = cache_len or S
    if cfg.attn_window:
        CL = min(CL, cfg.attn_window)
    if CL > S:                           # room to append during decode
        k_stack = torch.nn.functional.pad(k_stack, (0, 0, 0, CL - S))
        v_stack = torch.nn.functional.pad(v_stack, (0, 0, 0, CL - S))
    elif CL < S:                         # rolling window: keep last CL
        pos = ring_positions(S, CL, S, k_stack.device)
        k_stack = k_stack[:, :, :, pos]
        v_stack = v_stack[:, :, :, pos]
    cache = {"k": k_stack.to(cfg.kv_tdtype), "v": v_stack.to(cfg.kv_tdtype),
             "pos": torch.full((B,), S, dtype=torch.int32,
                               device=k_stack.device)}
    if cfg.cross_attn_every:
        cache["cross_k"], cache["cross_v"] = _cross_kv(params, cfg,
                                                       vision_embeds)
    return cache


def _cross_kv(params, cfg, vis):
    """Every cross block's K and V of the vision rows (decode): two (G,
    B, KV, Tv, hd) stacks, in the promoted type of ``vis`` and the
    weights."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    p = params["cross_blocks"]
    xk = [_heads(_mm(vis, w), KV, hd) for w in p["wk"].unbind(0)]
    xv = [_heads(_mm(vis, w), KV, hd) for w in p["wv"].unbind(0)]
    return torch.stack(xk), torch.stack(xv)


# --- compile-to-Program lowering --------------------------------------------------
class LoweringBlocked(NotImplementedError):
    """The config itself has no Program lowering, whatever the serving
    options; the engine falls back to the legacy decode loop on this
    refusal and on no other."""


def _require_dense(cfg: ArchConfig) -> None:
    """Gate what the *transformer-graph* lowering cannot express, with
    every blocker named (the serving engine reports the message as its
    ``fallback_reason``, and ``serve --program`` exits 2 with it).
    Dense and MoE decoder-only configs lower here; the hybrid, ssm and
    audio families lower through their own modules, so the remaining
    blockers are the vision-bridge features."""
    blockers = []
    if cfg.family not in ("dense", "moe"):
        blockers.append(f"family={cfg.family} (not a decoder-only "
                        f"transformer graph)")
    if cfg.cross_attn_every:
        blockers.append("gated cross-attention (vision bridge)")
    if cfg.n_vision_tokens:
        blockers.append("vision-encoder inputs")
    if cfg.n_encoder_layers:
        blockers.append("encoder-decoder")
    if cfg.shared_attn_every:
        blockers.append("shared attention blocks")
    if blockers:
        raise LoweringBlocked(
            f"Program lowering covers the decoder-only transformer "
            f"families (windowed attention and MoE included); "
            f"{cfg.name} is blocked by: {', '.join(blockers)} — it "
            f"still runs the scan forward")


def kv_cache_len(cfg: ArchConfig, max_len: int) -> int:
    """Per-slot KV rows the §5.1 region plan reserves: ``min(max_len,
    attn_window)`` for a sliding window (eviction is the rolling
    overwrite at ``pos % cache_len``), else ``max_len``."""
    if cfg.attn_window:
        return min(max_len, cfg.attn_window)
    return max_len


def _block_path(cfg: ArchConfig, i: int) -> tuple[str, int, bool]:
    """(param group, index within it, is_moe) of global layer ``i``:
    the interleaved layout ((moe_every - 1) dense layers, then one MoE
    layer, split across "blocks" / "moe_blocks") or every layer in
    "blocks" (an MoE layer each when the config has experts)."""
    if _interleaved(cfg):
        g, r = divmod(i, cfg.moe_every)
        if r == cfg.moe_every - 1:
            return "moe_blocks", g, True
        return "blocks", g * (cfg.moe_every - 1) + r, False
    return "blocks", i, cfg.n_experts > 0


def _build_lm_graph(cfg: ArchConfig, name: str, M: int, by: int,
                    add_attention) -> ModelGraph:
    """One block emitter for every dense-LM graph flavor (stateless,
    cache-writing prefill, per-token decode); they differ only in the
    token count M and the attention node ``add_attention(g, i, qkv)``
    adds, so the prefill and decode graphs of a pair cannot drift."""
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

    def norm_meta(param: str | None) -> dict:
        meta = {"norm": cfg.norm}
        if cfg.norm != "nonparametric" and param is not None:
            meta["param"] = param
            if cfg.norm == "layernorm":
                meta["param_b"] = (param + "_b" if ":" not in param else
                                   param.replace(":", "_b:", 1))
        return meta

    g = ModelGraph(name)
    g.add(embed_node("embed", M, cfg.vocab, D, dtype_bytes=by,
                     param="embed"))
    resid = "embed"
    for i in range(cfg.n_layers):
        grp, gi, is_moe = _block_path(cfg, i)

        def bp(k: str, grp=grp, gi=gi) -> str:   # stacked params
            return f"{grp}/{k}:{gi}"
        an = f"l{i}.attn_norm"
        g.add(norm_node(an, M * D, dtype_bytes=by, inputs=[resid],
                        **norm_meta(bp("attn_norm"))))
        g.add(matmul_node(f"l{i}.wq", M, D, H * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wq")))
        g.add(matmul_node(f"l{i}.wk", M, D, KV * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wk")))
        g.add(matmul_node(f"l{i}.wv", M, D, KV * hd, dtype_bytes=by,
                          inputs=[an], param=bp("wv")))
        add_attention(g, i, [f"l{i}.wq", f"l{i}.wk", f"l{i}.wv"])
        wo = f"l{i}.wo"
        g.add(matmul_node(wo, M, H * hd, D, dtype_bytes=by,
                          inputs=[f"l{i}.attn"], bypass_of=resid,
                          param=bp("wo")))
        mn = f"l{i}.mlp_norm"
        g.add(norm_node(mn, M * D, dtype_bytes=by, inputs=[wo],
                        **norm_meta(bp("mlp_norm"))))
        if is_moe:
            # One capacity-bucketed dispatch op for the MLP chain; it
            # takes the whole block's params ("blocks:3") and its
            # routing config rides the node into the op's op_cfg.
            g.add(moe_node(f"l{i}.moe", tokens=M, d_model=D, d_ff=F,
                           experts=cfg.n_experts, top_k=cfg.top_k,
                           dtype_bytes=by, inputs=[mn], bypass_of=wo,
                           param=f"{grp}:{gi}",
                           capacity_factor=cfg.capacity_factor,
                           activation=cfg.activation,
                           gated=cfg.gated_mlp))
            resid = f"l{i}.moe"
            continue
        g.add(matmul_node(f"l{i}.w_gate", M, D, F, dtype_bytes=by,
                          inputs=[mn], fused_activation=cfg.activation,
                          param=bp("w_gate")))
        if cfg.gated_mlp:
            g.add(matmul_node(f"l{i}.w_up", M, D, F, dtype_bytes=by,
                              inputs=[mn], param=bp("w_up")))
            g.add(elementwise_node(f"l{i}.glu_mul", "mul", M * F,
                                   dtype_bytes=by,
                                   inputs=[f"l{i}.w_gate", f"l{i}.w_up"]))
            down_in = f"l{i}.glu_mul"
        else:
            down_in = f"l{i}.w_gate"
        g.add(matmul_node(f"l{i}.w_down", M, F, D, dtype_bytes=by,
                          inputs=[down_in], bypass_of=wo,
                          param=bp("w_down")))
        resid = f"l{i}.w_down"
    g.add(norm_node("final_norm", M * D, dtype_bytes=by, inputs=[resid],
                    **norm_meta("final_norm")))
    g.add(matmul_node("lm_head", M, D, cfg.vocab, dtype_bytes=by,
                      inputs=["final_norm"],
                      param="embed" if cfg.tie_embeddings else "lm_head",
                      transpose_w=cfg.tie_embeddings))
    return g


def _paged_cache_meta(i: int, page_size: int, kv_quant: str | None) -> dict:
    """Attention-node meta for the paged region plan: the cache names
    resolve to the §5.1 page *pools*, the shared table and (for int8
    pools) the per-page scale regions ride along, and ``page_size``
    reaches the schedule so the decode kv block is pinned to the page."""
    meta = {"k_cache": f"l{i}.k_pages", "v_cache": f"l{i}.v_pages",
            "page_table": PAGE_TABLE_REGION, "page_size": page_size}
    if kv_quant == "int8":
        meta["k_scale"] = f"l{i}.k_scale"
        meta["v_scale"] = f"l{i}.v_scale"
    return meta


def to_graph(cfg: ArchConfig, batch: int = 1, seq: int = 64,
             dtype_bytes: int | None = None,
             write_cache: bool = False,
             page_size: int | None = None,
             kv_quant: str | None = None) -> ModelGraph:
    """Lower a dense config to the compiler IR (§5.1 steps 1-2):

        embed -> N x [attn_norm, wq|wk|wv, flash_attention, wo(+resid),
                      mlp_norm, w_gate|w_up, mul, w_down(+resid)]
              -> final_norm -> lm_head

    ``write_cache=True`` emits the *prefill* flavor: each attention node
    also names the persistent ``l{i}.k_cache`` / ``l{i}.v_cache``
    regions it writes the post-RoPE K and raw V into at the admitted
    slot.  ``page_size`` switches those names to the paged plan's page
    pools (plus the page table, and per-page scales when ``kv_quant=
    "int8"``)."""
    _require_dense(cfg)
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def add_attention(g, i, qkv):
        cache_meta = {}
        if write_cache:
            cache_meta = ({"k_cache": f"l{i}.k_cache",
                           "v_cache": f"l{i}.v_cache"} if page_size is None
                          else _paged_cache_meta(i, page_size, kv_quant))
        g.add(attention_node(
            f"l{i}.attn", seq_q=seq, seq_kv=seq, heads=H, kv_heads=KV,
            head_dim=hd, batch=batch, causal=True, dtype_bytes=by,
            inputs=qkv, window=cfg.attn_window, rope_theta=cfg.rope_theta,
            **cache_meta))

    return _build_lm_graph(cfg, cfg.name, batch * seq, by, add_attention)


def compile_program(cfg: ArchConfig, batch: int = 1, seq: int = 64,
                    hw: HardwareModel = TPU_V5E) -> Program:
    """graph -> schedule -> regions -> Program, memoized per (config,
    batch, seq, hw, tuned-cache generation).  Every tiling /
    attention-block / fusion decision in the Program comes from
    ``compile_model``, which consults the active tuned cache
    (``core/autotune.activate``) at this ``batch`` first."""
    from ..core import autotune
    return _compile_program(cfg, batch, seq, hw,
                            autotune.active_generation())


@functools.lru_cache(maxsize=64)
def _compile_program(cfg: ArchConfig, batch: int, seq: int,
                     hw: HardwareModel, generation: str) -> Program:
    from ..core import autotune
    tuned, cost_model = autotune.tuned_context(cfg.name, batch, hw)
    graph = to_graph(cfg, batch=batch, seq=seq)
    return lower_to_program(graph, compile_model(
        graph, hw, tuned=tuned, cost_model=cost_model))


def to_decode_graph(cfg: ArchConfig, slots: int = 8, max_len: int = 256,
                    dtype_bytes: int | None = None,
                    page_size: int | None = None,
                    kv_quant: str | None = None) -> ModelGraph:
    """Lower the per-token decode step: the same block structure as
    ``to_graph`` with one token per slot (M = slots) and the attention
    replaced by ``decode_attention`` against the persistent per-block
    KV-cache regions of ``kv_cache_len`` rows, or against the paged
    plan's pools when ``page_size`` is given."""
    _require_dense(cfg)
    by = dtype_bytes if dtype_bytes is not None else cfg.tdtype.itemsize
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cache_len = kv_cache_len(cfg, max_len)

    def add_attention(g, i, qkv):
        if page_size is None:
            cache_meta = {"k_cache": f"l{i}.k_cache",
                          "v_cache": f"l{i}.v_cache"}
        else:
            cache_meta = _paged_cache_meta(i, page_size, kv_quant)
        g.add(decode_attention_node(
            f"l{i}.attn", cache_len=cache_len, heads=H, kv_heads=KV,
            head_dim=hd, slots=slots, dtype_bytes=by, inputs=qkv,
            window=cfg.attn_window, rope_theta=cfg.rope_theta,
            **cache_meta))

    return _build_lm_graph(cfg, cfg.name + ".decode", slots, by,
                           add_attention)


def _kv_cache_specs(cfg: ArchConfig, slots: int,
                    max_len: int) -> tuple[PersistentSpec, ...]:
    """One persistent (slots, kv_cache_len, kv_heads, head_dim) region
    per block and cache side, in the KV dtype."""
    dt = cfg.kv_tdtype
    shape = (slots, kv_cache_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    name = str(dt).removeprefix("torch.")
    size = math.prod(shape) * dt.itemsize
    specs = []
    for i in range(cfg.n_layers):
        specs.append(PersistentSpec(f"l{i}.k_cache", shape, name, size))
        specs.append(PersistentSpec(f"l{i}.v_cache", shape, name, size))
    return tuple(specs)


register_state_family(
    "dense", lambda cfg, slots, max_len: (
        _kv_cache_specs(cfg, slots, max_len),
        StateCaps(paged=True, windowed=True, chunkable=True,
                  speculatable=True)))
# MoE state is the dense KV, but a chunk boundary would re-bucket the
# routing (capacity is a whole-sequence decision) and a speculative
# rollback re-routes the rolled-back tokens: neither is allowed.
register_state_family(
    "moe", lambda cfg, slots, max_len: (
        _kv_cache_specs(cfg, slots, max_len),
        StateCaps(paged=True, windowed=True, chunkable=False,
                  speculatable=False)))


def compile_program_pair(cfg: ArchConfig, slots: int = 8,
                         max_len: int = 256, hw: HardwareModel = TPU_V5E, *,
                         paged: bool = False, page_size: int = 16,
                         page_pool: int | None = None,
                         kv_quant: str | None = None) -> ProgramPair:
    """Compile the stateful serving pair: a batch-1 prefill Program
    (full causal forward + cache writes at the admitted slot) and a
    decode Program (one token per slot against the cache), sharing one
    persistent region table so one runtime ``ProgramState`` addresses
    both.  Memoized per (config, slots, max_len, hw, tuned-cache
    generation, paged plan); with a tuned cache active
    (``core/autotune.activate``), prefill entries are looked up at
    ``batch=1`` and decode entries at ``batch=slots`` (as
    ``core/autotune.tune_lm_decode`` stores them).  A windowed config
    gets regions of ``min(max_len, attn_window)`` rows; the plans differ
    only in region shape, never in instruction structure.

    ``paged=True`` selects the §5.1 paged plan: page pools and a page
    table (``regions.paged_kv_specs``) instead of contiguous rows --
    ``page_pool`` caps the pool (default: the worst case) and
    ``kv_quant="int8"`` stores quantized pages with per-page scales.
    Paged and a sliding window are mutually exclusive (the window plan
    already bounds the resident rows).

    Family dispatch: ``ssm`` (rwkv6) lowers through models/rwkv.py,
    ``hybrid`` (zamba2, mamba2) through models/zamba2.py, whose coarse
    recurrent ops carry their state in the family's named regions, and
    ``audio`` (whisper) through models/whisper.py, whose cross ops read
    the read-only encoder memory written at admission; that state is
    not pageable (``paged`` raises) and not chunkable
    (``ProgramPair.chunk_blocker``)."""
    if paged and cfg.attn_window:
        raise NotImplementedError(
            f"paged KV and attn_window are mutually exclusive "
            f"({cfg.name} has window={cfg.attn_window}); the window "
            f"plan already bounds resident rows")
    from ..core import autotune
    return _compile_program_pair(cfg, slots, max_len, hw,
                                 autotune.active_generation(), paged,
                                 page_size, page_pool, kv_quant)


@functools.lru_cache(maxsize=32)
def _compile_program_pair(cfg: ArchConfig, slots: int, max_len: int,
                          hw: HardwareModel, generation: str,
                          paged: bool = False, page_size: int = 16,
                          page_pool: int | None = None,
                          kv_quant: str | None = None) -> ProgramPair:
    from ..core import autotune
    if cfg.family == "ssm":
        from . import rwkv as gmod
    elif cfg.family == "hybrid":
        from . import zamba2 as gmod
    elif cfg.family == "audio":
        from . import whisper as gmod
    else:
        gmod = None
        _require_dense(cfg)
    specs, caps = state_specs(cfg, slots, max_len)
    if paged and not caps.paged:
        raise NotImplementedError(
            f"{cfg.name} is blocked by: family {cfg.family!r} state is not "
            f"pageable (paged plans assume KV-row granularity)")
    pg = page_size if paged else None
    quant = kv_quant if paged else None
    if gmod is None:
        pre_graph = to_graph(cfg, batch=1, seq=max_len, write_cache=True,
                             page_size=pg, kv_quant=quant)
        dec_graph = to_decode_graph(cfg, slots=slots, max_len=max_len,
                                    page_size=pg, kv_quant=quant)
    else:
        pre_graph = gmod.to_graph(cfg, seq=max_len, write_cache=True)
        dec_graph = gmod.to_decode_graph(cfg, slots=slots, max_len=max_len)
    pre_graph.name = cfg.name + ".prefill"
    pre_tuned, cost_model = autotune.tuned_context(cfg.name, 1, hw)
    dec_tuned, _ = autotune.tuned_context(cfg.name, slots, hw)
    pre_sched = compile_model(pre_graph, hw, tuned=pre_tuned,
                              cost_model=cost_model)
    dec_sched = compile_model(dec_graph, hw, tuned=dec_tuned,
                              cost_model=cost_model)
    pre_plan = allocate_regions(pre_graph, pre_sched)
    dec_plan = allocate_regions(dec_graph, dec_sched)
    # One persistent table, one base: the state region ids coincide
    # across the pair, so prefill-written buffers are read by decode ops
    # under the same ids.
    base = max(len(pre_plan.regions), len(dec_plan.regions))
    paged_plan = None
    if paged:
        specs, paged_plan = paged_kv_specs(
            n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            slots=slots, max_len=max_len, page_size=page_size,
            n_pages=page_pool,
            kv_dtype=("int8" if kv_quant == "int8"
                      else str(cfg.kv_tdtype).removeprefix("torch.")))
    pre_plan = extend_with_persistent(pre_plan, specs, base)
    dec_plan = extend_with_persistent(dec_plan, specs, base)
    return ProgramPair(
        prefill=lower_to_program(pre_graph, pre_sched, pre_plan),
        decode=lower_to_program(dec_graph, dec_sched, dec_plan),
        slots=slots, max_len=max_len, paged=paged_plan, caps=caps)


def compile_draft_pair(target_cfg: ArchConfig, draft_cfg: ArchConfig,
                       slots: int = 8, max_len: int = 256,
                       hw: HardwareModel = TPU_V5E) -> ProgramPair:
    """Compile the speculative-decode *draft* (prefill, decode) pair --
    ``compile_program_pair`` verbatim on the draft config, the target's
    (slots, max_len) geometry -- after checking the draft can propose
    for ``target_cfg``.

    The draft proposes token ids the target verifies, so the
    vocabularies must be identical.  Sliding windows are refused on
    either side: rollback truncates each slot's length, which is only
    sound while every cache row below the truncated length is still
    resident, and a ring that wrapped during the burst has overwritten
    rows the truncation re-exposes.  The target must be dense (its state
    caps: rollback of recurrent or capacity-routed state is not a length
    truncation).  A self-draft (``draft_cfg == target_cfg``) gets the
    target's own memoized pair; its ``ProgramState`` is the engine's
    second one."""
    if draft_cfg.vocab != target_cfg.vocab:
        raise ValueError(
            f"draft/target vocab mismatch ({draft_cfg.vocab} vs "
            f"{target_cfg.vocab}): speculative decode exchanges token "
            f"ids, the vocabularies must be identical")
    if target_cfg.attn_window or draft_cfg.attn_window:
        raise NotImplementedError(
            "speculative decode over windowed attention: rollback "
            "truncates lengths, but a wrapped ring has already "
            "overwritten the rows the truncation re-exposes")
    if target_cfg.family != "dense":
        raise NotImplementedError(
            f"speculative decode requires a speculatable target "
            f"(family state caps): {target_cfg.name} is "
            f"family={target_cfg.family}, whose state rollback is not "
            f"length-truncation")
    _require_dense(draft_cfg)
    return compile_program_pair(draft_cfg, slots=slots, max_len=max_len,
                                hw=hw)


def program_forward(params, tokens, cfg: ArchConfig, *, impl: str = "auto",
                    hw: HardwareModel = TPU_V5E):
    """tokens (B, S) -> logits (B, S, V) through the compiled Program;
    the kernels run where ``tokens`` lie (on the card, a replayed CUDA
    graph: ``graphed_runner``)."""
    program = compile_program(cfg, batch=tokens.shape[0],
                              seq=tokens.shape[1], hw=hw)
    return graphed_runner(program, impl=impl)(params, tokens)


# --- legacy decode ----------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed legacy cache: K/V (L, batch, KV, kv_cache_len, hd) in the
    KV dtype, ``pos`` (batch,) int32 and, for the vlm, the cross K/V
    (G, batch, KV, Tv, hd)."""
    KV, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    dt = cfg.kv_tdtype
    shape = (L, batch, KV, kv_cache_len(cfg, max_len), hd)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device),
             "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.cross_attn_every:
        G = cfg.n_layers // cfg.cross_attn_every
        xshape = (G, batch, KV, cfg.n_vision_tokens, hd)
        cache["cross_k"] = torch.zeros(xshape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(xshape, dtype=dt, device=device)
    return cache


def _write_cache(cache_k, cache_v, k_new, v_new, slot):
    """Insert (B, KV, hd) at each sequence's row ``slot`` (B,) of (B,
    KV, S, hd); new tensors, the inputs are left as they were."""
    idx = slot.long()[:, None, None, None].expand(-1, k_new.shape[1], 1,
                                                  k_new.shape[2])
    return (cache_k.scatter(2, idx, k_new[:, :, None]),
            cache_v.scatter(2, idx, v_new[:, :, None]))


def _attention_decode(h1, p, cfg, ck, cv, pos, cos, sin, *, impl):
    """h1 (B, D); ck/cv (B, KV, S, hd); pos (B,).  The new row lands at
    ``pos % S`` (the rolling window cache), then one decode-attention
    launch over the ring's live rows."""
    B, _ = h1.shape
    H, KV = split.local_heads(cfg.n_heads, cfg.n_kv_heads, "decode")
    hd = cfg.hd
    S = ck.shape[2]
    q = _proj(h1, p, "wq").reshape(B, H, hd)
    k = _proj(h1, p, "wk").reshape(B, KV, hd)
    v = _proj(h1, p, "wv").reshape(B, KV, hd)
    if cos is not None:
        q = apply_rope(q, cos[:, None], sin[:, None])
        k = apply_rope(k, cos[:, None], sin[:, None])
    k, v = k.to(ck.dtype), v.to(cv.dtype)
    vk, vv = _write_cache(split.kv_view(ck), split.kv_view(cv), k, v,
                          pos % S)
    out = decode_attention(q, vk, vv, kv_len=ring_kv_len(pos, S), impl=impl)
    return (_proj(out.reshape(B, H * hd), p, "wo"),
            split.kv_store(ck, vk, k, pos % S),
            split.kv_store(cv, vv, v, pos % S))


def decode_step(params, cache, tokens, cfg: ArchConfig, *,
                impl: str = "auto"):
    """tokens (B,) -> (logits (B, V), new cache); ``pos`` advances by
    one.  Every layer's self-attention is one decode-attention launch
    over its ring; a vlm group first attends its cross K/V (all Tv rows,
    one more launch) through its gate.  The cache passed in is left as
    it was (the reference's functional step)."""
    B = tokens.shape[0]
    pos = cache["pos"]
    h = split.embed_rows(params["embed"], tokens).to(cfg.tdtype)
    cos, sin = Rotary(cfg.hd, cfg.rope_theta).freqs(pos)   # (B, hd/2)
    groups = {g: {k: v.unbind(0) for k, v in params[g].items()}
              for g in ("blocks", "moe_blocks", "cross_blocks")
              if g in params}
    per = cfg.cross_attn_every
    H, hd = cfg.n_heads, cfg.hd
    ks, vs = [], []
    for i in range(cfg.n_layers):
        if per and i % per == 0:
            g = i // per
            cross_p = {k: v[g] for k, v in groups["cross_blocks"].items()}
            q = (_norm(h, cross_p, cfg, "attn_norm") @ cross_p["wq"]
                 ).reshape(B, H, hd)
            a = decode_attention(q, cache["cross_k"][g], cache["cross_v"][g],
                                 impl=impl)
            a = a.reshape(B, H * hd) @ cross_p["wo"]
            h = h + torch.tanh(cross_p["gate"]).to(h.dtype) * a
        grp, gi, _ = _block_path(cfg, i)
        p_i = {k: v[gi] for k, v in groups[grp].items()}
        a, ck, cv = _attention_decode(_norm(h, p_i, cfg, "attn_norm"), p_i,
                                      cfg, cache["k"][i], cache["v"][i], pos,
                                      cos, sin, impl=impl)
        h = h + a
        m, _ = _mlp(_norm(h, p_i, cfg, "mlp_norm")[:, None], p_i, cfg)
        h = h + m[:, 0]
        ks.append(ck)
        vs.append(cv)
    h = _norm(h, params, cfg, "final_norm")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    new_cache = dict(cache)
    new_cache.update({"k": torch.stack(ks), "v": torch.stack(vs),
                      "pos": pos + 1})
    return h @ head, new_cache
