"""Sharding-rule presets + the distributed Mloop/Kloop chooser.

Strategies per weight class (the ICI-level face of the paper's
loop-rearrangement decision, DESIGN.md T3):

* ``tp``    — activation-gathered (Megatron): weights sharded over
  "model"; activations all-gathered / partial sums reduce-scattered.
* ``fsdp``  — weight-gathered over the FLAT device axis (data x model
  [x pod]): batch is sharded over every axis, weights are ZeRO-3
  sharded over the same flat axis and all-gathered per layer.
* ``auto``  — two candidate layouts costed in bytes-moved per chip and
  the cheaper one chosen, exactly the paper's Mloop/Kloop logic lifted
  to ICI:
    layout A ("flat_dp"): pure weight-gathered; every axis carries
      batch.  ICI cost = 3 x frac x total weight bytes (fwd AG, bwd AG,
      grad RS).
    layout B ("mixed"): batch over data [x pod] only; per weight class
      the cheaper of weight-gathered-over-data / activation-gathered-
      over-model (choose_dist_strategy).
  Decode/prefill always use layout B (weights must stay sharded over
  "model"; batch is too small to cover the flat axis).

Counterpart of ``repro/parallel/rules.py``, decision for decision.
The cost model defaults to ``hw=TPU_V5E``, so a plan here equals the
reference's; a plan costed for NVLink waits for an H100 hardware model
(ROADMAP A.11 b).  The port's sharded steps (``launch/steps.py``) store
every leaf under the plan's specs.  The dense family's train, prefill
and decode steps split the activation-gathered classes over "model"
(``parallel/split.py``); the other families run each weight class
weight-gathered, duplicated along "model", and the sequence-parallel
prefill runs its classes as on one device (ROADMAP A.12 c).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..configs.base import ArchConfig, ShapeSpec
from ..core.dataflow import DistStrategy, choose_dist_strategy
from ..core.hw import TPU_V5E, HardwareModel, MeshDescriptor
from .act_sharding import ActivationRules, P

__all__ = ["ShardingPlan", "make_plan", "STRATEGIES"]

STRATEGIES = ("tp", "fsdp", "auto")

# Megatron-style: one "model" axis + FSDP over "data" on the other dim.
TP_RULES = {
    "vocab": "model", "embed": "data", "heads": "model",
    "kv_heads": "model", "ff": "model", "experts": "model",
    "layers": None,
}


def _flat_axes(mesh: MeshDescriptor) -> tuple:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.axes)


def _fsdp_rules(mesh: MeshDescriptor) -> dict:
    flat = _flat_axes(mesh)
    return {k: flat for k in ("vocab", "embed", "heads", "kv_heads",
                              "ff", "experts")} | {"layers": None}


@dataclass
class ShardingPlan:
    strategy: str
    rules: dict                       # default logical->mesh rules
    overrides: dict = field(default_factory=dict)  # path-suffix -> rules
    act_specs: dict = field(default_factory=dict)
    batch_spec: P = P()
    decisions: dict = field(default_factory=dict)  # class -> chosen strategy

    def activation_rules(self, mesh=None) -> ActivationRules:
        return ActivationRules(self.act_specs, mesh)


def _dp(mesh: MeshDescriptor):
    if "pod" in mesh.axes:
        return ("pod", "data")
    return ("data",)


def _act_specs(mesh: MeshDescriptor, *, dp, tp_acts: bool) -> dict:
    return {
        "hidden": P(dp, None, None),
        "logits": P(dp, None, "model" if tp_acts else None),
        "attn_q": P(dp, "model" if tp_acts else None, None, None),
        # dispatch buffers shard on D/F so data-dependent scatter/gather
        # partition cleanly (§Perf H3)
        "moe_buf": P(None, None, "model"),
        "moe_h": P(None, None, "model"),
    }


def _weight_classes(cfg: ArchConfig) -> dict:
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
        "wo": (H * hd, D),
        "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
        "embed": (V, D), "lm_head": (D, V),
    }


def make_plan(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshDescriptor,
              strategy: str = "auto",
              hw: HardwareModel = TPU_V5E) -> ShardingPlan:
    dp = _dp(mesh)
    flat = _flat_axes(mesh)
    if strategy == "tp":
        return ShardingPlan("tp", TP_RULES, {},
                            _act_specs(mesh, dp=dp, tp_acts=True),
                            P(dp, None))
    if strategy == "fsdp":
        return ShardingPlan("fsdp", _fsdp_rules(mesh), {},
                            _act_specs(mesh, dp=flat, tp_acts=False),
                            P(flat, None))

    assert strategy == "auto", strategy
    classes = _weight_classes(cfg)
    n_layers = cfg.n_layers
    total_tokens = (shape.seq_len * shape.global_batch
                    if shape.kind != "decode" else shape.global_batch)

    # Sequence-parallel layout for prefill when TP would have to shard a
    # head count the model axis does not divide (e.g. smollm's 15 heads
    # on 16): GSPMD's padded-head resharding degenerates into
    # "last-resort replication" per layer (§Perf H2).  Sharding the
    # sequence instead keeps every chip busy on position-wise work and
    # only gathers the (tiny, GQA) per-layer K/V for attention.
    if (shape.kind == "prefill" and mesh.model > 1
            and (cfg.n_heads % mesh.model or cfg.n_kv_heads % mesh.model)
            and cfg.family in ("dense", "moe", "vlm")
            and shape.seq_len % mesh.model == 0):
        act = {
            "hidden": P(dp, "model", None),
            "logits": P(dp, "model", None),
            "attn_q": P(dp, None, None, None),
            "attn_kv": P(dp, None, None, None),  # replicate small GQA KV
            "moe_buf": P(None, None, "model"),
            "moe_h": P(None, None, "model"),
        }
        rules = {k: "data" for k in ("vocab", "embed", "heads",
                                     "kv_heads", "ff", "experts")}
        rules["layers"] = None
        return ShardingPlan("auto", rules, {}, act, P(dp, None),
                            {"layout": "sequence_parallel"})

    # --- layout B: mixed TP/FSDP, batch over data [x pod] ---------------------
    tokens_local_b = max(total_tokens // max(mesh.data, 1), 1)
    decisions = {}
    overrides = {}
    cost_b = 0.0
    n_act_gathered = 0
    train_mult_wg = 3.0 if shape.kind == "train" else 1.0
    train_mult_ag = 2.0 if shape.kind == "train" else 1.0
    g_model = mesh.model
    frac_m = (g_model - 1) / g_model if g_model > 1 else 0.0
    for name, (Kd, Nd) in classes.items():
        per_layer = (n_layers if name not in ("embed", "lm_head") else 1)
        dec = choose_dist_strategy(tokens_local_b, Kd, Nd, 2, mesh, hw)
        decisions[name] = dec.strategy.value
        if dec.strategy is DistStrategy.ACTIVATION_GATHERED:
            overrides[name] = TP_RULES
            n_act_gathered += 1
            cost_b += train_mult_ag * dec.ici_bytes_per_chip * per_layer
        else:
            overrides[name] = {k: "data" for k in
                               ("vocab", "embed", "heads", "kv_heads",
                                "ff", "experts")} | {"layers": None}
            cost_b += train_mult_wg * dec.ici_bytes_per_chip * per_layer

    # --- layout A: flat DP + full ZeRO-3 (train only) --------------------------
    n_flat = mesh.n_chips
    frac_f = (n_flat - 1) / n_flat
    w_total = sum(Kd * Nd * 2 * (n_layers if n not in ("embed", "lm_head")
                                 else 1)
                  for n, (Kd, Nd) in classes.items())
    cost_a = 3.0 * frac_f * w_total
    feasible_a = (shape.kind == "train" and not cfg.n_experts
                  and shape.global_batch % n_flat == 0)

    # Step-time objective: bytes alone cannot see an idle mesh axis.
    # Compute parallelism: layout A uses every chip; layout B uses the
    # model axis only for activation-gathered (TP) classes.
    link_bw = hw.ici_bandwidth * max(hw.ici_links_per_axis, 1)
    model_flops = 6.0 * cfg.n_active_params() * total_tokens \
        if shape.kind == "train" else 2.0 * cfg.n_active_params() * total_tokens
    ffn_tp = any(decisions.get(c) == "activation_gathered"
                 for c in ("w_gate", "w_up", "w_down", "wq"))
    chips_b = mesh.data * (mesh.model if ffn_tp else 1)
    t_b = max(model_flops / (chips_b * hw.peak_flops), cost_b / link_bw)
    t_a = max(model_flops / (n_flat * hw.peak_flops), cost_a / link_bw) \
        if feasible_a else float("inf")

    if t_a < t_b:
        return ShardingPlan(
            "auto", _fsdp_rules(mesh), {},
            _act_specs(mesh, dp=flat, tp_acts=False), P(flat, None),
            {"layout": "flat_dp", "ici_bytes_per_chip": cost_a,
             "alternative_ici": cost_b, "t_a": t_a, "t_b": t_b})

    # Degenerate layout B (no class uses the model axis): force the big
    # classes to TP so compute parallelism covers the whole mesh.
    if not ffn_tp and mesh.model > 1:
        for c in ("w_gate", "w_up", "w_down", "wq", "wk", "wv", "wo"):
            overrides[c] = TP_RULES
            decisions[c] = "activation_gathered(forced: idle model axis)"
        n_act_gathered = len(classes)

    # MoE experts: shard the expert matmuls on their contraction dims
    # ("embed"/"ff" over model) to pair with the D-sharded dispatch
    # buffers; experts-dim sharding forced scatter replication (§Perf H3).
    if cfg.n_experts:
        MOE_W_RULES = {"experts": None, "embed": "model", "ff": "model",
                       "vocab": None, "heads": None, "kv_heads": None,
                       "layers": None}
        overrides["router"] = {k: "data" for k in TP_RULES} | {"layers": None}
        for w in ("w_gate", "w_up", "w_down"):
            overrides[f"moe_blocks/{w}"] = MOE_W_RULES
        decisions["experts"] = "expert_tp_on_d"
        if cfg.moe_every == 1:
            for w in ("w_gate", "w_up", "w_down"):
                overrides[w] = MOE_W_RULES
    # Vocab-TP head when divisible: zero extra comm (activations are
    # model-replicated there) and 1/model-size per-chunk logits.
    if cfg.vocab % mesh.model == 0:
        overrides["embed"] = TP_RULES
        overrides["lm_head"] = TP_RULES
        decisions["embed"] = decisions["lm_head"] = "vocab_tp"
    tp_acts = n_act_gathered >= len(classes) // 2
    decisions["layout"] = "mixed"
    decisions["ici_bytes_per_chip"] = cost_b
    base_rules = {k: "data" for k in ("vocab", "embed", "heads",
                                      "kv_heads", "ff", "experts")}
    base_rules["layers"] = None
    return ShardingPlan("auto", base_rules, overrides,
                        _act_specs(mesh, dp=dp, tp_acts=tp_acts),
                        P(dp, None), decisions)
