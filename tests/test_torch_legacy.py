"""The port's legacy decode path against ``repro``'s, on the same numpy
weights and tokens: every family's ``forward(return_cache=True,
cache_len=)`` followed by ``decode_step``s (dense, windowed dense with a
prompt past the window, MoE, interleaved MoE, the vlm with nonzero cross
gates, zamba2 with and without a prompt past its window, mamba2, rwkv6,
whisper), logits and every cache leaf; ``init_cache`` shapes and dtypes;
f32 vision embeddings under bf16 weights; the serving engine's legacy
loop (``use_program=False``) and the vlm's fallback onto it, streams
against ``repro``'s engine.  f32 smoke configs on the CPU, both sides
``impl="reference"``: the same math in another order, held to 1e-5."""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.obs.flight import FlightRecorder  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402

TOL = 1e-5
VLM = "llama-3.2-vision-11b"
# Nonzero cross gates, the same on both sides: with the zeros of the
# init, tanh(0) = 0 and the cross path would reach nothing.
GATES = (0.8, -0.6)

# case -> (arch, config overrides, prompt length S, cache_len)
CASES = {
    "dense": ("smollm-360m", {}, 12, 24),
    "window": ("smollm-360m", {"attn_window": 8}, 12, 24),
    "moe": ("granite-moe-1b-a400m", {}, 12, 24),
    "interleaved-moe": ("llama4-maverick-400b-a17b", {}, 12, 24),
    "vlm": (VLM, {}, 12, 24),
    "zamba2-past-window": ("zamba2-7b", {}, 72, 96),
    "zamba2": ("zamba2-7b", {}, 16, 24),
    "mamba2": ("mamba2", {}, 16, 24),
    "rwkv6": ("rwkv6-7b", {}, 12, 24),
    "whisper": ("whisper-base", {}, 12, 24),
}


def _cfgs(arch, **over):
    cfg, jcfg = REGISTRY[arch].smoke(), JAX_REGISTRY[arch].smoke()
    if over:
        cfg = dataclasses.replace(cfg, **over)
        jcfg = dataclasses.replace(jcfg, **over)
    return cfg, jcfg


def _tree(jcfg, seed, dtype=np.float32):
    """One numpy parameter tree for both packages, the vlm's gates set
    to ``GATES``."""
    tree = numpy_params(jax_get_model(jcfg).param_defs(jcfg), seed)
    if "cross_blocks" in tree:
        tree["cross_blocks"]["gate"] = np.asarray(GATES, np.float32)
    return jax.tree.map(lambda a: a.astype(dtype), tree)


def _extra(cfg, rng, batch, dtype=np.float32):
    """The family's extra forward input, as (port kwargs, jax kwargs)."""
    if cfg.family == "vlm":
        name, rows = "vision_embeds", cfg.n_vision_tokens
    elif cfg.family == "audio":
        name, rows = "encoder_frames", cfg.encoder_seq
    else:
        return {}, {}
    x = rng.standard_normal((batch, rows, cfg.d_model)).astype(dtype)
    return {name: torch.from_numpy(x)}, {name: jnp.asarray(x)}


def _close(ours, ref, what, tol=TOL):
    ref = np.asarray(ref)
    assert tuple(ours.shape) == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_allclose(ours.float().numpy(), ref.astype(np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _close_cache(ours, ref, what):
    assert sorted(ours) == sorted(ref), what
    for k in ref:
        if k == "pos":
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
        elif ref[k].size:
            _close(ours[k], ref[k], f"{what} {k}")


def _run(arch, over, S, cache_len, tree=None, seed=3):
    cfg, jcfg = _cfgs(arch, **over)
    tree = _tree(jcfg, seed) if tree is None else tree
    params, jparams = params_from_numpy(tree), _jax_tree(tree)
    api, japi = get_model(cfg), jax_get_model(jcfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    kw, jkw = _extra(cfg, rng, 2)
    out = api.forward(params, torch.from_numpy(toks), cfg, impl="reference",
                      return_cache=True, cache_len=cache_len, **kw)
    jout = japi.forward(jparams, jnp.asarray(toks), jcfg, impl="reference",
                        return_cache=True, cache_len=cache_len, **jkw)
    return cfg, jcfg, api, japi, params, jparams, rng, out, jout


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_cache_and_decode_steps_match_reference(case):
    """``forward(return_cache=True, cache_len=)`` then four
    ``decode_step``s: logits and every cache leaf.  Each step leaves the
    cache it was given as it was (the reference's functional step)."""
    arch, over, S, cache_len = CASES[case]
    cfg, jcfg, api, japi, params, jparams, rng, out, jout = _run(
        arch, over, S, cache_len)
    _close(out["logits"], jout["logits"], "prefill logits")
    _close_cache(out["cache"], jout["cache"], "prefill cache")
    cache, jcache = out["cache"], jout["cache"]
    for t in range(4):
        toks = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        before = {k: v.clone() for k, v in cache.items()}
        logits, new = api.decode_step(params, cache, torch.from_numpy(toks),
                                      cfg, impl="reference")
        jlogits, jcache = japi.decode_step(jparams, jcache, jnp.asarray(toks),
                                           jcfg, impl="reference")
        _close(logits, jlogits, f"step {t} logits")
        _close_cache(new, jcache, f"step {t} cache")
        for k, v in cache.items():
            assert torch.equal(v, before[k]), (t, k)
        cache = new


def test_vlm_cross_path_reaches_the_logits():
    """The gates of ``GATES`` against zeros: the cross blocks move the
    forward's and a decode step's logits."""
    arch, over, S, cache_len = CASES["vlm"]
    _, jcfg = _cfgs(arch)
    tree = _tree(jcfg, 3)
    cfg, _, api, _, params, _, _, out, _ = _run(arch, over, S, cache_len,
                                                tree)
    tree["cross_blocks"]["gate"] = np.zeros(2, np.float32)
    *_, shut, _ = _run(arch, over, S, cache_len, tree)
    assert (out["logits"] - shut["logits"]).abs().max() > 1e-2
    toks = torch.tensor([1, 2])
    a = api.decode_step(params, out["cache"], toks, cfg, impl="reference")[0]
    b = api.decode_step(params_from_numpy(tree), shut["cache"], toks, cfg,
                        impl="reference")[0]
    assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  VLM, "zamba2-7b", "rwkv6-7b",
                                  "whisper-base"])
def test_init_cache_shapes_and_dtypes_match_reference(arch):
    """bf16 configs: every leaf's shape and dtype, a window's ring
    length included."""
    over = {"dtype": "bfloat16"}
    if arch == "smollm-360m":
        over["attn_window"] = 8
    cfg, jcfg = _cfgs(arch, **over)
    ours = get_model(cfg).init_cache(cfg, 3, 20)
    ref = jax_get_model(jcfg).init_cache(jcfg, 3, 20)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        assert (str(ours[k].dtype).removeprefix("torch.")
                == jnp.dtype(ref[k].dtype).name), k
        assert not ours[k].any(), k


def test_vlm_f32_vision_embeds_under_bf16_weights():
    """The reference promotes f32 vision rows under bf16 weights to f32
    K/V (``jnp`` promotion); the port promotes alike: the cross cache in
    f32, equal within f32 rounding, and the logits within bf16
    rounding (2^-7 of their scale) through the decode steps."""
    cfg, jcfg = _cfgs(VLM, dtype="bfloat16")
    tree = _tree(jcfg, 3, ml_dtypes.bfloat16)
    params, jparams = params_from_numpy(tree), _jax_tree(tree)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    kw, jkw = _extra(cfg, rng, 2)
    out = get_model(cfg).forward(params, torch.from_numpy(toks), cfg,
                                 impl="reference", return_cache=True,
                                 cache_len=16, **kw)
    jout = jax_get_model(jcfg).forward(jparams, jnp.asarray(toks), jcfg,
                                       impl="reference", return_cache=True,
                                       cache_len=16, **jkw)
    for k in ("cross_k", "cross_v"):
        assert jout["cache"][k].dtype == jnp.float32
        assert out["cache"][k].dtype == torch.float32
        _close(out["cache"][k], jout["cache"][k], k)
    assert out["cache"]["k"].dtype == torch.bfloat16
    assert out["logits"].dtype == torch.bfloat16
    bound = 2.0 ** -7 * float(np.abs(np.asarray(jout["logits"],
                                                np.float32)).max())
    _close(out["logits"], jout["logits"], "logits", tol=bound)
    logits, _ = get_model(cfg).decode_step(
        params, out["cache"], torch.from_numpy(toks[:, 0]), cfg,
        impl="reference")
    jlogits, _ = jax_get_model(jcfg).decode_step(
        jparams, jout["cache"], jnp.asarray(toks[:, 0]), jcfg,
        impl="reference")
    _close(logits, jlogits, "decode logits", tol=bound)


def _streams(arch, prompts, max_new, *, ours_kw, ref_kw, slots=2,
             max_len=16, obs=None):
    cfg, jcfg = _cfgs(arch)
    tree = _tree(jcfg, 5)
    ours = ServingEngine(cfg, params_from_numpy(tree), slots=slots,
                         max_len=max_len, device="cpu", obs=obs, **ours_kw)
    ref = JaxEngine(jcfg, _jax_tree(tree), slots=slots, max_len=max_len,
                    impl="reference", **ref_kw)
    for i, p in enumerate(prompts):
        assert ours.submit(Request(uid=i, prompt=p,
                                   max_new_tokens=max_new)).accepted
        ref.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=max_new))
    got = sorted(ours.run_until_drained(), key=lambda r: r.uid)
    want = sorted(ref.run_until_drained(), key=lambda r: r.uid)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == max_new for r in got)
    assert not ours.live and not ours.queue
    return ours, ref


def test_legacy_engine_streams_match_reference_engine():
    """``use_program=False`` on dense smoke: more requests than slots,
    mixed prompt lengths (one longer than max_len, whose ring wraps
    during admission), the same greedy streams as ``repro``'s legacy
    loop."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (3, 20, 7, 1, 12)]
    ours, ref = _streams("smollm-360m", prompts, 9,
                         ours_kw={"use_program": False}, ref_kw={})
    assert not ours.on_program_path and not ref.on_program_path
    assert ours.fallback_reason is None and ours.program is None
    assert ours.capture_seconds == 0.0


def test_vlm_engine_falls_back_like_the_reference():
    """The vlm smoke engine with the default ``use_program=True``: one
    ``RuntimeWarning`` at construction, the reference's
    ``fallback_reason``, ``on_program_path`` False, the ``fallback``
    flight event and the labeled gauge, and streams equal to the
    reference engine's fallback loop (whose cross memory stays zero);
    chunked prefill and speculation refused."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (4, 9, 2)]
    obs = Observability(flight=FlightRecorder())
    with pytest.warns(RuntimeWarning, match="legacy decode loop") as rec:
        ours, ref = _streams(VLM, prompts, 6, ours_kw={},
                             ref_kw={"use_program": True}, obs=obs)
    assert sum(issubclass(w.category, RuntimeWarning) for w in rec) == 2
    assert ours.fallback_reason == ref.fallback_reason
    assert "gated cross-attention (vision bridge)" in ours.fallback_reason
    assert not ours.on_program_path and not ref.on_program_path
    events = [e for e in obs.flight.events if e["ev"] == "fallback"]
    assert [e["reason"] for e in events] == [ours.fallback_reason]
    gauges = {k: v for k, v in obs.registry.snapshot()["gauges"].items()
              if k.startswith("serving_fallback")}
    want = {k: v for k, v in ref.obs.registry.snapshot()["gauges"].items()
            if k.startswith("serving_fallback")}
    assert gauges == want and list(gauges.values()) == [1.0]
    assert ours.fallback_reason in next(iter(gauges))
    assert not ours.cache["cross_k"].any()
    cfg, _ = _cfgs(VLM)
    params = params_from_numpy(_tree(_cfgs(VLM)[1], 5))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for kw in ({"chunk_size": 4}, {"spec_k": 2}):
            with pytest.raises(ValueError, match="blocked by: Program "
                               "lowering"):
                ServingEngine(cfg, params, slots=2, max_len=16,
                              device="cpu", **kw)


# case -> (arch, config overrides, engine options, the error, its message)
REFUSED = {
    "paged-window": ("smollm-360m", {"attn_window": 8}, {"paged": True},
                     NotImplementedError, "mutually exclusive"),
    "paged-rwkv6": ("rwkv6-7b", {}, {"paged": True},
                     NotImplementedError, "not pageable"),
    "paged-vlm": (VLM, {}, {"paged": True}, ValueError, "paged KV"),
    "kv-quant-vlm": (VLM, {}, {"paged": True, "kv_quant": "int8"},
                     ValueError, "paged KV"),
    "paged-legacy": ("smollm-360m", {}, {"paged": True,
                                         "use_program": False},
                     ValueError, "paged KV"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_engine_refuses_options_rather_than_dropping_them(case):
    """Only a config with no lowering falls back to the legacy loop; an
    option the Program lowering refuses (paged KV beside a window, on a
    recurrent state) raises, and so does paged KV or quantized pages on
    the legacy loop, which has neither: a fallback never serves a path
    other than the one asked for."""
    arch, over, kw, err, match = REFUSED[case]
    cfg, jcfg = _cfgs(arch, **over)
    params = params_from_numpy(_tree(jcfg, 5))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(err, match=match):
            ServingEngine(cfg, params, slots=2, max_len=16, device="cpu",
                          **kw)
