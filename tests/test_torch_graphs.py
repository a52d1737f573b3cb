"""The port's CUDA-graph runners (``executor.graphed_*runner``) on the
CPU, through a stand-in for ``torch.cuda.CUDAGraph`` / ``torch.cuda.graph``
that records every aten op of the captured call without running it
(host reads raise, as they do under stream capture) and re-runs the
record on replay.  Against ``repro``'s jitted runners on the same numpy
weights: the graph-safe (1,)-tensor forms of ``run_prefill`` and the
decode and chunk runs over the contiguous, windowed, paged (bf16 and
int8 pools) and recurrent-family plans, bitwise equal to the int form
inside the port; the runners' logic (eager first call, one graph per
shape, static inputs, fresh outputs, exact launch counts, capture
failures, ``disable_graphs``); and the engine's greedy streams.  f32
smoke configs, held to 1e-5 as the other ``test_torch_*`` files."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402,E501
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.models import (cnn, params_from_numpy,  # noqa: E402
                                transformer)
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402
from test_torch_compiler import TINY  # noqa: E402

TOL = 1e-5          # f32, same math; sums in another order
MAX_LEN = 16
_HOST = {"bool", "int", "float", "Scalar", "number", "SymInt", "SymBool",
         "SymFloat"}


# --- the CUDA-graph stand-in --------------------------------------------------------
def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


class _Capture(TorchDispatchMode):
    """Records each aten op instead of running it, as stream capture
    records kernels: a view aliases now; a computing op gets empty
    outputs of the shapes its meta kernel gives, filled on replay; a
    mutating op runs only on replay.  An op whose result is a host
    value (``.item()``, ``bool(t)``) or whose output shape depends on
    the data (``nonzero``) raises, as a read back under capture does."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if any(str(r.type) in _HOST for r in schema.returns):
            raise RuntimeError(f"{func} reads a value back to the host "
                               f"during capture")
        if schema.is_mutable:
            self.ops.append((func, args, kwargs, None))
            for a, v in zip(schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write:
                    return v
            return kwargs["out"]
        if schema.returns and schema.returns[0].alias_info is not None:
            return func(*args, **kwargs)
        meta_kw = tree_map(_meta, kwargs)
        if "device" in meta_kw:
            meta_kw["device"] = "meta"
        shapes = func(*tree_map(_meta, args), **meta_kw)
        out = tree_map(lambda m: torch.empty_strided(
            m.shape, m.stride(), dtype=m.dtype)
            if isinstance(m, torch.Tensor) else m, shapes)
        self.ops.append((func, args, kwargs, out))
        return out


class FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: ``replay`` re-runs the ops
    the capture recorded, in order, against the tensors they named --
    with autograd off, as a graph replays kernels, not autograd's
    record (a captured backward is among the recorded ops)."""
    made = []

    def __init__(self):
        self.ops, self.replays = None, 0
        FakeGraph.made.append(self)

    @torch.no_grad()
    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            if out is None:
                continue
            pairs = (zip(out, res) if isinstance(out, (tuple, list))
                     else [(out, res)])
            for o, r in pairs:
                if isinstance(o, torch.Tensor):
                    o.copy_(r)


class fake_graph:
    """``torch.cuda.graph(g, pool=...)`` on the CPU."""

    def __init__(self, graph, pool=None, stream=None, **_):
        self.graph = graph

    def __enter__(self):
        self.mode = _Capture()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self.graph.ops = self.mode.ops


@pytest.fixture
def graphs(monkeypatch):
    """Graphs on the CPU through the stand-in; yields the list of the
    graphs captured."""
    FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(executor, "_graphable",
                        lambda device: executor._GRAPHS_ON)
    yield FakeGraph.made


@pytest.fixture
def counting(monkeypatch):
    """The matmul and decode-attention ops down their kernel path on CPU
    tensors, each CUDA wrapper's plain version in its place, counting in
    the real wrappers' ``launches`` and ``path_launches`` as a launch
    does."""
    def matmul(a, b, *, dataflow, block, **kw):
        plan = mm_kernel.matmul_plan(a.shape[0], a.shape[1], b.shape[1],
                                     a.dtype, aligned=True)
        mm_kernel.matmul_cuda.launches += 1
        mm_kernel.matmul_cuda.path_launches[plan.path] += 1
        return mm_kernel.matmul_plain(a, b, **kw)

    def decode(q, k, v, kv_len, *, scale):
        dec_kernel.decode_attention_cuda.launches += 1
        return dec_kernel.decode_attention_plain(q, k, v, kv_len,
                                                 scale=scale)
    monkeypatch.setattr(mm_ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(mm_ops, "matmul_cuda", matmul)
    monkeypatch.setattr(dec_ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(dec_ops, "decode_attention_cuda", decode)
    for fn in (mm_kernel.matmul_cuda, dec_kernel.decode_attention_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(mm_kernel.matmul_cuda, "path_launches",
                        {"skinny": 0, "wgmma": 0, "simt": 0})


# --- both packages' configs and weights -----------------------------------------------
def _cfgs(name, **over):
    cfg, jcfg = REGISTRY[name].smoke(), JAX_REGISTRY[name].smoke()
    if over:
        cfg = dataclasses.replace(cfg, **over)
        jcfg = dataclasses.replace(jcfg, **over)
    return cfg, jcfg


def _params(jcfg, seed):
    tree = numpy_params(get_model(jcfg).param_defs(jcfg), seed)
    return params_from_numpy(tree), _jax_tree(tree)


def _padded(prompt):
    padded = np.zeros((1, MAX_LEN), np.int32)
    padded[0, :len(prompt)] = prompt
    return padded


def _close(ours, ref):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=TOL)


def _same_state(a, b):
    assert torch.equal(a.lengths, b.lengths)
    for rid in a.caches:
        assert torch.equal(a.caches[rid], b.caches[rid]), rid


def _smoke_pair(**kw):
    cfg, jcfg = _cfgs("smollm-360m", n_layers=2)
    params, _ = _params(jcfg, seed=31)
    pair = transformer.compile_program_pair(cfg, slots=3, max_len=MAX_LEN,
                                            **kw)
    return cfg, params, pair


# --- graph-safe forms against repro's jitted runners ---------------------------------
# (config, overrides, paged kw, chunked)
PLANS = {
    "contiguous": ("smollm-360m", {"n_layers": 2}, None, True),
    "windowed": ("smollm-360m", {"n_layers": 2, "attn_window": 6}, None,
                 True),
    "paged-bf16": ("smollm-360m", {"n_layers": 2, "kv_dtype": "bfloat16"},
                   {"page_size": 4}, True),
    "paged-int8": ("smollm-360m", {"n_layers": 2},
                   {"page_size": 4, "kv_quant": "int8"}, False),
    "zamba2-7b": ("zamba2-7b", {}, None, False),
    "mamba2": ("mamba2", {}, None, False),
    "rwkv6-7b": ("rwkv6-7b", {}, None, False),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_graphed_runs_match_reference_and_the_int_form(plan, graphs):
    """Two admissions (the second shares the first's pages on a paged
    plan), 10 decode ticks past max_len with slot 1 dead for the last
    3, then (where the plan is chunkable) slot 1 re-admitted in three
    chunks: through the graphed runners -- (1,)-tensor scalars, second
    call of each shape captured -- against ``repro``'s jitted runners
    (logits and final state within 1e-5), and bitwise against the int
    form of ``run_prefill`` and the eager runs on a second state."""
    name, over, paged, chunked = PLANS[plan]
    cfg, jcfg = _cfgs(name, **over)
    params, jparams = _params(jcfg, seed=41)
    kw = dict(slots=2, max_len=MAX_LEN, **(dict(paged, paged=True)
                                           if paged else {}))
    pair = transformer.compile_program_pair(cfg, **kw)
    jpair = jax_tf.compile_program_pair(jcfg, **kw)
    state = executor.init_program_state(pair, "cpu")
    eager = executor.init_program_state(pair, "cpu")
    jstate = jax_executor.init_program_state(jpair)
    pool = executor.PagePool(pair.paged, 2) if paged else None
    pre = executor.graphed_prefill_runner(pair.prefill)
    dec = executor.graphed_decode_runner(pair.decode)
    jpre = jax_executor.jitted_prefill_runner(jpair.prefill,
                                              impl="reference")
    jdec = jax_executor.jitted_decode_runner(jpair.decode, impl="reference")

    def table():
        for st in (state, eager):
            st.caches[pair.page_table_region].copy_(
                torch.from_numpy(pool.table))
        jstate.caches[jpair.page_table_region] = jnp.asarray(pool.table)

    rng = np.random.default_rng(42)
    base = rng.integers(0, cfg.vocab, size=9)
    prompts = [np.append(base, [7, 3]), np.append(base, 11)]
    last = np.zeros((2,), np.int32)
    for slot, prompt in enumerate(prompts):
        wf = 0
        if paged:
            shared = (pool.shared_prefix_pages(0, tuple(prompts[0]),
                                               tuple(prompt)) if slot else ())
            wf = pool.admit(slot, len(prompt), shared)
            table()
        padded = _padded(prompt)
        ours = pre(params, torch.from_numpy(padded), state, slot,
                   len(prompt), wf)
        ints = executor.run_prefill(pair.prefill, params,
                                    torch.from_numpy(padded), eager, slot,
                                    len(prompt), wf)
        ref, jstate = jpre(jparams, jnp.asarray(padded), jstate, slot,
                           len(prompt), wf)
        assert torch.equal(ours, ints)
        _close(ours, ref)
        last[slot] = int(np.argmax(np.asarray(ref)[0, len(prompt) - 1]))
    assert wf == (8 if paged else 0)
    lens, mask = [len(p) for p in prompts], np.ones((2,), bool)
    for step in range(10):
        if step == 7:
            mask[1] = False
        if paged:
            copies = [c for s in range(2) if mask[s] and (
                c := pool.prepare_decode(s, lens[s])) is not None]
            table()
            for st in (state, eager):
                executor.apply_page_copies(st, pair, copies)
            jax_executor.apply_page_copies(jstate, jpair, copies)
        ours = dec(params, torch.from_numpy(last), state,
                   torch.from_numpy(mask))
        plain = executor.run_decode(pair.decode, params,
                                    torch.from_numpy(last), eager,
                                    torch.from_numpy(mask))
        ref, jstate = jdec(jparams, jnp.asarray(last), jstate,
                           jnp.asarray(mask))
        assert torch.equal(ours, plain)
        live = np.flatnonzero(mask)
        _close(ours[live], np.asarray(ref)[live])
        last = np.argmax(np.asarray(ref), axis=-1).astype(np.int32)
        lens = [n + int(m) for n, m in zip(lens, mask)]
    if chunked:
        chunk = executor.graphed_chunk_runner(pair.prefill)
        jchunk = jax_executor.jitted_chunk_runner(jpair.prefill,
                                                  impl="reference")
        prompt = rng.integers(0, cfg.vocab, size=13)
        wf = 0
        if paged:
            pool.release(1)
            wf = pool.admit(1, len(prompt))
            table()
        padded = _padded(prompt)
        for start, stop in ((0, 5), (5, 10), (10, 13)):
            args = ([1], [start], [stop], [13], [wf])
            ours = chunk(params, torch.from_numpy(padded), state, *args)
            plain = executor.run_prefill_chunk(
                pair.prefill, params, torch.from_numpy(padded), eager,
                *args)
            ref, jstate = jchunk(jparams, jnp.asarray(padded), jstate,
                                 *map(jnp.asarray, args))
            assert torch.equal(ours, plain)
            _close(ours[0, start:stop], np.asarray(ref)[0, start:stop])
    _same_state(state, eager)
    np.testing.assert_array_equal(state.lengths.numpy(),
                                  np.asarray(jstate.lengths))
    n = pair.paged.n_pages if paged else None
    for rid, buf in state.caches.items():
        ours, ref = buf, jstate.caches[rid]
        if n is not None and buf.shape[0] == n:
            ours, ref = ours[1:], ref[1:]      # the null page: don't-care
        if ours.dtype in (torch.int8, torch.int32):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        else:
            _close(ours, ref)
    # prefill and decode, and the chunk run at B = 1, each captured once
    captured = [g for g in state.graphs.graphs.values() if g is not None]
    assert len(captured) == (3 if chunked else 2) == len(graphs)


# --- the runners' logic --------------------------------------------------------------
def test_first_call_is_eager_the_second_captures_later_ones_replay(graphs):
    """A decode tick: no graph on the first call, one captured and
    replayed once on the second, the same graph replayed after; the
    chunk run gets one graph per batch width."""
    cfg, params, pair = _smoke_pair()
    state = executor.init_program_state(pair, "cpu")
    dec = executor.graphed_decode_runner(pair.decode)
    toks = torch.tensor([1, 2, 3], dtype=torch.int32)
    dec(params, toks, state)
    assert graphs == []
    dec(params, toks, state)
    assert len(graphs) == 1 and graphs[0].replays == 1
    assert graphs[0].ops                 # recorded, not run, at capture
    for _ in range(3):
        dec(params, toks, state)
    assert len(graphs) == 1 and graphs[0].replays == 4
    assert executor.graphed_decode_runner(pair.decode) is dec
    chunk = executor.graphed_chunk_runner(pair.prefill)
    tokens = torch.zeros((3, MAX_LEN), dtype=torch.int32)
    widths = (1, 2, 1, 2, 3, 1, 3)
    for b in widths:
        chunk(params, tokens[:b], state, list(range(b)), [0] * b, [2] * b,
              [4] * b)
    keys = [k for k in state.graphs.graphs if k[2] == "chunk"]
    assert len(keys) == 3                           # one per width B
    assert len(graphs) == 1 + 3
    assert [g.replays for g in graphs[1:]] == [2, 1, 1]   # B = 1, 2, 3
    assert state.graphs.capture_seconds > 0


def test_replays_read_each_calls_inputs_and_return_fresh_outputs(graphs):
    """Each call's tokens, mask and scalars reach the replay (results
    equal the eager runs on a twin state), and a result held from an
    earlier call is not overwritten by later replays."""
    cfg, params, pair = _smoke_pair()
    state = executor.init_program_state(pair, "cpu")
    twin = executor.init_program_state(pair, "cpu")
    pre = executor.graphed_prefill_runner(pair.prefill)
    dec = executor.graphed_decode_runner(pair.decode)
    rng = np.random.default_rng(43)
    held = []
    for slot, n in enumerate((4, 9, 6)):
        padded = _padded(rng.integers(0, cfg.vocab, size=n))
        out = pre(params, torch.from_numpy(padded), state, slot, n)
        want = executor.run_prefill(pair.prefill, params,
                                    torch.from_numpy(padded), twin, slot, n)
        assert torch.equal(out, want)
        held.append((out, out.clone()))
    for step in range(6):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=3)
                                .astype(np.int32))
        mask = torch.tensor([True, step % 2 == 0, step < 4])
        out = dec(params, toks, state, mask)
        assert torch.equal(out, executor.run_decode(
            pair.decode, params, toks, twin, mask))
        held.append((out, out.clone()))
    _same_state(state, twin)
    assert all(torch.equal(a, b) for a, b in held)
    assert len({id(a) for a, _ in held}) == len(held)


def test_launch_counts_are_calls_times_ops_per_call(graphs, counting):
    """With the kernels' plain versions counting as launches: after n
    prefills and n ticks, matmul and decode-attention counts (and the
    matmul paths) are n x the Program's ops per call; the capture's
    bumps are rolled back, each replay adds the captured count."""
    cfg, params, pair = _smoke_pair()
    state = executor.init_program_state(pair, "cpu")
    pre = executor.graphed_prefill_runner(pair.prefill)
    dec = executor.graphed_decode_runner(pair.decode)
    mm = mm_kernel.matmul_cuda
    da = dec_kernel.decode_attention_cuda
    n_pre = sum(op.kernel == "matmul" for op in pair.prefill.ops)
    n_dec = sum(op.kernel == "matmul" for op in pair.decode.ops)
    n_att = sum(op.kernel == "decode_attention" for op in pair.decode.ops)
    for slot in range(3):
        pre(params, torch.from_numpy(_padded([5, 6, 7])), state, slot, 3)
        assert mm.launches == (slot + 1) * n_pre
    toks = torch.tensor([1, 2, 3], dtype=torch.int32)
    for n in range(1, 6):
        dec(params, toks, state)
        assert (mm.launches, da.launches) == (3 * n_pre + n * n_dec,
                                              n * n_att)
    assert sum(mm.path_launches.values()) == mm.launches
    captured = {k[2]: g for k, g in state.graphs.graphs.items()}
    (k1, a1), (k2, a2) = captured["decode"].launches
    assert (k1, a1["launches"], k2, a2["launches"]) == (mm, n_dec, da, n_att)
    assert sum(a1["path_launches"].values()) == n_dec
    with executor.disable_graphs():
        dec(params, toks, state)
    assert (mm.launches, da.launches) == (3 * n_pre + 6 * n_dec, 6 * n_att)


def test_disable_graphs_and_the_cpu_run_eagerly(monkeypatch, graphs):
    """Under ``disable_graphs()`` no call captures or replays, with the
    same results; without the stand-in's switch a CPU state never
    graphs (the plain path)."""
    cfg, params, pair = _smoke_pair()
    state = executor.init_program_state(pair, "cpu")
    twin = executor.init_program_state(pair, "cpu")
    dec = executor.graphed_decode_runner(pair.decode)
    toks = torch.tensor([4, 5, 6], dtype=torch.int32)
    with executor.disable_graphs():
        for _ in range(3):
            out = dec(params, toks, state)
            assert torch.equal(out, executor.run_decode(
                pair.decode, params, toks, twin))
        assert graphs == [] and not state.graphs.graphs
    assert executor._GRAPHS_ON
    monkeypatch.undo()
    assert not executor._graphable(torch.device("cpu"))
    for _ in range(3):
        dec(params, toks, state)
    assert not state.graphs.graphs


def test_a_capture_that_fails_raises_with_no_eager_fallback(monkeypatch,
                                                             graphs):
    """A host read inside the captured call raises out of the runner;
    the state is untouched, nothing is cached as captured, and the
    launch counters are rolled back."""
    cfg, params, pair = _smoke_pair()
    state = executor.init_program_state(pair, "cpu")
    dec = executor.graphed_decode_runner(pair.decode)
    toks = torch.tensor([1, 2, 3], dtype=torch.int32)
    dec(params, toks, state)                         # the eager first call
    before = {r: b.clone() for r, b in state.caches.items()}
    lengths = state.lengths.clone()
    run_decode = executor.run_decode
    n0 = mm_kernel.matmul_cuda.launches

    def reads_back(program, params, tokens, state, mask, **kw):
        mm_kernel.matmul_cuda.launches += 1
        if int(tokens.sum()) < 0:
            raise AssertionError("unreachable")
        return run_decode(program, params, tokens, state, mask, **kw)
    monkeypatch.setattr(executor, "run_decode", reads_back)
    with pytest.raises(RuntimeError, match="host"):
        dec(params, toks, state)
    assert torch.equal(state.lengths, lengths)
    assert all(torch.equal(before[r], b) for r, b in state.caches.items())
    assert list(state.graphs.graphs.values()) == [None]
    assert mm_kernel.matmul_cuda.launches == n0


def test_cnn_forward_runs_off_the_graphed_runner(graphs):
    """``models/cnn.py::forward`` through ``graphed_runner``: the TINY
    net's second call of a batch shape is captured, every call equals
    the eager run, another batch is another graph."""
    params = params_from_numpy(numpy_params(cnn.param_defs(TINY), seed=44))
    rng = np.random.default_rng(45)
    for b in (2, 2, 2, 3, 3):
        x = torch.from_numpy(rng.standard_normal((b, 16, 16, 4))
                             .astype(np.float32))
        out = cnn.forward(params, x, TINY)
        with executor.disable_graphs():
            assert torch.equal(out, cnn.forward(params, x, TINY))
    assert [g.replays for g in graphs] == [2, 1]
    runner = executor.graphed_runner(cnn.compile_program(TINY, batch=2))
    assert runner.store(params).capture_seconds > 0


# --- the engine through the graphed runners ------------------------------------------
# (config, overrides, engine kw, prompt lengths, shared prefix)
ENGINE = {
    "dense": ("smollm-360m", {"n_layers": 2}, {}, (3, 20, 7, 1, 12), 0),
    "paged": ("smollm-360m", {"n_layers": 2},
              {"paged": True, "page_size": 4}, (1, 2, 3, 4), 9),
    "chunked": ("smollm-360m", {"n_layers": 2},
                {"paged": True, "page_size": 4, "chunk_size": 3},
                (3, 9, 14, 5), 4),
    "zamba2-7b": ("zamba2-7b", {}, {}, (3, 20, 7, 1), 0),
    "rwkv6-7b": ("rwkv6-7b", {}, {}, (3, 20, 7, 1), 0),
}


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_engine_streams_through_graphs_match_reference_engine(case,
                                                              graphs):
    """Greedy streams of an engine serving through the graphed runners
    (the stand-in) equal ``repro``'s ``ServingEngine(use_program=True)``
    and the eager engine's under ``disable_graphs()``; its ticks ran off
    captured graphs."""
    name, over, kw, lens, prefix = ENGINE[case]
    cfg, jcfg = _cfgs(name, **over)
    params, jparams = _params(jcfg, seed=46)
    rng = np.random.default_rng(47)
    head = rng.integers(0, cfg.vocab, size=prefix)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, size=n)])
               .astype(np.int32) for n in lens]
    kw = dict(kw, slots=2, max_len=MAX_LEN)

    def serve(eng, req_cls):
        for i, p in enumerate(prompts):
            assert eng.submit(req_cls(uid=i, prompt=p,
                                      max_new_tokens=7)).accepted
        return {r.uid: r.out_tokens for r in eng.run_until_drained()}
    ours = ServingEngine(cfg, params, device="cpu", **kw)
    got = serve(ours, Request)
    assert got == serve(JaxEngine(jcfg, jparams, use_program=True,
                                  impl="reference", **kw), JaxRequest)
    with executor.disable_graphs():
        assert got == serve(ServingEngine(cfg, params, device="cpu", **kw),
                            Request)
    assert sorted(got) == list(range(len(prompts)))
    decode = [g for k, g in ours.state.graphs.graphs.items()
              if k[2] == "decode"]
    assert decode[0].graph.replays == ours.n_decode_ticks - 1
    assert ours.capture_seconds == ours.state.graphs.capture_seconds > 0
