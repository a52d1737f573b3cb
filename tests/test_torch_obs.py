"""The port's observability plane (``repro_torch.obs``) against
``repro.obs``: every case of ``tests/test_observability.py`` run on both
packages with the same calls -- counters, gauges, histogram percentiles
(also against a numpy oracle), the registry's snapshot, JSON and
Prometheus text (byte for byte), the flight recorder's schema, JSONL
file and replay under a fake clock -- and the serving engines of both
packages on the same numpy weights: equal counter snapshots, equal
flight event sequences (with a fake clock, equal snapshots and events
field for field), ``replay_summary`` reproducing every stream, the
default bundle's zero-event mode, sampled op timing that changes
nothing it samples, and admission accounting on the registry."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.obs as jax_obs  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402

PKGS = {"port": obs, "reference": jax_obs}


def _both(fn):
    """``fn(pkg)`` for the port and the reference; the two results."""
    return fn(obs), fn(jax_obs)


def _fake_clock(step=0.25):
    t = iter(np.arange(0.0, 1e6, step))
    return lambda: float(next(t))


# --- metrics: primitives ---------------------------------------------------------------
def test_counter_and_gauge_match_reference():
    def drive(pkg):
        c = pkg.Counter()
        c.inc()
        c.inc(3)
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1)
        g = pkg.Gauge()
        g.set(7)
        g.inc(2)
        g.dec()
        return c.value, g.value
    ours, ref = _both(drive)
    assert ours == ref == (4, 8)


def test_histogram_percentiles_match_reference_and_numpy_oracle():
    """Fine linear buckets: each interpolated percentile lands within one
    bucket width of numpy's order statistics, and equals the reference's
    bit for bit (the same float arithmetic)."""
    rng = np.random.default_rng(0)
    edges = [float(x) for x in np.linspace(0.5, 500.0, 1000)]
    width = edges[1] - edges[0]
    for sample in (rng.uniform(1, 400, 5000),
                   rng.exponential(40, 5000) + 1,
                   rng.normal(200, 30, 5000).clip(1, 499)):
        hs = {}
        for name, pkg in PKGS.items():
            hs[name] = h = pkg.Histogram(edges)
            for v in sample:
                h.observe(float(v))
        for q in (1, 10, 25, 50, 75, 90, 99, 99.9):
            lo = float(np.percentile(sample, q, method="lower"))
            hi = float(np.percentile(sample, q, method="higher"))
            got = hs["port"].percentile(q)
            assert lo - width - 1e-9 <= got <= hi + width + 1e-9, \
                (q, got, lo, hi)
            assert got == hs["reference"].percentile(q)
        h = hs["port"]
        assert h.count == len(sample) == hs["reference"].count
        assert h.sum == pytest.approx(float(sample.sum()))
        assert h.mean == pytest.approx(float(sample.mean()))
        assert h.counts == hs["reference"].counts


def test_histogram_overflow_floors_at_last_edge():
    def drive(pkg):
        h = pkg.Histogram([1.0, 2.0, 4.0])
        for v in (10.0, 20.0, 30.0):
            h.observe(v)
        with pytest.raises(ValueError):
            h.percentile(101)
        with pytest.raises(ValueError):
            pkg.Histogram([2.0, 1.0])
        return h.saturated, h.percentile(50)
    ours, ref = _both(drive)
    assert ours == ref == (3, 4.0)


def test_exp_buckets_and_layouts_match_reference():
    assert obs.exp_buckets(1.0, 16.0, factor=2.0) == [1.0, 2.0, 4.0, 8.0,
                                                      16.0]
    assert obs.LATENCY_MS_BUCKETS == jax_obs.LATENCY_MS_BUCKETS
    assert obs.TIME_S_BUCKETS == jax_obs.TIME_S_BUCKETS
    with pytest.raises(ValueError, match="lo > 0"):
        obs.exp_buckets(0.0, 1.0)


# --- metrics: registry -------------------------------------------------------------------
def test_registry_register_or_fetch_and_labels():
    def drive(pkg):
        m = pkg.MetricsRegistry()
        c1 = m.counter("reqs_total", reason="a")
        c2 = m.counter("reqs_total", reason="a")
        c3 = m.counter("reqs_total", reason="b")
        assert c1 is c2 and c1 is not c3
        c1.inc(2)
        c3.inc()
        with pytest.raises(ValueError, match="already registered"):
            m.gauge("reqs_total")
        return m.snapshot()
    ours, ref = _both(drive)
    assert ours == ref
    assert ours["counters"]['reqs_total{reason="a"}'] == 2


def _drive_registry(pkg):
    m = pkg.MetricsRegistry()
    m.counter("c_total", help="a counter").inc(3)
    m.counter("blocked_total", help="by reason", reason="x").inc(2)
    m.counter("blocked_total", reason="y").inc(0.5)
    m.gauge("g").set(1.5)
    h = m.histogram("h_ms", buckets=[1.0, 10.0])
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    lat = m.histogram("lat_ms", help="latency", kind="decode")
    for v in np.random.default_rng(3).exponential(2.0, 200):
        lat.observe(float(v))
    return m


def test_registry_snapshot_json_and_prometheus_text_byte_equal():
    ours, ref = _both(_drive_registry)
    snap = ours.snapshot()
    assert snap == ref.snapshot()
    assert snap["histograms"]["h_ms"]["counts"] == [1, 1, 1]
    assert ours.to_json(run="test") == ref.to_json(run="test")
    assert json.loads(ours.to_json(run="test"))["meta"]["run"] == "test"
    text = ours.prometheus_text()
    assert text.encode() == ref.prometheus_text().encode()
    assert "# TYPE c_total counter" in text and "c_total 3" in text
    assert 'h_ms_bucket{le="+Inf"} 3' in text and "h_ms_count 3" in text
    assert 'blocked_total{reason="y"} 0.5' in text


# --- flight recorder ---------------------------------------------------------------------
def test_flight_schema_enforced_at_emit():
    assert obs.EVENT_FIELDS == jax_obs.EVENT_FIELDS

    def drive(pkg):
        fr = pkg.FlightRecorder(clock=lambda: 1.5)
        with pytest.raises(ValueError, match="unknown flight event"):
            fr.event("warp_drive", engaged=True)
        with pytest.raises(ValueError, match="missing required"):
            fr.event("enqueue", uid=1)
        fr.event("enqueue", uid=1, prompt_len=4)
        return fr.events
    ours, ref = _both(drive)
    assert ours == ref == [{"ev": "enqueue", "t": 1.5, "uid": 1,
                            "prompt_len": 4}]


def _lifecycle(fr):
    fr.event("enqueue", uid=7, prompt_len=3)
    fr.event("admission", uid=7, accepted=True, reason="queued")
    fr.event("prefill_start", uid=7, slot=0, length=3, write_from=0)
    fr.event("prefill_chunk", uid=7, slot=0, start=0, stop=3)
    fr.event("first_token", uid=7, slot=0, token=11, ttft_ms=750.0)
    fr.event("spec", slot=0, uid=7, proposed=2, accepted=1, rollback=True)
    fr.event("token", uid=7, slot=0, token=12, itl_ms=250.0)
    fr.event("cow_fork", slot=0, src_page=3, dst_page=4)
    fr.event("release", uid=7, slot=0, n_tokens=2, reason="eos")
    fr.event("admission", accepted=False, reason="queue_full", uid=8)
    fr.event("tick", tick=1, dt_ms=1.0, live=0, queue_depth=0,
             free_pages=-1, starved=0)
    fr.event("fallback", reason="none")
    fr.close()


def test_flight_roundtrip_write_parse_replay(tmp_path):
    """The same lifecycle recorded by both packages on a fake clock:
    the JSONL files are byte-equal, parse back to the same events, and
    replay to the same summary."""
    out = {}
    for name, pkg in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        _lifecycle(pkg.FlightRecorder(path, clock=_fake_clock()))
        out[name] = (path.read_bytes(), pkg.read_events(path))
    (text, events), (ref_text, ref_events) = out["port"], out["reference"]
    assert text == ref_text and events == ref_events
    summ = obs.replay_summary(events)
    assert summ == jax_obs.replay_summary(ref_events)
    req = summ["requests"][7]
    assert req["tokens"] == [11, 12] and req["release_reason"] == "eos"
    assert req["chunks"] == 1
    assert summ["totals"]["n_released"] == 1
    assert summ["totals"]["n_tokens"] == 2
    assert summ["totals"]["n_rejected"] == 1
    assert summ["totals"]["n_spec_proposed"] == 2
    assert summ["totals"]["fallbacks"] == ["none"]


def test_flight_parse_rejects_malformed():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="unknown event type"):
            pkg.parse_events('{"ev": "nope", "t": 0}')
        with pytest.raises(ValueError, match="missing"):
            pkg.parse_events('{"ev": "enqueue", "uid": 1}')


def test_replay_ttft_itl_from_fake_clock():
    """TTFT and ITL are recomputed from the timestamps, not read from the
    recorded (here corrupted) fields."""
    def drive(pkg):
        times = iter([0.0, 1.0, 1.5, 1.75, 2.0])
        fr = pkg.FlightRecorder(clock=lambda: next(times))
        fr.event("enqueue", uid=1, prompt_len=2)
        fr.event("admission", uid=1, accepted=True, reason="queued")
        fr.event("first_token", uid=1, slot=0, token=5, ttft_ms=-1.0)
        fr.event("token", uid=1, slot=0, token=6, itl_ms=-1.0)
        fr.event("token", uid=1, slot=0, token=7, itl_ms=-1.0)
        return pkg.replay_summary(fr.events)
    ours, ref = _both(drive)
    assert ours == ref
    assert ours["requests"][1]["ttft_ms"] == pytest.approx(1500.0)
    assert ours["requests"][1]["itl_ms"] == pytest.approx([250.0, 250.0])


def test_replay_raises_on_token_count_mismatch():
    for pkg in PKGS.values():
        fr = pkg.FlightRecorder(clock=lambda: 0.0)
        fr.event("enqueue", uid=1, prompt_len=2)
        fr.event("first_token", uid=1, slot=0, token=5, ttft_ms=1.0)
        fr.event("release", uid=1, slot=0, n_tokens=3, reason="eos")
        with pytest.raises(ValueError, match="replayed"):
            pkg.replay_summary(fr.events)


def test_obs_imports_the_standard_library_only():
    """``repro_torch.obs`` imports no torch, numpy or jax: the plane is
    importable before (and without) the numeric stack."""
    import os
    import subprocess
    import sys
    probe = ("import sys, repro_torch.obs; bad = sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax', "
             "'jaxlib', 'repro')); assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_null_recorder_and_bundle():
    bundle = obs.Observability()
    assert bundle.flight is obs.NULL and not bundle.flight_enabled
    bundle.flight.event("no_such_event")          # disabled: no check
    assert bundle.flight.events == ()
    rec = obs.Observability(flight_path=None,
                            flight=obs.FlightRecorder(clock=lambda: 0.0))
    assert rec.flight_enabled


# --- the engines on the plane ------------------------------------------------------------
_CFG = dataclasses.replace(REGISTRY["smollm-360m"].smoke(), n_layers=2)
_JCFG = dataclasses.replace(JAX_REGISTRY["smollm-360m"].smoke(), n_layers=2)
_TREE = numpy_params(jax_tf.param_defs(_JCFG), 41)
_PARAMS, _JPARAMS = params_from_numpy(_TREE), _jax_tree(_TREE)


def _run_engine(port: bool, bundle=None, **eng_over):
    """The reference suite's engine run (2 slots, max_len 32, chunk 8,
    3 requests of 4 new tokens) in either package."""
    kw = dict(dict(slots=2, max_len=32, chunk_size=8, obs=bundle),
              **eng_over)
    if port:
        eng = ServingEngine(_CFG, _PARAMS, device="cpu", **kw)
        req_cls = Request
    else:
        eng = JaxEngine(_JCFG, _JPARAMS, impl="reference", use_program=True,
                        **kw)
        req_cls = JaxRequest
    rng = np.random.default_rng(3)
    reqs = [req_cls(uid=i, prompt=rng.integers(1, _CFG.vocab, size=4 + i)
                    .astype(np.int32), max_new_tokens=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    return eng, reqs, done


def _key_fields(events):
    keys = ("ev", "uid", "slot", "token", "reason")
    return [tuple(e.get(k) for k in keys) for e in events]


@pytest.mark.parametrize("over", [{}, {"queue_capacity": 1},
                                  {"chunk_size": None}],
                         ids=["chunked", "capacity-1", "whole"])
def test_engine_snapshot_and_flight_match_reference_engine(over):
    """Both engines on one fake clock: counters, gauges and histograms
    (the latencies are clock differences) equal, the flight events equal
    field for field, and the read-through ``n_*`` equal the counters."""
    runs = {}
    for port in (True, False):
        pkg = obs if port else jax_obs
        bundle = pkg.Observability(clock=_fake_clock(),
                                   flight=pkg.FlightRecorder())
        bundle.flight.clock = bundle.clock
        runs[port] = _run_engine(port, bundle, **over) + (bundle,)
    (eng, reqs, done, bundle), (_, jreqs, _, jbundle) = runs[True], runs[False]
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    snap = bundle.registry.snapshot()
    assert snap == jbundle.registry.snapshot()
    assert bundle.registry.prometheus_text() == \
        jbundle.registry.prometheus_text()
    assert _key_fields(bundle.flight.events) == \
        _key_fields(jbundle.flight.events)
    assert bundle.flight.events == jbundle.flight.events
    c = snap["counters"]
    assert eng.n_prefills == c["serving_prefills_total"] == len(done) > 0
    assert eng.n_prefill_recomputes == \
        c["serving_prefill_recomputes_total"] == 0
    assert eng.n_decode_ticks == c["serving_decode_ticks_total"] > 0
    assert eng.n_prefill_chunks == c["serving_prefill_chunks_total"]
    assert eng.n_starved_ticks == c["serving_starved_ticks_total"] == 0
    assert c["serving_tokens_total"] == \
        sum(len(r.out_tokens) for r in done)
    assert c["serving_requests_finished_total"] == len(done)
    assert snap["histograms"]["ttft_ms"]["count"] == len(done)
    assert snap["histograms"]["tick_ms"]["count"] == eng.tick_no
    assert eng.dashboard_line() == runs[False][0].dashboard_line()


def test_engine_counters_match_reference_on_the_real_clock():
    """The reference suite's parity run: with the real clock the
    counters (not the latencies) and the event sequence match."""
    (eng, _, done), (ref, _, _) = _run_engine(True), _run_engine(False)
    snap, jsnap = (e.obs.registry.snapshot() for e in (eng, ref))
    assert snap["counters"] == jsnap["counters"]
    assert snap["histograms"]["itl_ms"]["count"] == 9
    assert snap["histograms"]["ttft_ms"]["count"] == 3
    assert eng.dashboard_line().startswith("tick")


def test_engine_flight_replay_matches_token_streams(tmp_path):
    """The flight record replays to exactly the engine's streams, from
    memory and from the file, as the reference's does."""
    path = tmp_path / "flight.jsonl"
    bundle = obs.Observability(flight_path=str(path))
    eng, reqs, done = _run_engine(True, bundle)
    bundle.close()
    summ = obs.replay_summary(bundle.flight.events)
    assert set(summ["requests"]) == {r.uid for r in reqs}
    for r in reqs:
        assert summ["requests"][r.uid]["tokens"] == r.out_tokens
        assert summ["requests"][r.uid]["prompt_len"] == len(r.prompt)
        assert summ["requests"][r.uid]["release_reason"] == "max_new_tokens"
    assert summ["totals"]["n_tokens"] == sum(len(r.out_tokens) for r in done)
    disk = obs.read_events(path)
    assert disk == bundle.flight.events
    assert obs.replay_summary(disk) == summ
    jbundle = jax_obs.Observability(flight=jax_obs.FlightRecorder())
    _run_engine(False, jbundle)
    jsumm = jax_obs.replay_summary(jbundle.flight.events)
    assert {u: q["tokens"] for u, q in summ["requests"].items()} == \
        {u: q["tokens"] for u, q in jsumm["requests"].items()}


def test_disabled_mode_zero_events_no_sampler():
    eng, _, done = _run_engine(True)
    assert eng.obs.flight is obs.NULL and eng.obs.flight.events == ()
    assert not eng.obs.flight_enabled
    assert eng._op_sampler is None
    assert sum(len(r.out_tokens) for r in done) == 12


def test_op_sampler_cadence_metrics_and_no_intervention():
    """``sample_ops_every=2``: one decode tick in two is walked op by op;
    ``op_time_us{kind}`` histograms fill, the ``op_sample`` events name
    the reference's ops with its modeled costs, and the streams, the
    counters and the final state's bytes equal the unsampled run's."""
    base, _, base_done = _run_engine(True)
    bundle = obs.Observability(sample_ops_every=2,
                               flight=obs.FlightRecorder())
    eng, _, done = _run_engine(True, bundle)
    jbundle = jax_obs.Observability(sample_ops_every=2,
                                    flight=jax_obs.FlightRecorder())
    _run_engine(False, jbundle)
    assert eng._op_sampler.n_samples >= 1
    assert eng._op_sampler.n_calls == eng.n_decode_ticks
    keys = [k for k in bundle.registry.snapshot()["histograms"]
            if k.startswith("op_time_us")]
    assert any("decode_attention" in k for k in keys)
    assert any("matmul" in k for k in keys)

    def samples(events):
        return [(e["kind"], e["name"], e["index"], e["flops"],
                 e["traffic_bytes"], e["modeled_time_s"])
                for e in events if e["ev"] == "op_sample"]
    assert samples(bundle.flight.events) == samples(jbundle.flight.events)
    assert all(e["measured_time_s"] > 0 for e in bundle.flight.events
               if e["ev"] == "op_sample")
    assert [r.out_tokens for r in done] == [r.out_tokens for r in base_done]
    snap = bundle.registry.snapshot()["counters"]
    assert snap == base.obs.registry.snapshot()["counters"]
    assert torch.equal(eng.state.lengths, base.state.lengths)
    for rid, buf in eng.state.caches.items():
        assert torch.equal(buf, base.state.caches[rid]), rid


def test_admission_counters_on_registry():
    (eng, _, _), (ref, _, _) = (_run_engine(p, queue_capacity=1)
                                for p in (True, False))
    assert eng.admission.n_rejected >= 1
    snap = eng.obs.registry.snapshot()["counters"]
    assert snap["admission_rejected_total"] == eng.admission.n_rejected
    assert eng.admission.blocked["queue_full"] >= 1
    assert dict(eng.admission.blocked) == dict(ref.admission.blocked)
    assert eng.admission.n_requeued == ref.admission.n_requeued
    assert len(eng.admission) == 0


def test_cnn_engine_reports_on_the_plane():
    """A CNN engine's submits and ticks land on the plane as the
    reference's do: requests counted, one tick event per tick."""
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.models import cnn, init_params
    cfg = CNN_REGISTRY["alexnet-owt"]
    gen = torch.Generator().manual_seed(0)
    bundle = obs.Observability(flight=obs.FlightRecorder())
    eng = ServingEngine(cfg, init_params(cnn.param_defs(cfg), gen, "cpu"),
                        slots=2, device="cpu", obs=bundle)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=rng.standard_normal(
            (cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)))
    done = eng.run_until_drained()
    assert len(done) == 3 and eng.n_ticks == eng.tick_no == 2
    evs = [e["ev"] for e in bundle.flight.events]
    assert evs.count("enqueue") == 3 and evs.count("tick") == 2
    snap = bundle.registry.snapshot()
    assert snap["counters"]["serving_requests_total"] == 3
    assert snap["histograms"]["tick_ms"]["count"] == 2


def test_serve_cli_writes_the_plane(tmp_path, capsys):
    """``launch.serve`` with the plane's flags and speculation, on the
    CPU: the JSON snapshot's counters equal the engine's, the ``.prom``
    text holds every counter, the flight file replays every stream, the
    sampled ticks fill ``op_time_us`` and the dashboard prints."""
    from repro_torch.launch import serve
    m, f = tmp_path / "m.json", tmp_path / "f.jsonl"
    res = serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                      "--slots", "2", "--requests", "3", "--max-new", "5",
                      "--max-len", "32", "--prompt-len", "2-20",
                      "--spec-decode", "3", "--metrics-out", str(m),
                      "--flight-out", str(f), "--sample-ops", "2",
                      "--dash-every", "2"])
    out = capsys.readouterr().out
    eng = res["engine"]
    assert f"spec_proposed={eng.n_spec_proposed}" in out
    assert out.count("| live ") == eng.tick_no // 2
    doc = json.loads(m.read_text())
    c = doc["counters"]
    assert doc["meta"]["arch"] == "smollm-360m"
    assert c["serving_spec_accepted_total"] == eng.n_spec_accepted > 0
    assert c["serving_decode_ticks_total"] == eng.n_decode_ticks
    prom = (tmp_path / "m.json.prom").read_text()
    lines = prom.splitlines()
    for name, value in c.items():
        assert f"{name} {obs.metrics._fmt(value)}" in lines
    assert any(k.startswith("op_time_us") for k in doc["histograms"])
    summ = obs.replay_summary(obs.read_events(f))
    assert {u: q["tokens"] for u, q in summ["requests"].items()} == \
        {r.uid: r.out_tokens for r in res["done"]}
    assert summ["totals"]["n_spec_accepted"] == eng.n_spec_accepted
