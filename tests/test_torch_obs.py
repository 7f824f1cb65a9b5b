"""Observability and SLA admission in the port: the copies of the
reference's ``obs`` modules (percentile, Histogram, Prometheus text,
Tracer, MetricsServer), the SLA controller, and the engine's metrics and
tracing (smoke nllb600m, f32, enc-dec requests).

The host-only cases are the reference's own (tests/test_obs.py and the
SLA cases of tests/test_streaming.py), run against the port's copies.
The engine cases hold the tracer to being a pure observer (a traced run
equals an untraced one, with the same syncs, across dense / paged,
fused / per-token and overlapped / serial rounds), check the trace's
discipline and its preemption flows, and hold the port's EngineMetrics
counters to the JAX engine's on the same input (times are not compared).
"""

import dataclasses
import json
import socket
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402
from test_torch_paging import TIGHT, as_jax, five_token_prompts, summary  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.obs import (PHASES, SCHED_TID, Histogram, MetricsServer,  # noqa: E402
                             TraceConfig, Tracer, percentile, render_prometheus)
from repro_torch.serving import (EngineMetrics, SamplingParams, ServeEngine,  # noqa: E402
                                 SLATarget, deploy, impl_routes, latency_percentiles,
                                 merge_metrics)
from repro_torch.serving.metrics import SLAController  # noqa: E402

GREEDY8 = dict(max_new_tokens=8)
SAMPLED6 = dict(temperature=0.8, top_p=0.9, max_new_tokens=6, seed=7)


def prompts():
    rng = np.random.default_rng(9)
    return [{"src_tokens": rng.integers(16, 256, (1, se)).astype(np.int32),
             "tgt_in": rng.integers(3, 200, (1, 5)).astype(np.int32)}
            for se in (5, 8, 6)]


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port(raw_params):
    return deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", **impl_routes("torch"))


def engine(pipe, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 16)
    if kw.pop("paged", False):
        kw.update(paged=True, page_size=4)
        kw.setdefault("num_pages", 8)
    return ServeEngine(pipe.model, pipe.params, ctx=pipe.ctx, kv_dtype=pipe.engine.kv_dtype,
                       device="cpu", **kw)


def serve(eng, ps, sps):
    ids = [eng.submit(p, sp) for p, sp in zip(ps, sps)]
    outs = {o.request_id: o for o in eng.run_until_drained()}
    return [outs[i] for i in ids]


# ---------------------------------------------------------------------------
# percentile, Histogram, Prometheus text (host only)
# ---------------------------------------------------------------------------

def test_percentile_hand_computed_pins():
    vals = list(range(1, 11))
    assert percentile(vals, 0) == 1
    assert percentile(vals, 50) == 5
    assert percentile(vals, 95) == 10
    assert percentile(vals, 100) == 10
    assert percentile([42.0], 95) == 42.0
    assert percentile(reversed(vals), 50) == 5
    assert percentile([], 95) == 0.0


@pytest.mark.parametrize("q", [-1, 100.5])
def test_percentile_rejects_out_of_range_q(q):
    with pytest.raises(ValueError):
        percentile([1.0], q)


def test_latency_percentiles_uses_nearest_rank():
    outs = [types.SimpleNamespace(ttft_ms=float(i), tpot_ms=float(10 * i))
            for i in range(1, 11)]
    assert latency_percentiles(outs) == {"ttft_p50_ms": 5.0, "ttft_p95_ms": 10.0,
                                         "tpot_p50_ms": 50.0, "tpot_p95_ms": 100.0}


def test_sla_controller_p95_matches_shared_percentile():
    ctl = SLAController(SLATarget(p95_ttft_ms=100.0, window=10), horizon=4, slots=4)
    ctl._window = [(float(i), float(2 * i)) for i in range(1, 11)]
    assert ctl._p95(0) == percentile(range(1, 11), 95) == 10.0
    assert ctl._p95(1) == percentile(range(2, 21, 2), 95) == 20.0


def test_histogram_record_mean_percentile():
    h = Histogram(lo=1.0, growth=2.0, n_buckets=8)
    for v in (0.5, 1.5, 3.0, 3.0, 100.0):
        h.record(v)
    assert h.count == 5
    assert h.total == pytest.approx(108.0)
    assert h.mean == pytest.approx(108.0 / 5)
    assert h.percentile(50.0) == 4.0
    assert h.percentile(0.0) == 1.0
    assert Histogram().percentile(95.0) == 0.0


def test_histogram_overflow_clamps_to_top_edge():
    h = Histogram(lo=1.0, growth=2.0, n_buckets=4)
    h.record(1e9)
    assert h.count == 1 and h.overflow == 1
    assert h.percentile(95.0) == h.bounds[-1] == 8.0


def test_histogram_merge_and_reset():
    a, b = Histogram(), Histogram()
    a.record(1.0), a.record(2.0)
    b.record(4.0)
    assert a.merge(b) is a
    assert (a.count, a.total) == (3, 7.0)
    with pytest.raises(ValueError, match="config"):
        a.merge(Histogram(lo=0.5))
    a.reset()
    assert (a.count, a.total) == (0, 0.0)
    assert a.percentile(95.0) == 0.0


class _Snap:
    GAUGES = ("kv_bytes",)

    def as_dict(self):
        return {"requests": 3, "kv_bytes": 4096, "occupancy": 0.5}


def test_render_prometheus_types_and_buckets():
    h = Histogram(lo=1.0, growth=2.0, n_buckets=3)
    for v in (0.5, 1.5, 99.0):
        h.record(v)
    lines = render_prometheus(_Snap(), {"ttft_ms": h}, prefix="x").splitlines()
    assert "# TYPE x_requests counter" in lines
    assert "# TYPE x_kv_bytes gauge" in lines
    assert "# TYPE x_occupancy gauge" in lines
    assert "# TYPE x_ttft_ms histogram" in lines
    assert 'x_ttft_ms_bucket{le="1"} 1' in lines
    assert 'x_ttft_ms_bucket{le="2"} 2' in lines
    assert 'x_ttft_ms_bucket{le="+Inf"} 3' in lines
    assert "x_ttft_ms_count 3" in lines
    assert any(ln.startswith("x_ttft_ms_sum ") for ln in lines)


# ---------------------------------------------------------------------------
# Tracer (host only)
# ---------------------------------------------------------------------------

def test_tracer_balanced_spans_pass_check(tmp_path):
    tr = Tracer(TraceConfig())
    tr.name_track(1, "req 0")
    tr.begin(SCHED_TID, "round", 1.0)
    tr.complete(SCHED_TID, "dispatch", 1.0, 0.5, K=4)
    tr.begin(1, "request", 1.1)
    tr.instant(1, "decode-round", 1.2, planned=4)
    tr.end(1, "request", 1.9)
    tr.end(SCHED_TID, "round", 2.0)
    assert tr.check() == []
    chrome = tr.to_chrome()
    assert chrome["displayTimeUnit"] == "ms"
    assert {"B", "E", "X", "i", "M"} <= {e["ph"] for e in chrome["traceEvents"]}
    p = tmp_path / "trace.json"
    tr.dump_json(str(p))
    assert json.loads(p.read_text())["traceEvents"]


def test_tracer_check_flags_discipline_violations():
    tr = Tracer(TraceConfig())
    tr.begin(0, "round", 1.0)
    assert any("never closed" in p for p in tr.check())
    tr.end(0, "other-name", 2.0)
    assert any("closes" in p for p in tr.check())
    tr2 = Tracer(TraceConfig())
    tr2.end(0, "round", 1.0)
    assert any("without open span" in p for p in tr2.check())


def test_tracer_ring_drops_oldest_and_counts():
    tr = Tracer(TraceConfig(capacity=16))
    for i in range(20):
        tr.instant(0, f"e{i}", float(i))
    assert len(tr) == 16 and tr.dropped == 4
    names = [e.name for e in tr.events]
    assert names[0] == "e4" and names[-1] == "e19"


def test_tracer_clamps_span_stamps_against_backward_clock():
    tr = Tracer(TraceConfig())
    tr.instant(0, "fault:skew", 3.0, ms=-7000)
    tr.begin(0, "round", 10.0)
    tr.end(0, "round", 5.0)
    assert tr.check() == []
    by_ph = {e.ph: e for e in tr.events}
    assert by_ph["E"].ts_us == by_ph["B"].ts_us == pytest.approx(10.0 * 1e6)
    assert by_ph["i"].ts_us == pytest.approx(3.0 * 1e6)


def test_tracer_flow_pair_passes_check_and_exports():
    tr = Tracer(TraceConfig())
    tr.begin(1, "queued", 1.0)
    fid = tr.flow_start(1, "resume", 1.0, count=1)
    tr.end(1, "queued", 2.0)
    tr.begin(1, "request", 2.0)
    tr.flow_end(1, "resume", 2.0, fid)
    tr.end(1, "request", 3.0)
    assert tr.check() == []
    chrome = [e for e in tr.to_chrome()["traceEvents"] if e["ph"] in ("s", "f")]
    assert [e["ph"] for e in chrome] == ["s", "f"]
    assert chrome[0]["id"] == chrome[1]["id"] == fid
    assert chrome[1]["bp"] == "e" and "bp" not in chrome[0]


def test_tracer_flow_violations_flagged():
    tr = Tracer(TraceConfig())
    tr.flow_end(0, "resume", 1.0, 99)
    assert any("without matching s" in p for p in tr.check())
    tr2 = Tracer(TraceConfig())
    tr2.flow_start(0, "resume", 1.0)
    assert any("never finished" in p for p in tr2.check())
    tr3 = Tracer(TraceConfig())
    fid = tr3.flow_start(0, "resume", 5.0)
    tr3.flow_end(0, "resume", 4.0, fid)
    assert any("before it starts" in p for p in tr3.check())
    tr4 = Tracer(TraceConfig())
    fid = tr4.flow_start(0, "resume", 1.0)
    tr4.flow_end(0, "other", 2.0, fid)
    assert any("closes s" in p for p in tr4.check())


def test_trace_config_validates_capacity():
    with pytest.raises(ValueError, match="capacity"):
        TraceConfig(capacity=4)


# ---------------------------------------------------------------------------
# MetricsServer on an ephemeral port (host only)
# ---------------------------------------------------------------------------

def test_metrics_server_serves_renderer_at_metrics_path():
    with MetricsServer(lambda: "up 1\n") as srv:
        assert srv.url == f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert resp.read() == b"up 1\n"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/other", timeout=5)
        assert ei.value.code == 404


def test_metrics_server_render_failure_is_500_and_survives():
    calls = []

    def render():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("collector down")
        return "ok 1\n"

    with MetricsServer(render) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url, timeout=5)
        assert ei.value.code == 500
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.read() == b"ok 1\n"


def test_metrics_server_graceful_shutdown_frees_port():
    srv = MetricsServer(lambda: "x 0\n").start()
    port_no = srv.port
    urllib.request.urlopen(srv.url, timeout=5).read()
    srv.close()
    srv.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(srv.url, timeout=1)
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("127.0.0.1", port_no))
    finally:
        s.close()


def test_metrics_server_scrapes_live_engine(port):
    eng = engine(port)
    with MetricsServer(eng.prometheus) as srv:
        def scrape():
            with urllib.request.urlopen(srv.url, timeout=5) as r:
                return r.read().decode()
        before = scrape()
        serve(eng, prompts()[:1], [SamplingParams(**GREEDY8)])
        after = scrape()

    def synced(text):
        line = [ln for ln in text.splitlines()
                if ln.startswith("repro_serving_synced_tokens ")]
        return float(line[0].split()[-1])

    assert synced(before) == 0 and synced(after) > 0


# ---------------------------------------------------------------------------
# SLA admission (host only, and one served engine)
# ---------------------------------------------------------------------------

def _obs(ttft_ms, tpot_ms):
    return types.SimpleNamespace(ttft_ms=ttft_ms, tpot_ms=tpot_ms)


def test_sla_target_validation():
    with pytest.raises(ValueError, match="constrains nothing"):
        SLATarget()
    with pytest.raises(ValueError, match="positive"):
        SLATarget(p95_ttft_ms=-1)
    with pytest.raises(ValueError, match="window"):
        SLATarget(p95_ttft_ms=10, window=0)
    with pytest.raises(ValueError, match="max_horizon"):
        SLATarget(p95_ttft_ms=10, min_horizon=4, max_horizon=2)


def test_sla_controller_ttft_breach_halves_admission_knobs():
    c = SLAController(SLATarget(p95_ttft_ms=10.0, window=4), horizon=8, slots=4)
    assert c.holding() is None
    for _ in range(3):
        assert not c.observe(_obs(100.0, 1.0))
    assert c.retunes == 0 and c.horizon == 8
    assert c.observe(_obs(100.0, 1.0))
    assert (c.horizon, c.prefill_cap, c.retunes) == (4, 2, 1)
    assert c.holding() is False


def test_sla_controller_tpot_breach_doubles_horizon():
    c = SLAController(SLATarget(p95_tpot_ms=1.0, window=2, max_horizon=16),
                      horizon=4, slots=2)
    for _ in range(2):
        c.observe(_obs(0.0, 50.0))
    assert c.horizon == 8
    for _ in range(4):
        c.observe(_obs(0.0, 50.0))
    assert c.horizon == 16
    assert c.holding() is False


def test_sla_controller_relaxes_toward_deploy_config():
    c = SLAController(SLATarget(p95_ttft_ms=10.0, p95_tpot_ms=100.0, window=1),
                      horizon=8, slots=4)
    c.observe(_obs(50.0, 1.0))
    assert (c.horizon, c.prefill_cap) == (4, 2)
    c.observe(_obs(1.0, 1.0))
    assert (c.horizon, c.prefill_cap) == (8, 2)
    c.observe(_obs(1.0, 1.0))
    assert (c.horizon, c.prefill_cap) == (8, 4)
    assert c.holding() is True
    retunes = c.retunes
    c.observe(_obs(1.0, 1.0))
    assert c.retunes == retunes


def test_deploy_sla_attaches_controller_and_serves(raw_params):
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", slots=2, max_len=16, horizon=4,
                  sla=SLATarget(p95_ttft_ms=60_000.0, p95_tpot_ms=60_000.0, window=2))
    eng = pipe.engine
    assert eng.sla is not None and eng.sla.horizon == 4
    outs = pipe.generate(prompts()[:2], SamplingParams(max_new_tokens=6))
    assert all(o.num_generated == 6 for o in outs)
    assert eng.sla.windows >= 1
    assert eng.sla.holding() is True


def test_sla_prefill_cap_limits_admission_groups(port):
    """A TTFT breach halves the paged prefill-group cap: two same-shaped
    requests then admit in two prefills instead of one."""
    ps = prompts()
    twin = {"src_tokens": ps[0]["src_tokens"][:, ::-1].copy(), "tgt_in": ps[0]["tgt_in"]}
    calls = {}
    for cap in (2, 1):
        eng = engine(port, paged=True, sla=SLATarget(p95_ttft_ms=1e9))
        eng.sla.prefill_cap = cap
        serve(eng, [ps[0], twin], [SamplingParams(**GREEDY8)] * 2)
        calls[cap] = eng.prefill_calls
    assert calls == {2: 1, 1: 2}


# ---------------------------------------------------------------------------
# the engine: metrics snapshot, tracing as a pure observer
# ---------------------------------------------------------------------------

def test_metrics_snapshot_is_complete_and_frozen(port):
    eng = engine(port, slots=1, horizon=4)
    serve(eng, prompts()[:1], [SamplingParams(max_new_tokens=9)])
    m = eng.metrics()
    assert isinstance(m, EngineMetrics)
    assert m.decode_syncs == eng.decode_syncs > 0
    assert m.synced_tokens > 0 and m.occupancy > 0
    assert m.overlap_rounds == eng.overlap_rounds > 0
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.decode_syncs = 0
    assert set(m.as_dict()) == {f.name for f in dataclasses.fields(EngineMetrics)}
    merged = merge_metrics([m, m])
    assert merged.decode_syncs == 2 * m.decode_syncs
    assert merged.occupancy == pytest.approx(m.occupancy)


def test_reset_metrics_zeroes_every_non_gauge_field(port):
    eng = engine(port, slots=1, horizon=4, trace=TraceConfig())
    serve(eng, prompts()[:1], [SamplingParams(max_new_tokens=9)])
    m = eng.metrics()
    assert m.ttft_p50_ms > 0 and m.tpot_p95_ms > 0
    assert m.phase_admit_ms > 0 and m.phase_dispatch_ms > 0 and m.phase_walk_ms > 0
    eng.reset_metrics()
    m = eng.metrics()
    for f in dataclasses.fields(EngineMetrics):
        if f.name not in EngineMetrics.GAUGES:
            assert getattr(m, f.name) == 0, f"{f.name} survived reset_metrics()"
    assert m.kv_cache_bytes > 0
    assert eng.prefill_calls == 0 and eng.decode_s == eng.prefill_s == 0.0


def _run_mode(port, trace, **kw):
    eng = engine(port, trace=TraceConfig() if trace else None, **kw)
    outs = serve(eng, prompts(), [SamplingParams(**GREEDY8), SamplingParams(**SAMPLED6),
                                  SamplingParams(**GREEDY8)])
    return outs, eng


@pytest.mark.parametrize("kw", [dict(horizon=1), dict(horizon=16),
                                dict(horizon=16, paged=True), dict(horizon=4, overlap=False)],
                         ids=["dense-h1", "dense-h16", "paged-h16", "no-overlap"])
def test_traced_equals_untraced(port, kw):
    base, ref_eng = _run_mode(port, False, **kw)
    outs, eng = _run_mode(port, True, **kw)
    assert [(o.token_ids, o.finish_reason) for o in outs] \
        == [(o.token_ids, o.finish_reason) for o in base]
    assert eng.decode_syncs == ref_eng.decode_syncs
    assert eng.overlap_rounds == ref_eng.overlap_rounds
    assert eng.trace.check() == []
    spans = eng.trace.request_spans()
    assert len(spans) == 3 and all(s["closed"] for s in spans.values())


def test_preemption_links_residencies_with_flow(port):
    """Each preemption opens a ``resume`` flow and its resume closes it;
    the trace passes check()."""
    eng = engine(port, paged=True, num_pages=5, preempt_limit=16, trace=TraceConfig())
    serve(eng, five_token_prompts(), [SamplingParams(**GREEDY8)] * 2)
    m = eng.metrics()
    assert m.preemptions >= 1 and m.resumed_requests >= 1
    starts = [e for e in eng.trace.events if e.ph == "s"]
    ends = [e for e in eng.trace.events if e.ph == "f"]
    assert len(starts) == m.preemptions == len(ends)
    assert {e.name for e in starts + ends} == {"resume"}
    assert sorted(e.flow_id for e in starts) == sorted(e.flow_id for e in ends)
    assert eng.trace.check() == []


def test_flow_closed_when_preempted_request_dies_queued(port):
    eng = engine(port, paged=True, num_pages=5, preempt_limit=16, trace=TraceConfig())
    r1 = eng.submit(five_token_prompts()[0], SamplingParams(**GREEDY8))
    r2 = eng.submit(five_token_prompts()[1], SamplingParams(**GREEDY8))
    for _ in range(64):
        if eng.metrics().preemptions:
            break
        eng.step()
    assert eng.metrics().preemptions >= 1 and eng.num_pending == 1
    out = eng.abort(r2)
    assert out.finish_reason == "abort"
    assert [o.request_id for o in eng.run_until_drained()] == [r1]
    assert eng.trace.check() == []
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0


def test_lifecycle_event_order_and_phase_totals(port):
    eng = engine(port, paged=True, horizon=4, trace=TraceConfig())
    serve(eng, prompts()[:2], [SamplingParams(**GREEDY8), SamplingParams(**SAMPLED6)])
    for span in eng.trace.request_spans().values():
        names = span["events"]
        assert names[0] == "queued" and names[1] == "prefill" and names[-1] == "retired"
        assert "decode-round" in names
        assert span["end_us"] >= span["begin_us"]
    sched = [e for e in eng.trace.events if e.tid == SCHED_TID]
    assert any(e.ph == "B" and e.name == "round" for e in sched)
    assert {e.name for e in sched if e.ph == "X"} <= set(PHASES)
    m = eng.metrics()
    assert m.phase_admit_ms > 0 and m.phase_dispatch_ms > 0
    assert m.ttft_p95_ms > 0 and m.tpot_p95_ms > 0
    assert m.ttft_p50_ms <= m.ttft_p95_ms


def test_untraced_engine_reports_zero_phase_time(port):
    eng = engine(port, horizon=4)
    serve(eng, prompts()[:1], [SamplingParams(**GREEDY8)])
    assert eng.trace is None
    m = eng.metrics()
    assert all(getattr(m, f"phase_{p}_ms") == 0.0 for p in PHASES)
    assert m.ttft_p95_ms > 0 and m.tpot_p95_ms > 0


def test_engine_prometheus_export(port):
    eng = engine(port, horizon=4, trace=TraceConfig())
    serve(eng, prompts()[:1], [SamplingParams(**GREEDY8)])
    text = eng.prometheus()
    assert "# TYPE repro_serving_decode_syncs counter" in text
    assert "# TYPE repro_serving_ttft_ms histogram" in text
    assert 'repro_serving_ttft_ms_bucket{le="+Inf"} 1' in text
    for p in PHASES:
        assert f"repro_serving_round_phase_{p}_ms_count" in text
    assert set(eng.latency_histograms()) == {"ttft_ms", "tpot_ms"}


def test_deploy_trace_exposes_tracer(raw_params, tmp_path):
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", slots=2, max_len=16, trace=TraceConfig())
    pipe.generate(prompts()[:1], SamplingParams(max_new_tokens=3))
    assert pipe.tracer is pipe.engine.trace and pipe.tracer.check() == []
    pipe.tracer.dump_json(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_metrics_equal_reference(raw_params, port, layout):
    """Every EngineMetrics counter, ratio and gauge of a port run equals
    the JAX engine's on the same input (times excluded): a paged engine
    under page pressure, or a dense one, horizon 4, overlapped rounds,
    greedy and sampled requests."""
    kw = dict(TIGHT, horizon=4, preempt_limit=16) if layout == "paged" \
        else dict(slots=2, max_len=16, horizon=4)
    sps = [dict(GREEDY8), dict(SAMPLED6, max_new_tokens=8)]
    pipe = j_deploy("nllb600m", "int4", params=raw_params, smoke=True)
    jeng = JServeEngine(pipe.model, pipe.params, ctx=pipe.ctx,
                        kv_dtype=pipe.engine.kv_dtype, **kw)
    jids = [jeng.submit(as_jax(p), JSamplingParams(**sp))
            for p, sp in zip(five_token_prompts(), sps)]
    jouts = {o.request_id: o for o in jeng.run_until_drained()}
    ref = summary(jeng, [jouts[i] for i in jids])
    eng = ServeEngine(port.model, port.params, ctx=port.ctx, kv_dtype=port.engine.kv_dtype,
                      device="cpu", **kw)
    got = summary(eng, serve(eng, five_token_prompts(), [SamplingParams(**sp) for sp in sps]))
    assert got == ref
    if layout == "paged":
        assert got[3]["preemptions"] >= 1 and got[3]["page_utilization"] > 0
