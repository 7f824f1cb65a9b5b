"""Deadlines, bounded admission and fault injection: the port's engine
against the JAX engine on the same weights and inputs (smoke nllb600m,
f32, enc-dec requests; the port's "torch" route bundle against the
reference's "xla" bundle, since these tests check scheduling).

The contract, from the reference's fault tests on enc-dec requests: the
port's FaultPlan logs the reference's events for the same seeds and
rates; under one plan (page exhaustion, a NaN, clock skew past a
deadline) on dense horizon 1, dense horizon 4 and paged horizon 4 the
streams, finish reasons, event log and every EngineMetrics counter but
the times equal the JAX engine's; survivors equal a fault-free run and
casualties are prefixes of it; a NaN fails only its slot; deadlines
expire active and queued requests by skew alone (no sleeps);
EngineSaturated is typed and retryable; the legacy slot-level surface
(add_request / tick / result) serves the reference's streams. The JAX
engines are built once and serve every run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402
from test_torch_paging import as_jax, serve, summary  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving import PageAllocator as JPageAllocator  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.serving import (EngineSaturated, FaultPlan, PageAllocator,  # noqa: E402
                                 SamplingParams, ServeEngine, TraceConfig, deploy,
                                 impl_routes)

LAYOUTS = {"dense1": dict(slots=2, max_len=16, horizon=1),
           "dense4": dict(slots=2, max_len=16, horizon=4),
           "paged4": dict(slots=2, max_len=16, horizon=4, paged=True, page_size=4,
                          num_pages=8)}
DEADLINE_MS = 60_000.0      # far beyond wall time: only the skew expires it
SKEW_MS = 600_000.0
# the reference's random-plan rates (tests/test_faults.py)
RATES = dict(exhaust_prob=0.5, exhaust_pages=4, exhaust_hold=2, nan_prob=0.25,
             skew_prob=0.2, skew_ms=25.0)


def prompts():
    rng = np.random.default_rng(3)
    return [{"src_tokens": rng.integers(16, 256, (1, se)).astype(np.int32),
             "tgt_in": rng.integers(3, 200, (1, 2)).astype(np.int32)}
            for se in (5, 9, 12, 7)]


def chaos_sps(sp_cls):
    """Greedy, sampled, greedy, and greedy with a deadline."""
    return [sp_cls(max_new_tokens=8), sp_cls(temperature=0.8, top_p=0.9, max_new_tokens=8,
                                            seed=7),
            sp_cls(max_new_tokens=8), sp_cls(max_new_tokens=8, deadline_ms=DEADLINE_MS)]


def chaos_plan(plan_cls):
    """Every fault class in one run: steal 4 pages at round 0 for 8
    rounds (paged only), NaN on slot 0 at micro-step 2 of dispatch 0,
    and a skew at round 1 that expires the deadline."""
    return plan_cls(exhaust_at=[(0, 4, 8)], nan_at=[(0, 0, 2)], skew_at=[(1, SKEW_MS)])


def assert_prefix(got, ref):
    assert got == ref[:len(got)], f"{got} is not a prefix of {ref}"


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port(raw_params):
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", **impl_routes("torch"))
    return pipe.model, pipe.params, pipe.ctx, pipe.engine.kv_dtype


def port_engine(port, **kw):
    model, params, ctx, kv = port
    return ServeEngine(model, params, ctx=ctx, kv_dtype=kv, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(raw_params):
    """The JAX engines' runs, each engine built once: the chaos plan per
    layout, then (on the same engines) seeded random plans and the
    legacy slot-level surface."""
    pipe = j_deploy("nllb600m", "int4", params=raw_params, smoke=True)
    out = {}
    engines = {}
    for name, kw in LAYOUTS.items():
        plan = chaos_plan(JFaultPlan)
        eng = JServeEngine(pipe.model, pipe.params, ctx=pipe.ctx,
                           kv_dtype=pipe.engine.kv_dtype, faults=plan, preempt_limit=16,
                           **kw)
        outs = serve(eng, prompts(), chaos_sps(JSamplingParams), jax_side=True)
        out["chaos", name] = summary(eng, outs), list(plan.events)
        if eng.paged:
            plan.release_all(eng)
        engines[name] = eng
    eng = engines["paged4"]
    for seed in (0, 7):
        plan = JFaultPlan(seed=seed, **RATES)
        eng.faults, eng._skew_s = plan, 0.0
        plan.reset()
        eng.reset_metrics()
        outs = serve(eng, prompts()[:3], chaos_sps(JSamplingParams)[:3], jax_side=True)
        out["random", seed] = summary(eng, outs), list(plan.events)
        plan.release_all(eng)
    eng = engines["dense1"]
    eng.faults = None
    out["legacy"] = legacy_run(eng, as_jax)
    return out


def legacy_run(eng, convert):
    """add_request two prompts, tick until both slots finish, read the
    slots' tokens back through result()."""
    ps = [convert(p) for p in prompts()[:2]]
    slots = [eng.add_request(p, 6) for p in ps]
    with pytest.raises(RuntimeError, match="no free slots"):
        eng.add_request(ps[0], 6)
    done = []
    while len(done) < 2:
        done += eng.tick()
    return slots, sorted(done), [list(eng.result(s)) for s in slots]


class _Host:
    """The engine surface a FaultPlan touches: a paged allocator, the
    clock skew and an optional tracer."""

    def __init__(self, allocator):
        self.allocator, self.paged, self.trace, self._skew_s = allocator, True, None, 0.0

    def _now(self):
        return 0.0


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="exhaust_prob"):
        FaultPlan(exhaust_prob=1.5)
    with pytest.raises(ValueError, match="hold"):
        FaultPlan(exhaust_hold=0)
    with pytest.raises(ValueError, match="hold"):
        FaultPlan(exhaust_at=[(2, 4, 0)])


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_fault_plan_events_equal_reference(seed):
    """Same seed and rates, same calls: the same event log, the same
    held pages and the same clock skew as the reference's plan."""
    logs = []
    for plan_cls, alloc_cls in ((JFaultPlan, JPageAllocator), (FaultPlan, PageAllocator)):
        plan = plan_cls(seed=seed, exhaust_at=[(3, 2, 4)], nan_at=[(5, 1, 9)],
                        skew_at=[(2, 5.0)], **RATES)
        host = _Host(alloc_cls(13, reserved=1))
        for _ in range(40):
            plan.on_round(host)
            plan.poison(3, 4)
        logs.append((plan.events, plan.held_pages, host._skew_s))
        plan.release_all(host)
        assert host.allocator.pages_in_use == 0
    assert logs[0] == logs[1]
    assert {e[0] for e in logs[1][0]} == {"exhaust", "release", "nan", "skew"}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chaos_run_equals_reference(port, reference, layout):
    """One plan with every fault class: streams, finish reasons, the event
    log and every counter but the times equal the JAX engine's; survivors
    equal a fault-free run, casualties are prefixes of it; the page pool
    drains clean."""
    kw = LAYOUTS[layout]
    ref = serve(port_engine(port, **kw), prompts(), chaos_sps(SamplingParams))
    plan = chaos_plan(FaultPlan)
    eng = port_engine(port, faults=plan, preempt_limit=16, **kw)
    outs = serve(eng, prompts(), chaos_sps(SamplingParams))       # must not raise
    got = summary(eng, outs)
    assert (got, plan.events) == reference["chaos", layout]
    assert [o.finish_reason for o in outs] == ["error", "length", "length", "deadline"]
    for o, r in zip(outs, ref):
        if o.finish_reason == "length":
            assert o.token_ids == r.token_ids
        else:
            assert_prefix(o.token_ids, r.token_ids)
    m = eng.metrics()
    assert m.slot_errors == 1 and m.deadline_expirations == 1
    if eng.paged:
        assert m.preemptions >= 1 and m.resumed_requests >= 1
        plan.release_all(eng)
        eng.allocator.check()
        assert eng.allocator.pages_in_use == 0


@pytest.mark.parametrize("seed", [0, 7])
def test_random_plan_equals_reference(port, reference, seed):
    """Seeded random rates on the paged engine: the same events, streams
    and counters as the JAX engine; the allocator clean after release."""
    plan = FaultPlan(seed=seed, **RATES)
    eng = port_engine(port, faults=plan, **LAYOUTS["paged4"])
    outs = serve(eng, prompts()[:3], chaos_sps(SamplingParams)[:3])
    assert (summary(eng, outs), plan.events) == reference["random", seed]
    plan.release_all(eng)
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_nan_logits_fail_only_the_offending_slot(port, K, paged):
    """Forced-NaN logits on slot 1 retire only that request, as ``error``
    with a prefix of its clean stream; its groupmate is untouched."""
    kw = dict(slots=2, max_len=16, horizon=K)
    if paged:
        kw.update(paged=True, page_size=4)
    sps = chaos_sps(SamplingParams)[:2]
    ref = serve(port_engine(port, **kw), prompts()[:2], sps)
    eng = port_engine(port, faults=FaultPlan(nan_at=[(0, 1, 2)]), **kw)
    outs = serve(eng, prompts()[:2], sps)
    assert outs[0].finish_reason == "length" and outs[0].token_ids == ref[0].token_ids
    assert outs[1].finish_reason == "error"
    assert 1 <= len(outs[1].token_ids) < len(ref[1].token_ids)
    assert_prefix(outs[1].token_ids, ref[1].token_ids)
    assert eng.metrics().slot_errors == 1
    if paged:
        eng.allocator.check()
        assert eng.allocator.pages_in_use == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_deadline_expires_active_and_queued(port, paged):
    """A skew at round 2 pushes an in-flight and a still-queued request
    past their deadlines, with no sleep: the active one keeps its synced
    prefix, the queued one has none, an undeadlined request is untouched;
    traced, each expiry emits a ``deadline`` instant."""
    kw = dict(slots=1, max_len=16)
    if paged:
        kw.update(paged=True, page_size=4)
    sp = SamplingParams(max_new_tokens=8)
    dl = SamplingParams(max_new_tokens=8, deadline_ms=DEADLINE_MS)
    ref = serve(port_engine(port, **kw), prompts()[:1], [sp])[0]
    eng = port_engine(port, faults=FaultPlan(skew_at=[(2, SKEW_MS)]),
                      trace=TraceConfig(), **kw)
    outs = serve(eng, prompts()[:3], [dl, dl, sp])
    assert [o.finish_reason for o in outs] == ["deadline", "deadline", "length"]
    assert len(outs[0].token_ids) >= 1
    assert_prefix(outs[0].token_ids, ref.token_ids)
    assert outs[1].token_ids == []
    assert eng.metrics().deadline_expirations == eng.deadline_expirations == 2
    names = [e.name for e in eng.trace.events]
    assert names.count("deadline") == 2 and names.count("fault:skew") == 1
    assert eng.trace.check() == []
    if paged:
        eng.allocator.check()
        assert eng.allocator.pages_in_use == 0


def test_engine_saturated_is_typed_and_retryable(port):
    eng = port_engine(port, slots=1, max_len=16, max_pending=1)
    sp = SamplingParams(max_new_tokens=8)
    p1, p2, p3 = prompts()[:3]
    eng.submit(p1, sp)                      # -> the one slot
    eng.submit(p2, sp)                      # -> the one queue seat
    with pytest.raises(EngineSaturated) as ei:
        eng.submit(p3, sp)
    assert isinstance(ei.value, RuntimeError)
    assert ei.value.pending == 1 and ei.value.limit == 1
    assert eng.metrics().admission_rejections == 1
    while eng.num_pending >= 1:             # drain, then retry
        eng.step()
    rid = eng.submit(p3, sp)
    outs = {o.request_id: o for o in eng.run_until_drained()}
    assert outs[rid].finish_reason == "length"
    with pytest.raises(ValueError, match="max_pending"):
        port_engine(port, slots=1, max_len=16, max_pending=0)


def test_fault_counters_reported_and_reset(port):
    """Paged admission waits for the next round, so the fourth submit
    meets max_pending=3; every fault counter reports, then resets. (A
    4-page pool: the steal leaves one free page, too few for growth.)"""
    plan = FaultPlan(nan_at=[(0, 1, 0)], skew_at=[(2, SKEW_MS)], exhaust_at=[(1, 3, 4)])
    eng = port_engine(port, slots=2, max_len=16, paged=True, page_size=4, num_pages=4,
                      max_pending=3, faults=plan)
    sp = SamplingParams(max_new_tokens=8)
    ps = prompts()
    for p, s in zip(ps[:3], [sp, sp, SamplingParams(max_new_tokens=8,
                                                     deadline_ms=DEADLINE_MS)]):
        eng.submit(p, s)
    with pytest.raises(EngineSaturated):
        eng.submit(ps[3], sp)
    eng.run_until_drained()
    m = eng.metrics()
    assert m.preemptions >= 1 and m.deadline_expirations == 1
    assert m.admission_rejections == 1 and m.slot_errors == 1
    eng.reset_metrics()
    m = eng.metrics()
    assert (m.preemptions, m.resumed_requests, m.deadline_expirations,
            m.admission_rejections, m.slot_errors) == (0, 0, 0, 0, 0)
    plan.release_all(eng)
    assert eng.allocator.pages_in_use == 0


def test_deploy_threads_faults_and_max_pending(raw_params):
    """deploy(faults=, max_pending=) reach the engine: the plan is reset
    to round 0 and fires on the served run."""
    plan = FaultPlan(nan_at=[(0, 0, 0)])
    plan.poison(2, 1)                       # a stale call the reset drops
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", slots=2, max_len=16, faults=plan, max_pending=2)
    assert pipe.engine.faults is plan and pipe.engine.max_pending == 2
    outs = pipe.generate(prompts()[:2], SamplingParams(max_new_tokens=4))
    assert [o.finish_reason for o in outs] == ["error", "length"]
    assert plan.events == [("nan", 0, (0, -1))]


def test_legacy_slot_surface_equals_reference(port, reference):
    assert legacy_run(port_engine(port, **LAYOUTS["dense1"]), lambda p: p) \
        == reference["legacy"]


def test_legacy_add_request_refuses_without_pages(port):
    """A paged engine whose pool cannot take the request aborts it and
    raises, leaving nothing queued or allocated."""
    eng = port_engine(port, slots=2, max_len=16, paged=True, page_size=4, num_pages=4)
    eng.allocator.alloc_chain(4)
    with pytest.raises(RuntimeError, match="no free pages"):
        eng.add_request(prompts()[0], 6)
    assert eng.num_pending == 0 and eng.num_active == 0
