"""On-demand paging, preemption and resume: the port's paged engine
against the JAX engine on the same weights and inputs (smoke nllb600m,
f32, enc-dec requests).

A paged engine admits a request with its prefill feed's pages, grows
chains just ahead of every decode horizon, and on exhaustion preempts
the lowest-priority, youngest request, which later resumes by a
teacher-forced prefill replay. These tests check scheduling, not
kernels, so the port runs its "torch" route bundle against the
reference's "xla" bundle (tests/test_torch_serving.py holds the two
equal). The invariants are those of the reference's fault tests, on
enc-dec requests: streams, finish reasons and preemption counters equal
the JAX engine's; resumed streams equal uncontended ones, greedy and
sampled, at horizon 1 and 4; victims go by priority, then age;
preempt_limit=0 retires the victim with a prefix; the allocator is clean
after every drain. Each JAX engine is built once and serves every run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.serving import (PageAllocator, SamplingParams, ServeEngine,  # noqa: E402
                                 deploy, impl_routes, pages_needed)

# engine layouts: the re-anchor's input (3 slots on a 4-page pool) and
# the reference fault tests' contended pool (2 slots on 5 pages)
Q3 = dict(slots=3, max_len=16, paged=True, page_size=4, num_pages=4, horizon=4)
TIGHT = dict(slots=2, max_len=16, paged=True, page_size=4, num_pages=5)
# the re-anchor's six requests: (source, target-prompt) lengths
Q3_LENS = [(5, 1), (9, 1), (12, 2), (6, 1), (7, 3), (4, 1)]


def q3_prompts():
    rng = np.random.default_rng(2)
    out = []
    for se, pl in Q3_LENS:
        src = rng.integers(16, 256, (1, se)).astype(np.int32)
        out.append({"src_tokens": src,
                    "tgt_in": rng.integers(3, 200, (1, pl)).astype(np.int32)})
    return out


def five_token_prompts():
    """Two enc-dec requests with 5-token target prompts: with 8 new
    tokens each needs 4 pages of 4, so a 5-page pool holds one chain."""
    rng = np.random.default_rng(3)
    return [{"src_tokens": rng.integers(16, 256, (1, se)).astype(np.int32),
             "tgt_in": rng.integers(3, 200, (1, 5)).astype(np.int32)}
            for se in (7, 10)]


def sp_kwargs():
    return {"greedy": dict(max_new_tokens=8),
            "sampled": dict(temperature=0.8, top_p=0.9, max_new_tokens=8, seed=7)}


def as_jax(prompt):
    return {k: jnp.asarray(v) for k, v in prompt.items()}


def serve(eng, prompts, sps, *, jax_side=False, horizon=None):
    """Submit in order, drain; outputs in submission order."""
    ids = [eng.submit(as_jax(p) if jax_side else p, sp) for p, sp in zip(prompts, sps)]
    outs = {o.request_id: o for o in eng.run_until_drained(horizon=horizon)}
    return [outs[i] for i in ids]


def summary(eng, outs):
    """What a run must reproduce: streams, finish reasons, per-request
    preemptions and every counter of EngineMetrics but the times."""
    m = eng.metrics().as_dict()
    counters = {k: v for k, v in m.items()
                if not (k.startswith(("ttft_", "tpot_", "phase_")))}
    return ([o.token_ids for o in outs], [o.finish_reason for o in outs],
            [o.stats.preemptions for o in outs], counters)


def assert_clean(eng):
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port(raw_params):
    """The port's quantized model, "torch" bundle: (model, params, ctx,
    the spec's KV dtype)."""
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", **impl_routes("torch"))
    return pipe.model, pipe.params, pipe.ctx, pipe.engine.kv_dtype


def port_engine(port, **kw):
    model, params, ctx, kv = port
    return ServeEngine(model, params, ctx=ctx, kv_dtype=kv, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(raw_params):
    """Every JAX run the tests compare with: two engines, built once."""
    pipe = j_deploy("nllb600m", "int4", params=raw_params, smoke=True)
    model, params, ctx = pipe.model, pipe.params, pipe.ctx
    kv = pipe.engine.kv_dtype
    out = {}
    eng = JServeEngine(model, params, ctx=ctx, kv_dtype=kv, **Q3)
    outs = serve(eng, q3_prompts(), [JSamplingParams(max_new_tokens=10)] * 6,
                 jax_side=True)
    out["q3"] = summary(eng, outs)
    eng.reset_metrics()
    sps = [JSamplingParams(**sp_kwargs()["greedy"]), JSamplingParams(**sp_kwargs()["sampled"])]
    ids = [eng.submit(as_jax(p), sp) for p, sp in zip(five_token_prompts(), sps)]
    eng.step(horizon=1)
    out["side_by_side_active"] = eng.num_active
    by_id = {o.request_id: o for o in eng.run_until_drained(horizon=1)}
    out["side_by_side"] = [by_id[i].token_ids for i in ids]

    eng = JServeEngine(model, params, ctx=ctx, kv_dtype=kv, **TIGHT)
    for kind, kw in sp_kwargs().items():
        for K in (1, 4):
            eng.reset_metrics()
            eng.preempt_limit = 16
            outs = serve(eng, five_token_prompts(), [JSamplingParams(**kw)] * 2,
                         jax_side=True, horizon=K)
            out["tight", kind, K] = summary(eng, outs)
    eng.reset_metrics()
    outs = serve(eng, five_token_prompts(),
                 [JSamplingParams(max_new_tokens=8, priority=0),
                  JSamplingParams(max_new_tokens=8, priority=1)], jax_side=True)
    out["priority"] = summary(eng, outs)
    eng.reset_metrics()
    eng.preempt_limit = 0
    outs = serve(eng, five_token_prompts(), [JSamplingParams(**sp_kwargs()["greedy"])] * 2,
                 jax_side=True)
    out["limit0"] = summary(eng, outs)
    return out


def test_try_alloc_chain_returns_none_on_shortage():
    a = PageAllocator(5, reserved=1)
    assert a.try_alloc_chain(3) == [1, 2, 3]
    assert a.try_alloc_chain(2) is None          # one page left
    assert a.num_free == 1
    with pytest.raises(ValueError):
        a.try_alloc_chain(-1)
    with pytest.raises(MemoryError):
        a.alloc_chain(2)
    a.check()


def test_queue3_input_equals_reference(port, reference):
    """The re-anchor's input: 6 greedy requests on a 4-page pool. The
    reference preempts 14 times and retires request 2 as
    preempted_limit after 1 token; the port does the same, token for
    token and counter for counter."""
    eng = port_engine(port, **Q3)
    outs = serve(eng, q3_prompts(), [SamplingParams(max_new_tokens=10)] * 6)
    got = summary(eng, outs)
    assert got == reference["q3"]
    streams, reasons, _, counters = got
    assert counters["preemptions"] == 14 and counters["resumed_requests"] == 13
    assert reasons[2] == "preempted_limit" and len(streams[2]) == 1
    assert_clean(eng)


def test_queue3_input_schedules_alike_on_the_kernels_bundle(raw_params, reference):
    """deploy()'s default route bundle (the kernels' plain versions on
    the CPU) runs the same paging policy: finish reasons, preemptions and
    every counter equal the reference's."""
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", **Q3)
    outs = pipe.generate(q3_prompts(), SamplingParams(max_new_tokens=10))
    _, reasons, preempts, counters = summary(pipe.engine, outs)
    assert (reasons, preempts, counters) == reference["q3"][1:]
    assert_clean(pipe.engine)


def test_on_demand_admission_beats_whole_budget_reservation(port, reference):
    """Whole budgets would need 4 pages per request (prompt 5 + 8 new
    tokens at page size 4), so a 4-page pool could hold one; on-demand
    admission runs both side by side."""
    assert 2 * pages_needed(5 + 8, 4) > 4
    eng = port_engine(port, **Q3)
    sps = [SamplingParams(**kw) for kw in sp_kwargs().values()]
    ids = [eng.submit(p, sp) for p, sp in zip(five_token_prompts(), sps)]
    eng.step(horizon=1)
    assert eng.num_active == 2 == reference["side_by_side_active"]
    by_id = {o.request_id: o for o in eng.run_until_drained(horizon=1)}
    assert [by_id[i].token_ids for i in ids] == reference["side_by_side"]
    assert_clean(eng)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_preemption_resume_streams_identical(port, reference, K, kind):
    """A 5-page pool cannot hold two full 4-page chains: the younger
    request is evicted mid-decode and resumed by prefill replay. Both
    streams equal an uncontended run's and the JAX engine's, with the
    same preemption counters."""
    sp = SamplingParams(**sp_kwargs()[kind])
    ref_eng = port_engine(port, **dict(TIGHT, num_pages=None))
    uncontended = serve(ref_eng, five_token_prompts(), [sp] * 2, horizon=K)
    eng = port_engine(port, **TIGHT, preempt_limit=16)
    outs = serve(eng, five_token_prompts(), [sp] * 2, horizon=K)
    got = summary(eng, outs)
    assert got == reference["tight", kind, K]
    assert got[3]["preemptions"] >= 1 and got[3]["resumed_requests"] >= 1
    assert [o.token_ids for o in outs] == [o.token_ids for o in uncontended]
    assert all(o.finish_reason == "length" for o in outs)
    assert_clean(eng)
    assert_clean(ref_eng)


def test_preemption_victims_ordered_by_priority_then_age(port, reference):
    """Page pressure evicts the lower-priority request even though it is
    the older one; the high-priority one is never touched."""
    sps = [SamplingParams(max_new_tokens=8, priority=0),
           SamplingParams(max_new_tokens=8, priority=1)]
    eng = port_engine(port, **TIGHT, preempt_limit=16)
    outs = serve(eng, five_token_prompts(), sps)
    assert summary(eng, outs) == reference["priority"]
    assert outs[0].stats.preemptions >= 1
    assert outs[1].stats.preemptions == 0
    uncontended = serve(port_engine(port, **dict(TIGHT, num_pages=None)),
                        five_token_prompts(), sps)
    assert [o.token_ids for o in outs] == [o.token_ids for o in uncontended]
    assert_clean(eng)


def test_preempt_limit_retires_with_partial_prefix(port, reference):
    """preempt_limit=0: the first eviction retires the victim as
    preempted_limit with a prefix of its uncontended stream."""
    sp = SamplingParams(**sp_kwargs()["greedy"])
    eng = port_engine(port, **TIGHT, preempt_limit=0)
    outs = serve(eng, five_token_prompts(), [sp] * 2)
    assert summary(eng, outs) == reference["limit0"]
    assert sorted(o.finish_reason for o in outs) == ["length", "preempted_limit"]
    ref = serve(port_engine(port, **dict(TIGHT, num_pages=None)), five_token_prompts(),
                [sp] * 2)
    for o, r in zip(outs, ref):
        if o.finish_reason == "length":
            assert o.token_ids == r.token_ids
        else:
            assert 1 <= len(o.token_ids) < len(r.token_ids)
            assert o.token_ids == r.token_ids[:len(o.token_ids)]
    assert eng.metrics().resumed_requests == 0
    assert_clean(eng)


def test_preempt_limit_is_validated_and_reaches_the_engine(raw_params):
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", paged=True, preempt_limit=5)
    assert pipe.engine.preempt_limit == 5 and pipe.engine.on_demand
    with pytest.raises(ValueError, match="preempt_limit"):
        ServeEngine(pipe.model, pipe.params, ctx=pipe.ctx, device="cpu", slots=1,
                    max_len=8, preempt_limit=-1)
