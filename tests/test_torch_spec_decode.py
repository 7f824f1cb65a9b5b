"""Quantized-draft speculative decoding: the port's draft arm, verify and
rollback against the JAX engine and against its own target-only decode
(smoke nllb600m, f32, enc-dec requests, JAX-initialised weights).

The contract, from the reference's speculative tests on enc-dec
requests: ``accept_longest_prefix`` equals the JAX function; greedy
speculative streams equal target-only streams, dense and paged, for
4-bit drafts (an identical draft accepts everything); the port's
speculative engine equals the JAX one in streams and in every counter
but the times (verify_calls, drafted, accepted, ...); EOS mid-block,
sampled fallback and abort behave; act-quantizing and fp8-KV drafts
decode speculatively too. The JAX speculative engines are built once.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402
from test_torch_paging import summary  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving.spec_decode import \
    accept_longest_prefix as j_accept_longest_prefix  # noqa: E402
from repro_torch.serving import (DraftArm, SamplingParams, TraceConfig,  # noqa: E402
                                 accept_longest_prefix, deploy, impl_routes)

LAYOUTS = {"dense": dict(slots=3, max_len=16),
           "paged": dict(slots=3, max_len=16, paged=True, page_size=4)}
DRAFTS = ["int4", "fp4", "nf4"]
GEN = 8


def prompts():
    rng = np.random.default_rng(0)
    return [{"src_tokens": rng.integers(16, 256, (1, n)).astype(np.int32),
             "tgt_in": np.full((1, 1), c, np.int32)}
            for n, c in zip([5, 9, 12, 5, 7], [8, 1, 7, 9, 2])]


def same_shape_prompts():
    """Five requests of one source length: one prefill shape, so the JAX
    engines compile one prefill per arm."""
    rng = np.random.default_rng(1)
    return [{"src_tokens": rng.integers(16, 256, (1, 6)).astype(np.int32),
             "tgt_in": np.full((1, 1), c, np.int32)} for c in (8, 1, 7, 9, 2)]


def as_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(raw_params):
    return jax_to_torch(raw_params)


def port_pipe(torch_params, layout, **kw):
    return deploy("nllb600m", "int4", params=torch_params, smoke=True, device="cpu",
                  **LAYOUTS[layout], **impl_routes("torch"), **kw)


@pytest.fixture(scope="module")
def target_only(torch_params):
    """The port's target-only greedy streams per layout (horizon 4)."""
    return {layout: [o.token_ids for o in port_pipe(torch_params, layout, horizon=4)
                     .generate(prompts(), SamplingParams(max_new_tokens=GEN))]
            for layout in LAYOUTS}


@pytest.fixture(scope="module")
def reference(raw_params):
    """The JAX speculative engines' runs: an nf4 draft, dense and paged."""
    out = {}
    for layout in LAYOUTS:
        pipe = j_deploy("nllb600m", "int4", params=raw_params, smoke=True,
                        draft_spec="nf4", **LAYOUTS[layout])
        outs = pipe.generate([as_jax(p) for p in same_shape_prompts()],
                             JSamplingParams(max_new_tokens=GEN))
        out[layout] = summary(pipe.engine, outs)
    return out


# -- the acceptance rule ------------------------------------------------------

def _both(draft, target, alive):
    got = accept_longest_prefix(torch.tensor(draft, dtype=torch.int32),
                                torch.tensor(target, dtype=torch.int32),
                                torch.tensor(alive, dtype=torch.int32))
    ref = j_accept_longest_prefix(np.asarray(draft, np.int32), np.asarray(target, np.int32),
                                  np.asarray(alive, np.int32))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return [g.tolist() for g in got]


def test_accept_all_match():
    d = [[5, 6], [7, 8], [9, 10]]
    out, n_emit, acc, cur = _both(d, d, [1, 1])
    assert out == d and n_emit == [3, 3] and acc == [3, 3] and cur == [9, 10]


def test_first_token_reject_emits_target():
    out, n_emit, acc, cur = _both([[5], [6], [7]], [[4], [6], [7]], [1])
    assert [r[0] for r in out] == [4, 0, 0] and n_emit == [1] and acc == [0] and cur == [4]


def test_mid_block_divergence():
    out, n_emit, acc, cur = _both([[5], [6], [7], [8]], [[5], [6], [9], [8]], [1])
    assert [r[0] for r in out] == [5, 6, 9, 0] and n_emit == [3] and acc == [2]
    assert cur == [9]


def test_dead_slot_emits_pad():
    out, n_emit, acc, _ = _both([[5, 5], [6, 6]], [[5, 5], [6, 6]], [1, 0])
    assert [r[1] for r in out] == [0, 0] and acc == [2, 0] and n_emit[0] == 2


@pytest.mark.parametrize("seed", range(6))
def test_accept_random_blocks_equal_reference(seed):
    """Seeded random blocks (few symbols, so prefixes match often)."""
    rng = np.random.default_rng(seed)
    K, S = int(rng.integers(1, 7)), int(rng.integers(1, 9))
    draft = rng.integers(0, 3, (K, S))
    target = np.where(rng.random((K, S)) < 0.7, draft, rng.integers(0, 3, (K, S)))
    _both(draft, target, rng.integers(0, 2, S))


def test_draft_arm_validation(torch_params):
    pipe = port_pipe(torch_params, "dense", draft_spec="nf4", draft_lookahead=3)
    arm = pipe.engine.draft
    assert isinstance(arm, DraftArm) and arm.lookahead == 3 and arm.kv_dtype == "int8"
    assert pipe.draft_spec_str == "wnf4kv8dq" and pipe.spec_str == "w4kv8"
    assert arm.params is not pipe.params
    with pytest.raises(ValueError, match="lookahead"):
        DraftArm(params=arm.params, ctx=arm.ctx, spec=arm.spec, kv_dtype="int8",
                 lookahead=0)


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_spec_equals_target_only(torch_params, target_only, layout, draft):
    """Whatever the draft spec, greedy speculative streams are the
    target-only streams; an int4 draft of an int4 target is the target,
    so it accepts every drafted token."""
    pipe = port_pipe(torch_params, layout, draft_spec=draft)
    outs = pipe.generate(prompts(), SamplingParams(max_new_tokens=GEN))
    assert [o.token_ids for o in outs] == target_only[layout]
    m = pipe.engine.metrics()
    assert m.verify_calls > 0 and m.drafted_tokens == m.accepted_tokens + m.rejected_tokens
    assert sum(o.stats.drafted for o in outs) == m.drafted_tokens
    if draft == "int4":
        assert m.acceptance_rate == 1.0
    if pipe.engine.paged:
        pipe.engine.allocator.check()
        assert pipe.engine.allocator.pages_in_use == 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_engine_equals_reference(torch_params, reference, layout):
    """Streams, finish reasons and every counter but the times
    (verify_calls, drafted / accepted / rejected tokens, decode steps and
    syncs, occupancy, kv_cache_bytes with the draft cache) equal the JAX
    speculative engine's."""
    pipe = port_pipe(torch_params, layout, draft_spec="nf4")
    outs = pipe.generate(same_shape_prompts(), SamplingParams(max_new_tokens=GEN))
    got = summary(pipe.engine, outs)
    assert got == reference[layout]
    assert got[3]["verify_calls"] > 0 and 0 < got[3]["acceptance_rate"] < 1


# the int4 draft (the target itself) keeps the ids the layouts alone gave
BUDGET_CASES = [pytest.param(layout, draft, id=layout if draft == "int4" else
                             f"{layout}-{draft}")
                for draft in ("int4", "nf4") for layout in LAYOUTS]


@pytest.mark.parametrize("layout, draft", BUDGET_CASES)
def test_spec_budget_up_to_max_len(torch_params, target_only, layout, draft):
    """A request whose budget fills max_len, joined late by others: in
    its last rounds K follows the newcomers' budgets, so it drafts past
    its own budget and past the cache's end; those positions roll back,
    and every stream is the target-only one. An int4 draft accepts every
    token; an nf4 draft rejects, so a slot may survive such a round and
    must attend only kept positions afterwards."""
    max_len = LAYOUTS[layout]["max_len"]
    full = SamplingParams(max_new_tokens=max_len - 1)
    ref = port_pipe(torch_params, layout).generate(prompts()[:1], full)[0].token_ids
    pipe = port_pipe(torch_params, layout, draft_spec=draft)
    eng = pipe.engine
    first = eng.submit(prompts()[0], full)
    while not eng.num_active or len(eng.slots[0].tokens) < max_len - 4:
        eng.step()
    late = [eng.submit(p, SamplingParams(max_new_tokens=GEN)) for p in prompts()[1:3]]
    outs = {o.request_id: o.token_ids for o in eng.run_until_drained()}
    assert outs[first] == ref
    assert [outs[i] for i in late] == target_only[layout][1:3]
    m = eng.metrics()
    if draft == "int4":
        assert m.acceptance_rate == 1.0
    else:
        assert m.rejected_tokens > 0


@pytest.mark.parametrize("length, page", [(0, 0), (5, 1), (15, 3), (16, None), (19, None)])
def test_paged_view_sends_writes_past_the_chain_to_trash(length, page):
    """A paged write lands on the slot's page at len // ps; at or past the
    chain's end (a speculative round drafting past max_len) it lands on
    the trash page, never on a kept position of the last page."""
    from repro_torch.models.transformer import paged_view
    chain = [3, 4, 5, 6]
    cache = {"block_tables": torch.tensor([chain], dtype=torch.int32),
             "len": torch.tensor([length], dtype=torch.int32),
             "active": torch.ones(1, dtype=torch.int32),
             "k": torch.zeros(1, 8, 4, 1, 1)}
    _, pid, off = paged_view(cache)
    assert int(pid[0]) == (0 if page is None else chain[page])
    if page is not None:
        assert int(off[0]) == length % 4


def test_paged_decode_past_the_chain_end_keeps_the_chain(torch_params):
    """A decode step of a slot whose length fills its chain, in the
    target's and the draft's cache, leaves every page of the chain as it
    was."""
    pipe = port_pipe(torch_params, "paged", draft_spec="nf4")
    eng = pipe.engine
    eng.submit(prompts()[0], SamplingParams(max_new_tokens=LAYOUTS["paged"]["max_len"] - 1))
    eng.step()
    ps = LAYOUTS["paged"]["page_size"]
    for cache, params, ctx in ((eng.cache, pipe.params, pipe.ctx),
                               (eng.draft_cache, eng.draft.params, eng.draft.ctx)):
        chain = cache["block_tables"][0].long()
        pools = [k for k in ("k", "v", "k_codes", "k_scales", "v_codes", "v_scales")
                 if k in cache]
        before = {k: cache[k][:, chain].clone() for k in pools}
        full = dict(cache, len=torch.where(cache["active"] > 0, chain.numel() * ps,
                                           cache["len"]).to(cache["len"].dtype))
        with torch.no_grad():
            pipe.model.decode_step(ctx, params, eng.cur, full)
        for k in pools:
            assert torch.equal(cache[k][:, chain], before[k]), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_eos_mid_block(torch_params, target_only, layout):
    """An EOS inside an accepted block retires the slot there, as in
    target-only decoding."""
    stream = target_only[layout][1]
    eos = stream[3]
    cut = stream.index(eos) + 1
    pipe = port_pipe(torch_params, layout, draft_spec="int4")
    out = pipe.generate([prompts()[1]], SamplingParams(max_new_tokens=GEN, eos_id=eos))[0]
    assert out.finish_reason == "eos" and out.token_ids == stream[:cut]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampled_requests_fall_back_to_target_only(torch_params, layout):
    """A sampled request in the batch sends its rounds down the
    target-only path: every stream equals target-only decoding, and the
    greedy tail after the short sampled requests retire speculates."""
    sps = [SamplingParams(max_new_tokens=3, temperature=0.8, top_p=0.9, seed=i)
           if i % 2 else SamplingParams(max_new_tokens=GEN) for i in range(5)]

    def run(**kw):
        pipe = port_pipe(torch_params, layout, **kw)
        ids = [pipe.engine.submit(p, sp) for p, sp in zip(prompts(), sps)]
        by_id = {o.request_id: o for o in pipe.engine.run_until_drained()}
        return [by_id[i].token_ids for i in ids], pipe.engine

    ref, _ = run()
    got, eng = run(draft_spec="fp4")
    assert got == ref
    assert eng.verify_calls > 0     # the all-greedy tail still speculates


def test_paged_abort_frees_both_chains_once(torch_params):
    """A draft-armed paged engine reserves two whole-budget chains per
    request; an abort frees both, once, and a second abort is a no-op."""
    pipe = port_pipe(torch_params, "paged", draft_spec="nf4")
    eng = pipe.engine
    assert not eng.on_demand
    rid = eng.submit(prompts()[0], SamplingParams(max_new_tokens=GEN))
    eng.step()
    per_arm = -(-(1 + GEN) // 4)
    assert eng.allocator.pages_in_use == 2 * per_arm
    out = eng.abort(rid)
    assert out.finish_reason == "abort" and eng.abort(rid) is None
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0
    assert int(eng.draft_cache["active"].sum()) == 0


@pytest.mark.parametrize("draft_spec", ["wfp4a8", "w4a8kv8", "w4kvfp8"])
def test_act_quantizing_or_fp8_kv_draft_raises(torch_params, target_only, draft_spec):
    """Act-quantizing and fp8-KV draft arms are ported: they no longer
    raise, and greedy speculative decoding with them equals target-only
    decoding (an uncalibrated act-quantizing draft warns and quantizes
    dynamically)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe = port_pipe(torch_params, "paged", draft_spec=draft_spec)
    assert any("dynamic per-token" in str(w.message) for w in caught) == \
        ("a" in draft_spec[2:])
    d = pipe.engine.draft
    assert d.ctx.act_fmt == d.spec.act and d.kv_dtype == d.spec.kv
    if d.kv_dtype == "fp8":
        assert pipe.engine.draft_cache["k"].dtype == torch.float8_e4m3fn
    outs = pipe.generate(prompts(), SamplingParams(max_new_tokens=GEN))
    assert [o.token_ids for o in outs] == target_only["paged"]
    assert pipe.engine.metrics().verify_calls > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_traced_spec_engine_equals_untraced(torch_params, target_only, layout):
    """Tracing observes speculative rounds without changing them: one
    ``verify`` instant per live slot a round, and a clean trace."""
    pipe = port_pipe(torch_params, layout, draft_spec="fp4", trace=TraceConfig())
    outs = pipe.generate(prompts(), SamplingParams(max_new_tokens=GEN))
    assert [o.token_ids for o in outs] == target_only[layout]
    verifies = [e for e in pipe.tracer.events if e.name == "verify"]
    assert sum(e.args["drafted"] for e in verifies) == pipe.engine.metrics().drafted_tokens
    assert pipe.tracer.check() == []
