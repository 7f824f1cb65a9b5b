"""Overlapped rounds, streaming and abort: the port's engine against the
JAX engine on the same weights and inputs (smoke nllb600m, f32, enc-dec
requests, the port's "torch" route bundle against the reference's "xla"
bundle, since these tests check scheduling).

With ``overlap=True`` (the default) a round dispatches the next horizon
from the in-flight horizon's device carry before the host walks the
previous block. The contract, from the reference's streaming tests:
overlapped and serial rounds emit the same streams, dense and paged, at
horizons 1, 4 and 16, with mid-stream admission, and those streams, the
decode_syncs and the overlap_rounds equal the JAX engine's; streaming
delivery (``on_token``, ``stream_request``, ``stream(on_round=)``) sees
exactly the drained tokens; ``abort`` works from the request's own
callback and from a groupmate's and frees its pages; an overlapped block
is never swallowed by a new occupant of its slot; the legacy wrappers
warn. The JAX engines are built once per layout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402
from test_torch_paging import as_jax  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.serving import (SamplingParams, ServeEngine, deploy,  # noqa: E402
                                 greedy_generate, impl_routes, translate)

LAYOUTS = {"dense": dict(slots=2, max_len=16),
           "paged": dict(slots=2, max_len=16, paged=True, page_size=4)}
HORIZONS = (1, 4, 16)


def prompts():
    rng = np.random.default_rng(5)
    return [{"src_tokens": rng.integers(16, 256, (1, se)).astype(np.int32),
             "tgt_in": rng.integers(3, 200, (1, pl)).astype(np.int32)}
            for se, pl in ((5, 1), (9, 2), (6, 1))]


MIXED = [dict(max_new_tokens=9),
         dict(temperature=0.8, top_p=0.9, max_new_tokens=7, seed=3),
         dict(max_new_tokens=12)]
# asymmetric budgets: the short request retires inside a horizon and its
# slot refills while the block dispatched for the old occupant is in flight
SWALLOW = [dict(max_new_tokens=12), dict(max_new_tokens=3), dict(max_new_tokens=12)]


def mid_stream(eng, sp_cls, K, convert=lambda p: p, sps=MIXED):
    """One request, one round, then two more join (the third queues
    behind two slots); outputs in submission order."""
    ps = [convert(p) for p in prompts()]
    ids = [eng.submit(ps[0], sp_cls(**sps[0]))]
    outs = eng.step(horizon=K)
    ids += [eng.submit(p, sp_cls(**kw)) for p, kw in zip(ps[1:], sps[1:])]
    outs += eng.run_until_drained(horizon=K)
    by_id = {o.request_id: o for o in outs}
    return [by_id[i] for i in ids]


def record(eng, outs):
    return ([o.token_ids for o in outs], [o.finish_reason for o in outs],
            eng.metrics().decode_syncs, eng.metrics().overlap_rounds)


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port(raw_params):
    pipe = deploy("nllb600m", "int4", params=jax_to_torch(raw_params), smoke=True,
                  device="cpu", **impl_routes("torch"))
    return pipe


def port_engine(pipe, **kw):
    return ServeEngine(pipe.model, pipe.params, ctx=pipe.ctx, kv_dtype=pipe.engine.kv_dtype,
                       device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(raw_params):
    """JAX runs per layout, horizon and overlap, on one engine a layout
    (overlap is a plain attribute of the reference engine)."""
    pipe = j_deploy("nllb600m", "int4", params=raw_params, smoke=True)
    out = {}
    for name, kw in LAYOUTS.items():
        eng = JServeEngine(pipe.model, pipe.params, ctx=pipe.ctx,
                           kv_dtype=pipe.engine.kv_dtype, **kw)
        for K in HORIZONS:
            for overlap in (True, False):
                eng.overlap = overlap
                eng.reset_metrics()
                out[name, K, overlap] = record(eng, mid_stream(eng, JSamplingParams, K,
                                                               as_jax))
        if name == "dense":
            eng.overlap = True
            eng.reset_metrics()
            out["swallow"] = record(eng, mid_stream(eng, JSamplingParams, 4, as_jax,
                                                    SWALLOW))
    return out


@pytest.mark.parametrize("K", HORIZONS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_overlap_equals_serial_and_reference(port, reference, layout, K):
    """Overlapped and serial rounds give the same streams, which equal
    the JAX engine's; decode_syncs and overlap_rounds equal the JAX
    engine's in both modes."""
    got = {}
    for overlap in (True, False):
        eng = port_engine(port, overlap=overlap, **LAYOUTS[layout])
        got[overlap] = record(eng, mid_stream(eng, SamplingParams, K))
        assert got[overlap] == reference[layout, K, overlap]
        if eng.paged:
            eng.allocator.check()
            assert eng.allocator.pages_in_use == 0
    assert got[True][:2] == got[False][:2]
    assert got[False][3] == 0
    if K == 4:      # 8 decode tokens over 4-step horizons run ahead
        assert got[True][3] > 0


def test_overlapped_block_not_swallowed_by_new_occupant(port, reference):
    """A short request retires inside a horizon and its slot refills
    while the block dispatched for the old occupant is in flight; the
    new occupant must not take that block's rows. Two slots give the
    streams of three, and of the JAX engine."""
    ref = record(e := port_engine(port, slots=3, max_len=16),
                 mid_stream(e, SamplingParams, 4, sps=SWALLOW))
    eng = port_engine(port, **LAYOUTS["dense"])
    got = record(eng, mid_stream(eng, SamplingParams, 4, sps=SWALLOW))
    assert got == reference["swallow"]
    assert got[:2] == ref[:2]
    assert got[3] > 0


def test_overlap_sync_counts_match_serial(port):
    """A dead dispatched-ahead block is dropped without a wait, so
    overlapped and serial engines count the same syncs."""
    def syncs(overlap):
        eng = port_engine(port, slots=1, max_len=16, horizon=4, overlap=overlap)
        eng.submit(prompts()[0], SamplingParams(max_new_tokens=9))
        eng.run_until_drained()
        return eng.decode_syncs

    assert syncs(True) == syncs(False) == 2


def test_on_token_callback_sees_every_token(port):
    eng = port_engine(port, slots=1, max_len=16, horizon=4)
    live = []
    rid = eng.submit(prompts()[0], SamplingParams(max_new_tokens=7), on_token=live.append)
    out = {o.request_id: o for o in eng.run_until_drained()}[rid]
    assert live == out.token_ids and len(live) == 7
    assert out.ttft_ms > 0.0 and out.tpot_ms > 0.0
    assert out.stats.ttft_s <= out.stats.total_s


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stream_request_tokens_match_drained_output(port, layout):
    """stream_request yields exactly the finished output's tokens and
    returns it; the other in-flight request stays claimable."""
    sp = SamplingParams(max_new_tokens=6)
    p1, p2 = prompts()[:2]
    ref_eng = port_engine(port, horizon=4, **LAYOUTS[layout])
    ids = [ref_eng.submit(p1, sp), ref_eng.submit(p2, sp)]
    refs = {o.request_id: o for o in ref_eng.run_until_drained()}
    eng = port_engine(port, horizon=4, **LAYOUTS[layout])
    other = eng.submit(p2, sp)
    gen = eng.stream_request(p1, sp)
    toks = []
    while True:
        try:
            toks.append(next(gen))
        except StopIteration as fin:
            out = fin.value
            break
    assert toks == out.token_ids == refs[ids[0]].token_ids
    assert out.finish_reason == "length"
    rest = eng.run_until_drained()
    assert [o.request_id for o in rest] == [other]
    assert rest[0].token_ids == refs[ids[1]].token_ids


def test_stream_yields_per_finish_and_on_round_admission(port):
    """stream() yields each output as it retires; arrivals submitted from
    on_round keep the loop alive; a drained engine never calls it."""
    eng = port_engine(port, slots=2, max_len=16, horizon=4)
    p1, p2 = prompts()[:2]
    sp = SamplingParams(max_new_tokens=5)
    ids = [eng.submit(p1, sp)]

    def on_round():
        if len(ids) == 1:
            ids.append(eng.submit(p2, sp))

    outs = list(eng.stream(on_round=on_round))
    assert sorted(o.request_id for o in outs) == sorted(ids) and len(ids) == 2
    calls = []
    assert list(eng.stream(on_round=lambda: calls.append(1))) == []
    assert calls == []


def test_abort_from_own_on_token_callback(port):
    """A request aborts itself from its callback mid-walk: its tokens
    stop at the callback's position, abort() hands the output to the
    callback, and the engine keeps serving."""
    eng = port_engine(port, slots=1, max_len=16, horizon=4)
    seen, got = [], []

    def cb(tok):
        seen.append(tok)
        if len(seen) == 3:
            got.append(eng.abort(rid))

    rid = eng.submit(prompts()[0], SamplingParams(max_new_tokens=12), on_token=cb)
    assert eng.run_until_drained() == []
    out = got[0]
    assert out.finish_reason == "abort"
    assert out.token_ids == seen and len(seen) == 3 and out.stats.new_tokens == 3
    rid2 = eng.submit(prompts()[0], SamplingParams(max_new_tokens=4))
    outs = eng.run_until_drained()
    assert [o.request_id for o in outs] == [rid2] and outs[0].num_generated == 4


def test_abort_groupmate_from_first_token_callback(port):
    """Aborting a request still inside the batched admission group (from
    a groupmate's first-token callback) retires it and frees its pages;
    the survivor's stream is unaffected."""
    sp = SamplingParams(max_new_tokens=8)
    ps = prompts()
    # two requests with one source length form one admission group
    p2 = {"src_tokens": ps[0]["src_tokens"][:, ::-1].copy(), "tgt_in": np.array([[42]], np.int32)}
    ref_eng = port_engine(port, **LAYOUTS["paged"])
    rid = ref_eng.submit(ps[0], sp)
    ref = {o.request_id: o for o in ref_eng.run_until_drained()}[rid]
    eng = port_engine(port, **LAYOUTS["paged"])
    state = {}

    def cb(tok):
        if "aborted" not in state:
            state["aborted"] = eng.abort(state["victim"])

    rid = eng.submit(ps[0], sp, on_token=cb)
    state["victim"] = eng.submit(p2, sp)
    outs = {o.request_id: o for o in eng.run_until_drained()}
    assert eng.prefill_calls == 1
    assert state["aborted"].finish_reason == "abort"
    assert state["victim"] not in outs
    assert outs[rid].token_ids == ref.token_ids
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0
    assert eng.abort(state["victim"]) is None


def test_abort_queued_and_unknown(port):
    eng = port_engine(port, **LAYOUTS["paged"])
    rid = eng.submit(prompts()[0], SamplingParams(max_new_tokens=4))
    out = eng.abort(rid)
    assert out.finish_reason == "abort" and out.token_ids == []
    assert eng.abort(rid) is None and eng.abort(12345) is None
    assert eng.run_until_drained() == []


def test_streaming_pipeline_surface(port):
    """translate_stream / generate_stream stream one row and return its
    output; the dense engine admits at submit."""
    pipe = port
    src = prompts()[0]["src_tokens"][0]
    gen = pipe.translate_stream(src, "ita", SamplingParams(max_new_tokens=5))
    toks = []
    while True:
        try:
            toks.append(next(gen))
        except StopIteration as fin:
            out = fin.value
            break
    assert toks == out.token_ids and len(toks) == 5
    assert pipe.translate(src, "ita", SamplingParams(max_new_tokens=5))[0].token_ids == toks
    with pytest.raises(ValueError, match="one source row"):
        next(pipe.translate_stream(np.stack([src, src]), "ita"))
    with pytest.raises(TypeError):
        pipe.generate_stream([1, 2, 3])
    eng = pipe.engine
    eng.submit(prompts()[0], SamplingParams(max_new_tokens=3))
    assert eng.num_active == 1 and eng.num_pending == 0      # admitted at submit
    eng.run_until_drained()


def test_legacy_wrappers_warn_deprecation(port):
    model, params, ctx = port.model, port.params, port.ctx
    src = prompts()[0]["src_tokens"]
    with pytest.warns(DeprecationWarning, match="greedy_generate"):
        toks, _ = greedy_generate(model, ctx, params,
                                  {"src_tokens": src, "tgt_in": np.array([[8]], np.int32)},
                                  steps=3, max_len=8, device="cpu")
    with pytest.warns(DeprecationWarning, match="translate") as rec:
        toks2 = translate(model, ctx, params, src, 8, steps=3, device="cpu")
    assert len([w for w in rec.list if issubclass(w.category, DeprecationWarning)]) == 1
    assert toks.tolist() == toks2.tolist()
    assert toks.shape == (1, 3)
    with pytest.raises(ValueError, match="max_len"):
        with pytest.warns(DeprecationWarning):
            translate(model, ctx, params, src, 8, steps=8, max_len=4, device="cpu")
