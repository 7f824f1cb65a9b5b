"""The arms that read a clock under a mesh, on gloo CPU ranks, against the
JAX single-device engine.

Under ``deploy(mesh=tp_mesh(K))`` every rank runs the scheduler and the
ranks' clocks differ, so a deadline expiry or an SLA retune is rank 0's:
each round boundary broadcasts rank 0's decisions (the control channel,
``serving.engine``) and every rank applies them there. The reduced
nllb600m int4 on the reference's key-0 weights, f32, the port's "torch"
bundle against the reference's "xla" bundle (these tests check
scheduling), paged on 2 slots over 8 pages of 4, horizon 4, as
tests/test_torch_faults.py's "paged4" layout. One 2-rank spawn serves:

* tests/test_torch_faults.py's chaos plan (a steal forcing preemptions, a
  NaN on one slot, a skew expiring a deadlined request) with
  ``max_pending=4`` refusing a fifth submit: every rank's streams, finish
  reasons, events and counters equal the JAX engine's under the same
  plan, and every rank's pool is clean after ``release_all``;
* a deadline of 1 ns (``NOW_MS``; a budget must be positive, so this
  stands for ``deadline_ms=0``) on two requests: they expire at the
  first boundary on every rank, the others serve the JAX engine's
  streams;
* a TINY p95 TTFT target with a window of 2 (every window halves the
  horizon and the prefill cap), then a HUGE one (every window relaxes):
  every rank's ``(horizon, prefill_cap, retunes, windows)`` is equal after
  every round, and the streams are the JAX engine's;
* no cost unarmed: an engine with no clock-driven arm broadcasts nothing;
  an armed one (an empty FaultPlan) broadcasts once a round boundary, and
  both sum alike;
* clocks that disagree, rank 1's alone patched where the engine module
  reads it: jumped an hour past every 10-minute budget after the submits,
  or run 10^6 times fast under a target between the two ranks' TTFTs.
  Both ranks take rank 0's decisions (nothing expires, nothing retunes)
  and serve the clean streams.

One 4-rank spawn serves ``deploy_replicas(..., replicas=2, tp=2)`` under a
TINY target with a 1 ns deadline on two requests, every request
submitted with ``on_token``: every rank returns the same outputs, the
survivors' streams are the JAX engine's, every rank's callback streams
equal the drained ``token_ids`` and each first token reaches every rank
in an earlier round than its request's finish; a metrics snapshot that
every rank refreshes once a round, served on rank 0 and scraped over
HTTP mid-stream, carries both replicas' labels and synced tokens.

The spawns bound every collective at CLOCK_TIMEOUT_S, so ranks whose
schedules part fail instead of hanging.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_torch_paging import serve  # noqa: E402
from torch_tp_ranks import (CLOCK_KW, DEADLINE_MS, FAST_TTFT_MS, SKEW_MS,  # noqa: E402
                            clock_grid, stack_clock)

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import EngineSaturated as JEngineSaturated  # noqa: E402
from repro.serving import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.cluster import launch_ranks  # noqa: E402
from repro_torch.serving import SamplingParams  # noqa: E402

CLOCK_TIMEOUT_S = 180.0
ZERO = (1, 2)       # the requests served with a NOW_MS deadline


def prompts():
    """tests/test_torch_faults.py's four prompts, then two more."""
    rng = np.random.default_rng(3)
    return [{"src_tokens": rng.integers(16, 256, (1, se)).astype(np.int32),
             "tgt_in": rng.integers(3, 200, (1, 2)).astype(np.int32)}
            for se in (5, 9, 12, 7, 10, 6)]


def sps(sp_cls):
    """tests/test_torch_faults.py's chaos requests (greedy, sampled,
    greedy, greedy with a DEADLINE_MS budget), then a sampled and a
    greedy one."""
    return [sp_cls(max_new_tokens=8),
            sp_cls(temperature=0.8, top_p=0.9, max_new_tokens=8, seed=7),
            sp_cls(max_new_tokens=8), sp_cls(max_new_tokens=8, deadline_ms=DEADLINE_MS),
            sp_cls(temperature=0.7, top_k=8, max_new_tokens=8, seed=3),
            sp_cls(max_new_tokens=8)]


def counters(m: dict) -> dict:
    """Every EngineMetrics counter but the times and the KV bytes (a
    rank holds its shard of the pool)."""
    return {k: v for k, v in m.items()
            if not k.startswith(("ttft_", "tpot_", "phase_")) and k != "kv_cache_bytes"}


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def reference(raw_params):
    """One JAX engine of CLOCK_KW: the chaos plan with max_pending=4 and a
    refused fifth submit, then (plan and bound taken off) every request's
    clean stream."""
    pipe = j_deploy("nllb600m", "int4", params=raw_params, smoke=True)
    plan = JFaultPlan(exhaust_at=[(0, 4, 8)], nan_at=[(0, 0, 2)], skew_at=[(1, SKEW_MS)])
    eng = JServeEngine(pipe.model, pipe.params, ctx=pipe.ctx, kv_dtype=pipe.engine.kv_dtype,
                       faults=plan, preempt_limit=16, max_pending=4, **CLOCK_KW)
    ps, js = prompts(), sps(JSamplingParams)
    ids = [eng.submit({k: jax.numpy.asarray(v) for k, v in p.items()}, sp)
           for p, sp in zip(ps[:4], js)]
    with pytest.raises(JEngineSaturated):
        eng.submit({k: jax.numpy.asarray(v) for k, v in ps[4].items()}, js[0])
    outs = {o.request_id: o for o in eng.run_until_drained()}
    chaos = {"served": [(list(outs[i].token_ids), outs[i].finish_reason) for i in ids],
             "preempted": [outs[i].stats.preemptions for i in ids],
             "metrics": counters(eng.metrics().as_dict()), "events": list(plan.events)}
    plan.release_all(eng)
    eng.faults, eng.max_pending, eng._skew_s = None, None, 0.0
    clean = serve(eng, ps, js, jax_side=True)
    assert all(o.finish_reason == "length" for o in clean)
    return {"chaos": chaos, "clean": [list(o.token_ids) for o in clean]}


@pytest.fixture(scope="module")
def ranks(raw_params, tmp_path_factory):
    """The 2-rank spawn (clock_grid) and the 4-rank one (stack_clock)."""
    tmp = str(tmp_path_factory.mktemp("tp_clock"))
    params = jax_tree_to_numpy(raw_params)
    ps, ts = prompts(), sps(SamplingParams)
    return {2: launch_ranks(clock_grid, 2, device="cpu", tmpdir=tmp, timeout=CLOCK_TIMEOUT_S,
                            args=(params, ps, ts)),
            4: launch_ranks(stack_clock, 4, device="cpu", tmpdir=tmp, timeout=CLOCK_TIMEOUT_S,
                            args=(params, ps, ts, ZERO))}


def test_chaos_plan_equals_jax_single_device(ranks, reference):
    want = reference["chaos"]
    assert [r for _, r in want["served"]] == ["error", "length", "length", "deadline"]
    assert want["metrics"]["preemptions"] >= 1
    assert (want["metrics"]["slot_errors"], want["metrics"]["deadline_expirations"],
            want["metrics"]["admission_rejections"]) == (1, 1, 1)
    for rank in ranks[2]:
        got = rank["chaos"]
        assert got["served"] == want["served"]
        assert got["preempted"] == want["preempted"]
        assert counters(got["metrics"]) == want["metrics"]
        assert got["events"] == want["events"]
        assert got["rejected"] == (4, 4) and got["pages_in_use"] == 0
    clean = reference["clean"]
    for (toks, reason), ref in zip(want["served"], clean):
        assert toks == ref if reason == "length" else toks == ref[:len(toks)]


def test_deadline_zero_expires_at_the_first_boundary(ranks, reference):
    for rank in ranks[2]:
        got = rank["deadline0"]
        assert got["expired"] == len(ZERO)
        for i, ((toks, reason), ref) in enumerate(zip(got["served"], reference["clean"])):
            assert (toks, reason) == (([], "deadline") if i in ZERO else (ref, "length"))


def test_sla_trajectory_equal_on_every_rank(ranks, reference):
    """Three windows under TINY halve the horizon 4 -> 2 -> 1 and the cap
    2 -> 1; three under HUGE relax the horizon 1 -> 2 -> 4, then the cap
    back to 2; every rank's state after every round is the same."""
    first = ranks[2][0]["sla"]
    for rank in ranks[2][1:]:
        assert rank["sla"]["trail"] == first["trail"]
    trail = first["trail"]
    assert trail[-1] == (4, 2, 5, 6)
    assert (1, 1, 2, 3) in trail
    assert first["holding"] is True
    for run in first["served"]:
        assert run == [(ref, "length") for ref in reference["clean"]]


def test_channel_costs_nothing_unarmed(ranks):
    """No clock-driven arm, no broadcast; armed, one a round boundary; the
    decode collectives are the same either way."""
    for rank in ranks[2]:
        c = rank["cost"]
        assert c["unarmed"]["broadcast"] == 0
        assert c["armed"]["broadcast"] == c["armed"]["boundaries"] > 0
        assert c["armed"]["sum"] == c["unarmed"]["sum"] > 0
        assert c["armed"]["served"] == c["unarmed"]["served"]


@pytest.mark.parametrize("case", ["shift", "fast"])
def test_disagreeing_clocks_take_rank_0s_decisions(ranks, reference, case):
    """Rank 1's clock alone would expire every request (shift) or retune
    (fast: its own TTFTs breach the target); both ranks take rank 0's
    decisions and serve the clean streams."""
    want = [(ref, "length") for ref in reference["clean"][:4]]
    for rank in ranks[2]:
        got = rank[case]
        assert got["served"] == want
        if case == "shift":
            assert got["expired"] == 0
        else:
            assert [t[2] for t in got["trail"]] == [0] * len(got["trail"])
            assert got["trail"][-1][3] == 2
    if case == "fast":
        assert max(ranks[2][0]["fast"]["own_ttft_ms"]) < FAST_TTFT_MS
        assert min(ranks[2][1]["fast"]["own_ttft_ms"]) > FAST_TTFT_MS


def test_stack_on_token_deadlines_and_sla(ranks, reference):
    """The composed stack: the same outputs on every rank (timings
    included: the lead's), the JAX engine's streams for the survivors,
    every rank's callback streams equal to the drained token_ids, each
    first token heard in an earlier round than its request's finish, and
    each group's ranks in one SLA state."""
    every = ranks[4]
    first = every[0]
    for rank in every[1:]:
        assert rank["outs"] == first["outs"]
    for i, ((toks, reason, _), ref) in enumerate(zip(first["outs"], reference["clean"])):
        assert (toks, reason) == (([], "deadline") if i in ZERO else (ref, "length"))
    for rank in every:
        assert rank["heard"] == [toks for toks, _, _ in rank["outs"]]
        for i, (f, done) in enumerate(zip(rank["first"], rank["finished"])):
            if i not in ZERO:
                assert f < done, (rank["group"], i, f, done)
    by_group = {}
    for rank in every:
        by_group.setdefault(rank["group"], set()).add(rank["sla"])
    assert sorted(by_group) == [0, 1] and all(len(v) == 1 for v in by_group.values())
    assert sum(next(iter(v))[2] for v in by_group.values()) >= 1


def test_stack_metrics_snapshot_scraped_mid_stream(ranks):
    lead = ranks[4][0]
    assert len(lead["scrapes"]) == lead["rounds"]
    assert all(not r["scrapes"] for r in ranks[4][1:])
    live = [t for t in lead["scrapes"][:-1]
            if int(re.search(r"^repro_cluster_synced_tokens\S* (\d+)", t, re.M).group(1))]
    assert live, "no scrape before the last round saw a synced token"
    assert 'replica="0"' in live[0] and 'replica="1"' in live[0]
