"""Rank bodies for the tensor-parallel tests (tests/test_torch_tp.py,
tests/test_torch_tp_lm.py, tests/test_torch_tp_moe.py,
tests/test_torch_tp_recurrent.py, tests/test_torch_tp_quant.py,
tests/test_torch_tp_clock.py, tests/test_torch_tp_uneven.py).

They run in processes that ``repro_torch.cluster.launch_ranks`` spawns,
so they live in a module of their own that imports torch and the port
only (no JAX): each rank deploys a reduced model on its shard of the
same weights and serves the reference TP test's grids (nllb600m), the
LM grids (gemma3-1b, qwen2.5-14b, llava-next-mistral-7b), the MoE and
audio grids (nllb600m-moe, whisper-base, olmoe-1b-7b,
moonshot-v1-16b-a3b), the recurrent grids (mamba2-780m,
recurrentgemma-9b), the quantization arms (act-quantizing, calibrated,
adapted and draft-armed engines), a preempting engine and the arms that
read a clock (faults, deadlines, SLA admission, clocks that disagree),
every family at a tp that does not divide its widths, or its share of a
composed dp x tp stack (``on_token``, a metrics snapshot scraped over
HTTP).
"""

import contextlib
import dataclasses
import time
import urllib.request
import warnings

import torch

from repro_torch.cluster import deploy_replicas, tp_mesh
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core import tree_nbytes
from repro_torch.models import Ctx
from repro_torch.optim import compressed_psum
from repro_torch.obs import MetricsServer, MetricsSnapshot
from repro_torch.serving import (EngineSaturated, FaultPlan, SamplingParams, ServeEngine,
                                 SLATarget, deploy, impl_routes)

CTX = Ctx(compute_dtype=torch.float32)
GREEDY = SamplingParams(max_new_tokens=8)
SAMPLED = SamplingParams(max_new_tokens=8, temperature=0.8, top_k=8, seed=7)


def common(paged: bool, horizon: int) -> dict:
    """The reference TP test's engine shape."""
    return dict(smoke=True, slots=2, max_len=16, ctx=CTX, paged=paged, page_size=4,
                horizon=horizon)


def grids(pipe, src):
    """The greedy grid (to ita) and the seeded sampled grid (to hin):
    (tokens, finish reason) per source row."""
    return ([(o.token_ids, o.finish_reason) for o in pipe.translate(src, "ita", GREEDY)],
            [(o.token_ids, o.finish_reason) for o in pipe.translate(src, "hin", SAMPLED)])


def prefill_logits(pipe, src, code: int):
    """One prefill's logits through the engine's own (rank-local) model,
    shard and ctx: the source's first row prompted with ``code``."""
    eng = pipe.engine
    cache = eng.model.init_cache(1, 16, eng.kv_dtype, enc_len=eng.enc_cap)
    batch = {"src_tokens": torch.as_tensor(src[:1]),
             "tgt_in": torch.full((1, 1), code, dtype=torch.int32)}
    with torch.no_grad():
        return eng.model.prefill(eng.ctx, eng.params, cache, batch)[1].numpy()


def tp_grid(rank, world, device, params_np, cases, src, grads):
    """Every case (spec, paged, horizon) deployed on this rank's shard of
    ``params_np``; then, with ``grads`` (one tree per rank), the
    compressed all-reduce of this rank's tree. Returns the grids, one
    prefill's logits and the reduced tree."""
    params = from_numpy_tree(params_np, "cpu")
    mesh = tp_mesh(world)
    out = {"mesh": repr(mesh), "grids": {}}
    for spec, paged, horizon in cases:
        pipe = deploy("nllb600m", spec, params=params, mesh=mesh, device=device,
                      **common(paged, horizon))
        out["grids"][spec, paged, horizon] = grids(pipe, src)
        if "logits" not in out:
            out["logits"] = prefill_logits(pipe, src, 7)
            out["shard_heads"] = pipe.engine.model.cfg.num_heads
            # the pipeline keeps the engine's shard, not the whole tree
            out["weight_bytes"] = (pipe.params is pipe.engine.params,
                                   tree_nbytes(pipe.params), pipe.quantized_bytes)
    if grads is not None:
        tree = {k: None if v is None else torch.from_numpy(v) for k, v in grads[rank].items()}
        out["psum"] = {k: None if v is None else v.numpy()
                       for k, v in compressed_psum(tree, mesh).items()}
    return out



LM_KW = dict(slots=2, max_len=32, ctx=CTX, page_size=4)


def lm_config(arch: str, kv_heads=None):
    """The reduced config of ``arch``; ``kv_heads`` overrides its KV-head
    count (the reduced configs keep one)."""
    cfg = reduce_config(get_config(arch))
    return cfg if kv_heads is None else dataclasses.replace(cfg, num_kv_heads=kv_heads)


def lm_prompts(batches):
    """Numpy batch dicts ({"tokens" (1, n)[, "img_embeds"]}) as tensors."""
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def lm_grids(pipe, prompts):
    """The greedy grid and the seeded sampled grid of ``prompts``."""
    return ([(o.token_ids, o.finish_reason) for o in pipe.generate(prompts, GREEDY)],
            [(o.token_ids, o.finish_reason) for o in pipe.generate(prompts, SAMPLED)])


def lm_prefill_logits(pipe, batch, max_len=LM_KW["max_len"]):
    """One prefill's whole logits (1, S, V) through the engine's own
    (rank-local) model, shard and ctx; an enc-dec's cache holds the
    engine's source capacity."""
    eng = pipe.engine
    kw = dict(enc_len=eng.enc_cap) if eng.enc_cap else {}
    cache = eng.model.init_cache(1, max_len, eng.kv_dtype, **kw)
    with torch.no_grad():
        return eng.model.prefill(eng.ctx, eng.params, cache, dict(batch))[1].numpy()


def lm_grid(rank, world, device, params_np, cases, batches, stack):
    """Every LM case (arch, kv_heads, spec, paged, horizon) deployed with
    ``mesh=tp_mesh(world)`` on this rank's shard of ``params_np[arch]``
    and its grids served on ``batches[arch]``; the first case's local
    widths and one prefill's logits through the rank's model. Then, with
    ``stack`` (spec, replicas, tp, nllb600m's params, sources), the
    composed ``deploy_replicas(tp=...)`` of the reduced nllb600m: its
    grids, its placements and its merged and per-replica metrics."""
    out = {"grids": {}}
    if cases:
        mesh = tp_mesh(world)
        out["mesh"] = repr(mesh)
    for arch, kv_heads, spec, paged, horizon in cases:
        params = from_numpy_tree(params_np[arch], "cpu")
        prompts = lm_prompts(batches[arch])
        pipe = deploy(lm_config(arch, kv_heads), spec, params=params, mesh=mesh,
                      device=device, paged=paged, horizon=horizon, **LM_KW)
        out["grids"][arch, spec, paged, horizon] = lm_grids(pipe, prompts)
        if "logits" not in out:
            lc = pipe.engine.model.cfg
            out["local"] = (lc.num_heads, lc.num_kv_heads, lc.d_ff)
            out["logits"] = lm_prefill_logits(pipe, prompts[0])
    if stack is not None:
        out["stack"] = stack_grids(device, *stack)
    return out


def stack_grids(device, spec, replicas, tp, params_np, src):
    """This rank's view of ``deploy_replicas(..., replicas, tp)`` over the
    reduced nllb600m: the greedy and sampled grids, the placements of a
    routed submit of every source row, and the merged and per-replica
    counters and TTFT counts."""
    params = from_numpy_tree(params_np, "cpu")
    pipe = deploy_replicas("nllb600m", spec, replicas=replicas, tp=tp, params=params,
                           device=device, **common(True, 16))
    router = pipe.engine
    out = {"grids": grids(pipe, src), "group": router.group,
           "local_heads": router.own.model.cfg.num_heads}
    m = router.metrics()
    per = [e.metrics() for e in router.replicas]
    hists = [e.latency_histograms()["ttft_ms"].count for e in router.replicas]
    out["metrics"] = {
        "merged": {k: getattr(m, k) for k in ("synced_tokens", "decode_syncs", "decode_steps")},
        "per": [{k: getattr(p, k) for k in ("synced_tokens", "decode_syncs", "decode_steps")}
                for p in per],
        "ttft_count": router.merged_latency_histograms()["ttft_ms"].count,
        "ttft_per": hists, "prometheus": router.prometheus()}
    prompts = [{"src_tokens": torch.as_tensor(src[i:i + 1]),
                "tgt_in": torch.full((1, 1), 7, dtype=torch.int32)} for i in range(len(src))]
    gids = [router.submit(p, GREEDY) for p in prompts]
    out["placements"] = [router._owner[g][0] for g in gids]
    by_id = {o.request_id: o.token_ids for o in router.run_until_drained()}
    out["routed"] = [by_id[g] for g in gids]
    return out


MOE_KW = dict(slots=2, ctx=CTX, page_size=4)


def moe_grid(rank, world, device, params_np, cases, batches, stack, preempt):
    """Every case (arch, spec, paged, horizon, max_len) of the MoE and
    audio families deployed with ``mesh=tp_mesh(world)`` on this rank's
    shard of ``params_np[arch]``, its greedy grid served on
    ``batches[arch]``; per arch the experts a rank holds, its weight bytes
    against the whole tree's, and the first case's prefill logits. With
    ``stack`` (spec, replicas, tp, params, batches), the composed
    ``deploy_replicas(tp=...)`` of the reduced nllb600m-moe; with
    ``preempt`` (params, batches, num_pages, max_new_tokens), a paged
    nllb600m-moe engine on 2 slots whose pool preempts: its streams and
    preemption counters."""
    out = {"grids": {}, "local": {}}
    mesh = tp_mesh(world)
    for arch, spec, paged, horizon, max_len in cases:
        params = from_numpy_tree(params_np[arch], "cpu")
        prompts = lm_prompts(batches[arch])
        pipe = deploy(lm_config(arch), spec, params=params, mesh=mesh, device=device,
                      paged=paged, horizon=horizon, max_len=max_len, **MOE_KW)
        out["grids"][arch, spec, paged, horizon] = [
            (o.token_ids, o.finish_reason) for o in pipe.generate(prompts, GREEDY)]
        if arch not in out["local"]:
            lc, shard = pipe.engine.model.cfg, pipe.engine.params
            layer = shard.get("decoder", shard)["layers"]
            experts = layer["moe"]["experts"] if "moe" in layer else None
            out["local"][arch] = {
                "heads": (lc.num_heads, lc.num_kv_heads, lc.d_ff),
                "experts": None if experts is None else
                next(iter(experts.values())).shape[-3],
                "bytes": (tree_nbytes(shard), pipe.quantized_bytes),
                "logits": lm_prefill_logits(pipe, prompts[0], max_len)}
    if stack is not None:
        spec, replicas, tp, params_np, nllb = stack
        pipe = deploy_replicas(lm_config("nllb600m-moe"), spec, replicas=replicas, tp=tp,
                               params=from_numpy_tree(params_np, "cpu"), device=device,
                               paged=True, horizon=16, max_len=16, **MOE_KW)
        out["stack"] = {"group": pipe.engine.group,
                        "grid": [(o.token_ids, o.finish_reason)
                                 for o in pipe.generate(lm_prompts(nllb), GREEDY)]}
    if preempt is not None:
        out["preempt"] = preempt_run(device, mesh, *preempt)
    return out


def preempt_run(device, mesh, params_np, batches, num_pages, new):
    """The reduced nllb600m-moe int8, paged on 2 slots over ``num_pages``
    pages (``mesh`` None: one device): the greedy streams of ``batches``
    and the preemption counters."""
    pipe = deploy(lm_config("nllb600m-moe"), "int8", params=from_numpy_tree(params_np, "cpu"),
                  mesh=mesh, device=device, paged=True, horizon=4, max_len=32,
                  num_pages=num_pages, preempt_limit=16, **MOE_KW)
    outs = pipe.generate(lm_prompts(batches), SamplingParams(max_new_tokens=new))
    m = pipe.engine.metrics()
    pipe.engine.allocator.check()
    return {"grid": [(o.token_ids, o.finish_reason) for o in outs],
            "preemptions": m.preemptions, "resumed": m.resumed_requests,
            "pages_in_use": pipe.engine.allocator.pages_in_use}


# the engine shapes tests/test_torch_ssm.py and tests/test_torch_hybrid.py
# serve the recurrent archs at (the reference's f32 SSM engine breaks past
# horizon 1)
REC_KW = {"mamba2-780m": dict(slots=3, max_len=32, horizon=1, ctx=CTX),
          "recurrentgemma-9b": dict(slots=3, max_len=48, horizon=4, ctx=CTX)}


def recurrent_local(pipe):
    """A recurrent engine's rank-local widths: an SSM shard's (SSD heads,
    in_proj width, conv channels), a hybrid's (heads, KV heads, d_ff,
    d_rec, w_rg's shape)."""
    lc, shard = pipe.engine.model.cfg, pipe.engine.params
    if lc.family == "ssm":
        ssm = shard["layers"]["ssm"]
        return (ssm["a_log"].shape[-1], ssm["in_proj"].shape[-1], ssm["conv_w"].shape[-1])
    w_rg = shard["blocks"]["r1"]["rglru"]["w_rg"]
    return (lc.num_heads, lc.num_kv_heads, lc.d_ff, lc.d_rec, tuple(w_rg.shape[-2:]))


def recurrent_grid(rank, world, device, params_np, cases, batches, stack):
    """Every case (arch, spec) of the SSM and hybrid families deployed
    dense with ``mesh=tp_mesh(world)`` on this rank's shard of
    ``params_np[arch]`` (``REC_KW``'s engine), its greedy and sampled grids
    served on ``batches[arch]``; per arch its local widths, its weight
    bytes against the whole tree's and the first case's prefill logits.
    With ``stack`` (arch, spec, replicas, tp), the composed
    ``deploy_replicas(tp=...)`` of that arch: its group and grids."""
    out = {"grids": {}, "local": {}}
    mesh = tp_mesh(world)
    for arch, spec in cases:
        pipe = deploy(lm_config(arch), spec, params=from_numpy_tree(params_np[arch], "cpu"),
                      mesh=mesh, device=device, **REC_KW[arch])
        prompts = lm_prompts(batches[arch])
        out["grids"][arch, spec] = lm_grids(pipe, prompts)
        if arch not in out["local"]:
            out["local"][arch] = {
                "widths": recurrent_local(pipe),
                "bytes": (tree_nbytes(pipe.engine.params), pipe.quantized_bytes),
                "logits": lm_prefill_logits(pipe, prompts[0], REC_KW[arch]["max_len"])}
    if stack is not None:
        arch, spec, replicas, tp = stack
        pipe = deploy_replicas(lm_config(arch), spec, replicas=replicas, tp=tp,
                               params=from_numpy_tree(params_np[arch], "cpu"), device=device,
                               **REC_KW[arch])
        out["stack"] = {"group": pipe.engine.group,
                        "grids": lm_grids(pipe, lm_prompts(batches[arch]))}
    return out


# the quantization arms under a mesh (tests/test_torch_tp_quant.py): each
# case is (name, spec, tree, kw) with kw's engine shape, "bundle" (the
# port's kernel-route bundle), "calibrate" and "draft_spec"
def quant_deploy(arch, spec, params, calib, kw, **more):
    """deploy() of one quantization arm: ``params`` (a torch tree),
    ``calib`` (numpy batch dicts, made tensors afresh) when the case
    calibrates, the case's bundle and engine shape; ``more`` adds the
    mesh and the device."""
    kw = dict(kw)
    batches = lm_prompts(calib) if kw.pop("calibrate", False) else None
    routes = impl_routes(kw.pop("bundle", "kernels"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # a dynamic act spec warns
        return deploy(arch, spec, params=params, calib_batches=batches, ctx=CTX,
                      **routes, **kw, **more)


def quant_facts(pipe):
    """What every rank must agree on beside the streams: the target's and
    the draft's calibrated site tables, and a draft arm's counters
    (drafted, accepted, verify rounds)."""
    eng = pipe.engine
    draft = eng.draft
    return {"table": pipe.ctx.act_scales,
            "draft_table": None if draft is None else draft.ctx.act_scales,
            "accept": None if draft is None else (eng.drafted_tokens, eng.accepted_tokens,
                                                  eng.verify_calls)}


def quant_grid(rank, world, device, trees, cases, src, calib, lm_cases, stack):
    """Every nllb600m case (name, spec, tree, kw) deployed with
    ``mesh=tp_mesh(world)`` on this rank's shard of ``trees[tree]``: its
    greedy and sampled grids on ``src`` and its quant_facts. Each LM case
    (arch, spec, kw, params, prompts, calib) likewise on ``lm_grids``
    (``trees`` and ``params`` are torch trees).
    With ``stack`` (spec, replicas, tp, kw), the composed
    ``deploy_replicas(tp=...)`` of nllb600m on ``trees["raw"]``,
    calibrated on ``calib``: its group, grids and table."""
    mesh = tp_mesh(world)
    out = {"grids": {}, "facts": {}}
    for name, spec, tree, kw in cases:
        pipe = quant_deploy("nllb600m", spec, trees[tree], calib, kw, smoke=True, mesh=mesh,
                            device=device)
        out["grids"][name] = grids(pipe, src)
        out["facts"][name] = quant_facts(pipe)
    for arch, spec, kw, params, prompts, lm_calib in lm_cases:
        pipe = quant_deploy(lm_config(arch), spec, params, lm_calib, kw, mesh=mesh,
                            device=device)
        out["grids"][arch] = lm_grids(pipe, lm_prompts(prompts))
        out["facts"][arch] = quant_facts(pipe)
    if stack is not None:
        spec, replicas, tp, kw = stack
        batches = lm_prompts(calib)
        pipe = deploy_replicas("nllb600m", spec, replicas=replicas, tp=tp,
                               params=trees["raw"], calib_batches=batches, device=device,
                               **dict(common(kw["paged"], kw["horizon"]), **impl_routes(
                                   kw["bundle"])))
        out["stack"] = {"group": pipe.engine.group, "grids": grids(pipe, src),
                        "table": pipe.engine.own.ctx.act_scales}
    return out


# the clock-driven arms under a mesh (tests/test_torch_tp_clock.py): the
# reduced nllb600m int4 ("torch" bundle), paged on 2 slots over 8 pages of
# 4, horizon 4, as tests/test_torch_faults.py's "paged4" layout
CLOCK_KW = dict(slots=2, max_len=16, horizon=4, paged=True, page_size=4, num_pages=8)
DEADLINE_MS = 60_000.0      # far beyond wall time: only the skew expires it
SKEW_MS = 600_000.0
SHIFT_S = 3600.0            # rank 1's clock jump in the disagreeing-clock case
SHIFT_DEADLINE_MS = 600_000.0
FAST = 1e6                  # rank 1's clock rate in the other one
FAST_TTFT_MS = 1e5          # between rank 0's p95 TTFT and rank 1's
TINY, HUGE = 1e-6, 1e9      # SLA targets that every window breaches / meets
# a budget that lapses before the first boundary (a deadline must be
# positive, so this stands for 0)
NOW_MS = 1e-6


def chaos_plan():
    """tests/test_torch_faults.py's plan: steal 4 pages at round 0 for 8
    rounds, NaN on slot 0 at micro-step 2 of dispatch 0, a skew at round
    1 past DEADLINE_MS."""
    return FaultPlan(exhaust_at=[(0, 4, 8)], nan_at=[(0, 0, 2)], skew_at=[(1, SKEW_MS)])


class _Clock:
    """The ``time`` module as the engine module reads it: ``perf_counter``
    jumped by ``shift_s`` and run ``rate`` times fast from now."""

    def __init__(self, shift_s: float = 0.0, rate: float = 1.0):
        self.t0, self.shift_s, self.rate = time.perf_counter(), shift_s, rate

    def perf_counter(self) -> float:
        return self.t0 + self.shift_s + (time.perf_counter() - self.t0) * self.rate


@contextlib.contextmanager
def own_clock(on: bool, **kw):
    """Inside, the engine module reads ``_Clock(**kw)`` where ``on``."""
    from repro_torch.serving import engine as engine_mod
    real = engine_mod.time
    if on:
        engine_mod.time = _Clock(**kw)
    try:
        yield
    finally:
        engine_mod.time = real


def clock_engine(pipe, **kw):
    """A fresh engine of CLOCK_KW (``kw`` adds or replaces options) on the
    deploy's rank-local model, shard and ctx."""
    return ServeEngine(pipe.model, pipe.params, ctx=pipe.ctx, kv_dtype=pipe.engine.kv_dtype,
                       device=pipe.engine.device, **dict(CLOCK_KW, **kw))


def drain(eng, on_round=None):
    """Serve until drained; outputs by request id."""
    return {o.request_id: o for o in eng.stream(on_round=on_round)}


def served(outs, ids):
    return [(outs[i].token_ids, outs[i].finish_reason) for i in ids]


def sla_state(ctl):
    return (ctl.horizon, ctl.prefill_cap, ctl.retunes, ctl.windows)


def counting(grp):
    """Count the group's channel broadcasts and sums from now on."""
    n = {"broadcast": 0, "sum": 0}
    real_b, real_s = grp.broadcast, grp._sum

    def broadcast(x):
        n["broadcast"] += 1
        return real_b(x)

    def _sum(y):
        n["sum"] += 1
        return real_s(y)

    grp.broadcast, grp._sum = broadcast, _sum
    return n


def clock_chaos(pipe, prompts, sps):
    """The chaos plan with max_pending=4: four submits queue, a fifth is
    refused; the streams, the counters, the plan's events and the pool
    after release_all."""
    plan = chaos_plan()
    eng = clock_engine(pipe, faults=plan, preempt_limit=16, max_pending=4)
    ids = [eng.submit(p, sp) for p, sp in zip(prompts[:4], sps)]
    try:
        eng.submit(prompts[4], sps[0])
        rejected = None
    except EngineSaturated as exc:
        rejected = (exc.pending, exc.limit)
    outs = drain(eng)
    plan.release_all(eng)
    eng.allocator.check()
    return {"served": served(outs, ids), "preempted": [outs[i].stats.preemptions for i in ids],
            "metrics": eng.metrics().as_dict(), "events": list(plan.events),
            "rejected": rejected, "pages_in_use": eng.allocator.pages_in_use}


def clock_deadline0(pipe, prompts, sps, zero):
    """A deadline of NOW_MS on the requests of ``zero``: they expire at the
    first boundary."""
    eng = clock_engine(pipe)
    ids = [eng.submit(p, dataclasses.replace(sp, deadline_ms=NOW_MS) if i in zero else sp)
           for i, (p, sp) in enumerate(zip(prompts, sps))]
    outs = drain(eng)
    return {"served": served(outs, ids), "expired": eng.deadline_expirations}


def clock_sla(pipe, prompts, sps):
    """A TINY p95 TTFT target with a window of 2 (every window halves),
    then on the same controller a HUGE one (every window relaxes): the
    controller's state after every round and after each drain (whose
    last boundary folds the last observations), and the streams."""
    eng = clock_engine(pipe, sla=SLATarget(p95_ttft_ms=TINY, window=2))
    trail, runs = [], []
    for target in (TINY, HUGE):
        eng.sla.target = SLATarget(p95_ttft_ms=target, window=2)
        ids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = drain(eng, lambda: trail.append(sla_state(eng.sla)))
        trail.append(sla_state(eng.sla))    # after the last boundary's fold
        runs.append(served(outs, ids))
    return {"served": runs, "trail": trail, "holding": eng.sla.holding()}


def clock_shift(pipe, prompts, sps, rank):
    """Every request with a SHIFT_DEADLINE_MS budget; after the submits
    rank 1's clock jumps SHIFT_S, past every budget."""
    eng = clock_engine(pipe)
    ids = [eng.submit(p, dataclasses.replace(sp, deadline_ms=SHIFT_DEADLINE_MS))
           for p, sp in zip(prompts, sps)]
    with own_clock(rank == 1, shift_s=SHIFT_S):
        outs = drain(eng)
    return {"served": served(outs, ids), "expired": eng.deadline_expirations}


def clock_fast(pipe, prompts, sps, rank):
    """Rank 1's clock runs FAST times fast from before the submits, so its
    own TTFTs breach FAST_TTFT_MS and rank 0's meet it."""
    with own_clock(rank == 1, rate=FAST):
        eng = clock_engine(pipe, sla=SLATarget(p95_ttft_ms=FAST_TTFT_MS, window=2))
        ids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        trail = []
        outs = drain(eng, lambda: trail.append(sla_state(eng.sla)))
        trail.append(sla_state(eng.sla))
    return {"served": served(outs, ids), "trail": trail,
            "own_ttft_ms": [outs[i].ttft_ms for i in ids]}


def clock_cost(pipe, prompts, sps):
    """Channel broadcasts and sums of the same run unarmed and armed (an
    empty FaultPlan), with the rounds the armed run crossed."""
    out = {}
    for name, kw in (("unarmed", {}), ("armed", {"faults": FaultPlan()})):
        eng = clock_engine(pipe, **kw)
        n = counting(eng.tp)
        ids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = drain(eng)
        del eng.tp.broadcast, eng.tp._sum
        out[name] = dict(n, boundaries=eng._boundaries, served=served(outs, ids))
    return out


def clock_grid(rank, world, device, params_np, prompts, sps):
    """Every tp2 case of tests/test_torch_tp_clock.py on fresh engines of
    one ``deploy(mesh=tp_mesh(world))``: the chaos plan, NOW_MS deadlines,
    the SLA trajectory, the cost of the channel, then the two
    disagreeing clocks (rank 1's alone)."""
    pipe = deploy("nllb600m", "int4", params=from_numpy_tree(params_np, "cpu"),
                  mesh=tp_mesh(world), device=device, smoke=True, **impl_routes("torch"),
                  **CLOCK_KW)
    return {"chaos": clock_chaos(pipe, prompts, sps[:4]),
            "deadline0": clock_deadline0(pipe, prompts[:4], sps[:4], (1, 2)),
            "sla": clock_sla(pipe, prompts, sps),
            "cost": clock_cost(pipe, prompts[:2], sps[:2]),
            "shift": clock_shift(pipe, prompts[:4], sps[:4], rank),
            "fast": clock_fast(pipe, prompts[:4], sps[:4], rank)}


def stack_clock(rank, world, device, params_np, prompts, sps, zero):
    """This rank's view of ``deploy_replicas("nllb600m", "int4",
    replicas=2, tp=2)`` under a TINY SLA target: every request submitted
    with ``on_token`` (a NOW_MS deadline on those of ``zero``), served
    through ``stream(on_round=)`` that counts rounds, refreshes a metrics
    snapshot on every rank and, on rank 0, scrapes the server that serves
    it. Returns the outputs, the callbacks' streams, the round of each
    request's first callback and of its finish, the SLA state and rank
    0's scrapes."""
    pipe = deploy_replicas("nllb600m", "int4", replicas=2, tp=2,
                           params=from_numpy_tree(params_np, "cpu"), device=device,
                           smoke=True, sla=SLATarget(p95_ttft_ms=TINY, window=2),
                           **impl_routes("torch"), **CLOCK_KW)
    router = pipe.engine
    rounds, heard, first = [0], {}, {}

    def tap(i):
        def cb(tok):
            heard.setdefault(i, []).append(tok)
            first.setdefault(i, rounds[0])
        return cb

    gids = [router.submit(p, dataclasses.replace(sp, deadline_ms=NOW_MS) if i in zero else sp,
                          on_token=tap(i))
            for i, (p, sp) in enumerate(zip(prompts, sps))]
    snap = MetricsSnapshot(router.prometheus)
    srv = MetricsServer(snap).start() if rank == 0 else None
    scrapes = []

    def on_round():
        rounds[0] += 1
        snap.refresh()
        if srv is not None:
            with urllib.request.urlopen(srv.url, timeout=10) as r:
                scrapes.append(r.read().decode())

    outs, finished = {}, {}
    for o in router.stream(on_round=on_round):
        outs[o.request_id] = o
        finished[o.request_id] = rounds[0]
    if srv is not None:
        srv.close()
    return {"outs": [(outs[g].token_ids, outs[g].finish_reason, outs[g].ttft_ms) for g in gids],
            "heard": [heard.get(i, []) for i in range(len(gids))],
            "first": [first.get(i) for i in range(len(gids))],
            "finished": [finished[g] for g in gids], "rounds": rounds[0],
            "group": router.group, "sla": sla_state(router.own.sla), "scrapes": scrapes}


# any tp (tests/test_torch_tp_uneven.py): each case is (name, arch, spec,
# paged, horizon, max_len, prompt set)
UNEVEN_KW = dict(slots=2, ctx=CTX, page_size=4)


def uneven_config(arch: str):
    """The reduced config of ``arch``; recurrentgemma-9b's window is 6,
    so that tp3 divides its rolling buffer."""
    cfg = reduce_config(get_config(arch))
    return dataclasses.replace(cfg, local_window=6) if arch == "recurrentgemma-9b" else cfg


def kv_rows(cache):
    """The sequence rows of a dense cache's self-attention K leaf (a
    hybrid's rolling buffer), or None (an SSM's states, a paged pool)."""
    if "block_tables" in cache:
        return None
    k = next((cache[n] for n in ("k_codes", "k", "b_k") if n in cache), None)
    return None if k is None else k.shape[2]


def decode_collectives(eng):
    """Count the sums and maxes of ``eng``'s group made inside its decode
    loops (its prefills' collectives apart). Returns the count, filled as
    the engine runs."""
    grp, n = eng.ctx.tp, {"collectives": 0}
    live = [False]
    real_sum, real_max, real_loop = grp._sum, grp._max, eng._decode_loop

    def _sum(y):
        n["collectives"] += live[0]
        return real_sum(y)

    def _max(y):
        n["collectives"] += live[0]
        return real_max(y)

    def loop(*a, **kw):
        live[0] = True
        try:
            return real_loop(*a, **kw)
        finally:
            live[0] = False

    grp._sum, grp._max, eng._decode_loop = _sum, _max, loop
    return n


def uneven_grid(rank, world, device, params_np, cases, prompts):
    """Every case deployed with ``mesh=tp_mesh(world)`` on this rank's
    shard of ``params_np[arch]`` (``uneven_config``), its greedy and
    sampled grids served on ``prompts[set]``; per case the rank-local
    config's replicated kinds and widths, the cache's sequence rows, and
    the collectives a decode step took."""
    mesh = tp_mesh(world)
    out = {"grids": {}, "layout": {}}
    for name, arch, spec, paged, horizon, max_len, which in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # an act spec's dynamic fallback
            pipe = deploy(uneven_config(arch), spec, mesh=mesh, device=device,
                          params=from_numpy_tree(params_np[arch], "cpu"), paged=paged,
                          horizon=horizon, max_len=max_len, **UNEVEN_KW)
        eng = pipe.engine
        n, steps = decode_collectives(eng), eng.decode_steps
        out["grids"][name] = lm_grids(pipe, lm_prompts(prompts[which]))
        lc = eng.model.cfg
        out["layout"][name] = {
            "replicated": lc.replicated, "rows": kv_rows(eng.cache),
            "widths": (lc.num_heads, lc.num_kv_heads, lc.d_ff, lc.d_rec),
            "per_step": n["collectives"] / (eng.decode_steps - steps)}
    return out
