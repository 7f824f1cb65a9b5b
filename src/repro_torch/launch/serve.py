"""Serving launcher: quantized NMT inference, the paper's deployment mode,
and the decoder-only LMs of the registry (random 4-7 token prompts).

One deploy() call builds the quantized pipeline; the engine schedules
admission and slots. The launcher submits requests and prints each
output as it finishes (the overlapped scheduler dispatches horizon N+1
while the host walks horizon N; ``--no-overlap`` restores serial rounds,
and ``--sla-ttft-ms`` / ``--sla-tpot-ms`` attach the percentile-feedback
admission controller).

Failure handling: ``--max-pending`` bounds the queue (the submit loop
steps and retries on the typed EngineSaturated), ``--deadline-ms`` gives
every request a wall-clock budget, and the shutdown line reports the
engine's fault counters. Every shutdown number comes from ONE frozen
``engine.metrics()`` snapshot.

Observability: ``--trace-out FILE`` dumps Chrome/Perfetto trace JSON,
``--metrics-out FILE`` the Prometheus text of the final snapshot, and
``--metrics-port N`` serves the live exposition at ``GET /metrics``
(rank 0 serves it under a mesh; over ``--mesh dp<N>,tp<K>`` rendering the
merged metrics is a collective of every rank, so every rank refreshes a
``MetricsSnapshot`` at the end of each round and the server returns the
latest, at most a round old).

``--policy`` and ``--draft-spec`` take any spec of the grammar, the
act-quantizing and fp8-KV ones included (``w8a8``, ``fp8e2e``,
``w4a8kv8``); an act-quantizing spec warns that it quantizes dynamically
per token, since the launcher calibrates nothing. ``--draft-spec`` adds a
quantized speculative draft arm (greedy output unchanged).

Scale-out: ``--mesh tp<K>`` runs the launcher's body on K ranks
(``cluster.launch_ranks``: NCCL when each rank has a card of its own,
gloo when they share one or run on the CPU), each deploying with
``mesh=tp_mesh(K)`` and serving the same requests (any ``--arch`` of the
registry: an MoE model's experts split E over the ranks, an SSM's heads
and an RG-LRU's channels split too; the SSM and hybrid engines are dense
only, without ``--paged``; every ``--policy`` and ``--draft-spec``
serves, the act-quantizing ones dynamically as on one device); rank 0
prints. ``--mesh dp<N>``
serves through ``deploy_replicas`` (N engines behind the replica
router). ``--mesh dp<N>,tp<K>`` runs the body on N·K ranks, each calling
``deploy_replicas(replicas=N, tp=K)``: N tensor-parallel replicas behind
a router that every rank runs alike; rank 0 prints. ``--sla-ttft-ms``,
``--sla-tpot-ms``, ``--deadline-ms`` and ``--max-pending`` serve under
every ``--mesh``: each tensor-parallel group's rank 0 decides the
expiries and retunes, and every rank computes the same ``sla:`` and
``faults:`` lines. ``--device`` (default ``cuda``) picks the device; the CPU runs the
kernels' plain versions.

  python -m repro_torch.launch.serve --arch nllb600m --policy int4 \\
      --paged --draft-spec nf4 --requests 8 --gen 16 --max-len 128
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --policy int4 --requests 6 --gen 8 --temperature 0.7 --top-p 0.9
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --smoke \\
      --device cpu --paged --requests 3 --gen 8 --max-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --paged --mesh tp2 --requests 4 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --paged --mesh dp2,tp2 --requests 4 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch nllb600m-moe --smoke \\
      --device cpu --paged --mesh tp2 --requests 4 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --smoke \\
      --device cpu --mesh tp2 --requests 4 --gen 8 --max-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --paged --mesh tp2 --policy w8a8 --draft-spec nf4 --requests 4 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --paged --mesh dp2,tp2 --metrics-port 0 --sla-ttft-ms 1 --deadline-ms 600000
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from .. import random as prng
from ..cluster import deploy_replicas, launch_ranks, parse_mesh_spec, tp_mesh
from ..configs import REGISTRY
from ..core import ALIASES, resolve_spec, tree_nbytes
from ..data import SyntheticTranslation
from ..obs import MetricsServer, MetricsSnapshot
from ..serving import (DEFAULT_IMPL, IMPL_CHOICES, EngineSaturated, SamplingParams,
                       SLATarget, TraceConfig, deploy, impl_routes)

__all__ = ["main", "parse_mesh_spec"]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="nllb600m", choices=sorted(REGISTRY))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="int4", metavar="SPEC",
                    help="quantization spec: an alias "
                         f"({', '.join(sorted(ALIASES))}) or a grammar "
                         "string like w4a8kv8 / wfp8e4m3afp8kvfp8")
    ap.add_argument("--draft-spec", default=None, metavar="SPEC",
                    help="speculative-decoding draft arm: the same checkpoint "
                         "quantized at this spec drafts tokens the target "
                         "verifies (greedy output is unchanged, same "
                         "alias/grammar as --policy)")
    ap.add_argument("--draft-lookahead", type=int, default=4,
                    help="tokens drafted per speculative verify round")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache + batched prefill admission")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=1,
                    help="decode steps fused per host sync")
    ap.add_argument("--impl", choices=IMPL_CHOICES, default=DEFAULT_IMPL,
                    help="kernel route bundle: kernels = the qmm and "
                         "paged-attention kernels, torch = plain PyTorch")
    ap.add_argument("--no-overlap", action="store_true",
                    help="serial dispatch-then-walk rounds")
    ap.add_argument("--sla-ttft-ms", type=float, default=None, metavar="T",
                    help="p95 time-to-first-token target")
    ap.add_argument("--sla-tpot-ms", type=float, default=None, metavar="T",
                    help="p95 per-output-token target")
    ap.add_argument("--max-pending", type=int, default=None, metavar="N",
                    help="bounded admission queue: submit() raises the typed "
                         "EngineSaturated past N pending requests (the "
                         "launcher steps and retries)")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="T",
                    help="per-request wall-clock budget from submit")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="trace and dump Chrome/Perfetto trace JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the final Prometheus text exposition here")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve the live exposition at "
                         "http://127.0.0.1:N/metrics (0 = ephemeral)")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="scale-out spec 'dp<N>,tp<K>': tp<K> serves on K "
                         "tensor-parallel ranks, dp<N> through N routed "
                         "replicas, both on N*K ranks")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (the tests pass cpu)")
    args = ap.parse_args(argv)

    resolve_spec(args.policy)        # fail on typos before any build work
    if args.draft_spec is not None:
        resolve_spec(args.draft_spec)
    dp, tp = parse_mesh_spec(args.mesh) if args.mesh else (1, 1)
    if tp > 1:
        launch_ranks(_serve_rank, dp * tp, device=args.device, args=(args, dp))
    else:
        _serve(args, dp)


def _quiet(*_a, **_k) -> None:
    pass


def _serve_rank(rank: int, world: int, device, args, dp: int) -> None:
    """One rank of ``--mesh tp<K>`` (the ``("model",)`` mesh) or
    ``dp<N>,tp<K>`` (``deploy_replicas(tp=K)``): the launcher's body on
    the rank's device; rank 0 prints and writes."""
    if dp > 1:
        _serve(args, dp, tp=world // dp, device=device, lead=rank == 0)
    else:
        _serve(args, 1, mesh=tp_mesh(world), device=device, lead=rank == 0)


def _serve(args, dp: int, mesh=None, device=None, lead: bool = True, tp: int = 1) -> None:
    echo = print if lead else _quiet
    sla = None
    if args.sla_ttft_ms is not None or args.sla_tpot_ms is not None:
        sla = SLATarget(p95_ttft_ms=args.sla_ttft_ms, p95_tpot_ms=args.sla_tpot_ms,
                        window=max(args.requests // 2, 1))
    kw = dict(slots=args.slots, max_len=args.max_len, smoke=args.smoke, paged=args.paged,
              page_size=args.page_size, num_pages=args.num_pages, horizon=args.horizon,
              draft_spec=args.draft_spec, draft_lookahead=args.draft_lookahead,
              overlap=not args.no_overlap, sla=sla, max_pending=args.max_pending,
              trace=TraceConfig() if args.trace_out else None, **impl_routes(args.impl))
    if dp > 1 and tp > 1:
        pipe = deploy_replicas(args.arch, args.policy, replicas=dp, tp=tp, device=device,
                               **kw)
        echo(f"cluster: {dp} replicas x tp{tp} over {dp * tp} ranks, each replica a "
             f"('model',) row of a ('dp', 'model') mesh over {pipe.ctx.tp.backend}; "
             f"rank 0 holds {tree_nbytes(pipe.params)/2**20:.1f} MB of the weights")
    elif dp > 1:
        pipe = deploy_replicas(args.arch, args.policy, replicas=dp, device=args.device,
                               **kw)
        devs = sorted({str(e.device) for e in pipe.engine.replicas})
        echo(f"cluster: {dp} replicas x tp1 over {len(devs)} device(s) {devs}")
    else:
        pipe = deploy(args.arch, args.policy, mesh=mesh,
                      device=args.device if device is None else device, **kw)
        if mesh is not None:
            echo(f"tensor parallel: tp{mesh.size()} ('model',) mesh, {mesh!r}; rank 0 "
                 f"holds {tree_nbytes(pipe.params)/2**20:.1f} MB of the weights")
    echo(f"model bytes {pipe.fp_bytes/2**20:.1f} MB -> "
         f"{pipe.quantized_bytes/2**20:.1f} MB "
         f"({args.policy} = {pipe.spec_str}, {pipe.compression:.2f}x)")
    if args.draft_spec is not None:
        echo(f"speculative draft arm: {args.draft_spec} = "
             f"{pipe.draft_spec_str}, lookahead {args.draft_lookahead}")

    cfg = pipe.cfg
    # sources up to the engine's cross capacity (default enc_len); the
    # decoder budget (1-token language-code prompt + gen) is independent
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0) \
        if cfg.family == "encdec" else None

    metrics_srv = snap = None
    if args.metrics_port is not None:
        render = pipe.engine.prometheus
        if dp > 1 and tp > 1:
            # a collective: every rank renders at the end of each round
            snap = MetricsSnapshot(render)
            render = snap
        if lead:
            metrics_srv = MetricsServer(render, port=args.metrics_port).start()
            echo(f"metrics: live at {metrics_srv.url}")

    t0 = time.perf_counter()
    for i in range(args.requests):
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, eos_id=args.eos_id,
                            max_new_tokens=args.gen, seed=i,
                            deadline_ms=args.deadline_ms)
        if ds is not None:
            b = ds.sample(1)
            req = {"src_tokens": b["src_tokens"], "tgt_in": b["tgt_in"][:, :1]}
        else:
            # the reference launcher's prompts: randint(PRNGKey(i)), 4-7
            # tokens (bucketing keeps the prefill shapes few)
            req = {"tokens": prng.randint(prng.prng_key(i), (1, 4 + i % 4), 0,
                                          cfg.vocab_size)}
        # backpressure: a saturated queue is a typed signal, not a crash —
        # run one scheduler round and retry with backoff
        backoff = 0.01
        while True:
            try:
                rid = pipe.engine.submit(req, sp)
                break
            except EngineSaturated as exc:
                echo(f"saturated ({exc.pending}/{exc.limit} pending), "
                     f"stepping + retrying in {backoff*1e3:.0f} ms")
                pipe.engine.step()
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.5)
        echo(f"[req {rid}] queued (pending={pipe.engine.num_pending}, "
             f"active={pipe.engine.num_active})")

    # outputs stream back as each request finishes, not at the drain
    outs = []
    for o in pipe.engine.stream(on_round=None if snap is None else snap.refresh):
        outs.append(o)
        echo(f"[req {o.request_id}] slot {o.slot} {o.finish_reason:6s} "
             f"ttft {o.ttft_ms:6.1f} ms tpot {o.tpot_ms:5.2f} ms: "
             f"{o.token_ids}")
    dt = time.perf_counter() - t0
    done_tokens = sum(o.num_generated for o in outs)
    m = pipe.engine.metrics()
    line = (f"served {args.requests} requests, {done_tokens} tokens in "
            f"{dt:.2f}s ({done_tokens/dt:.1f} tok/s host, "
            f"{m.prefill_compiles} prefill compiles, "
            f"{m.decode_syncs} decode syncs @ "
            f"{m.mean_tokens_per_sync:.1f} tok/sync, "
            f"{m.overlap_rounds} overlapped rounds, "
            f"occupancy {m.occupancy:.2f}")
    if args.paged:
        line += (f", page util {m.page_utilization:.2f}, "
                 f"kv {m.kv_cache_bytes/2**20:.2f} MB")
    if args.draft_spec is not None:
        line += (f", acceptance {m.acceptance_rate:.2f} "
                 f"({m.accepted_tokens}/{m.drafted_tokens} drafted, "
                 f"{m.verify_calls} verify rounds)")
    echo(line + ")")
    echo(f"latency: ttft p50/p95 {m.ttft_p50_ms:.1f}/{m.ttft_p95_ms:.1f} "
         f"ms, tpot p50/p95 {m.tpot_p50_ms:.2f}/{m.tpot_p95_ms:.2f} ms")
    # shutdown fault summary: zero across the board on a healthy run
    echo(f"faults: {m.preemptions} preemptions "
         f"({m.resumed_requests} resumed), "
         f"{m.deadline_expirations} deadline expirations, "
         f"{m.admission_rejections} admission rejections, "
         f"{m.slot_errors} slot errors")
    if args.trace_out and lead:
        echo(f"phases: admit {m.phase_admit_ms:.1f} ms, dispatch "
             f"{m.phase_dispatch_ms:.1f} ms, sync {m.phase_sync_ms:.1f} "
             f"ms, walk {m.phase_walk_ms:.1f} ms")
        pipe.tracer.dump_json(args.trace_out)
        echo(f"trace: {len(pipe.tracer)} events "
             f"({pipe.tracer.dropped} dropped) -> {args.trace_out}")
    if args.metrics_out:
        text = pipe.engine.prometheus()     # every rank: a composed stack's is a collective
        if lead:
            with open(args.metrics_out, "w") as f:
                f.write(text)
        echo(f"metrics: prometheus text -> {args.metrics_out}")
    if metrics_srv is not None:
        metrics_srv.close()
        echo("metrics: endpoint closed")
    # a composed stack's controller: this rank's replica's
    ctl = getattr(getattr(pipe.engine, "own", pipe.engine), "sla", None)
    if ctl is not None:
        held = ctl.holding()
        echo(f"sla: target ttft_p95 {args.sla_ttft_ms} ms / tpot_p95 "
             f"{args.sla_tpot_ms} ms -> horizon {ctl.horizon}, "
             f"prefill cap {ctl.prefill_cap}, {ctl.retunes} retunes, "
             f"held={'n/a' if held is None else held}")


if __name__ == "__main__":
    main()
