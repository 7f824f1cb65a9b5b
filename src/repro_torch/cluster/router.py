"""Data-parallel replica routing over independent ServeEngines.

One continuous-batching engine caps out at its slot count; a
:class:`ReplicaRouter` owns N independent engine replicas and presents
the engine's own request surface, so every caller of an engine
(``TranslationPipeline``, the eval suite, the launcher) serves through a
cluster by swapping the object behind ``.engine``:

    router = ReplicaRouter([engine0, engine1, ...])
    gid  = router.submit(inputs, SamplingParams(...))
    outs = router.run_until_drained()          # fans over replicas

Routing policy
--------------
``submit()`` places each request on the replica with the least
outstanding work, where "outstanding" defers to per-request
``SamplingParams.priority``: a priority-p request counts only live
requests of priority >= p as competition, tie-broken by total backlog
then replica index, so routed runs are reproducible. A saturated replica
(``EngineSaturated`` from its bounded queue) is skipped for the
next-least-loaded one; the typed error is re-raised only when every
replica is saturated, with cluster-wide pending / limit totals.

Request ids returned by the router are global: the router remaps each
replica's local ids, so two replicas assigning the same local id never
collide in caller-visible outputs. ``abort`` routes to the owning
replica.

Draining (``run_until_drained`` / ``stream``) interleaves every busy
replica's overlapped round generator (``ServeEngine.serve_rounds``) one
round at a time: while the host waits on one replica's token block, the
other replicas' dispatched horizons keep running. Token streams are
per request those of a lone engine serving the same request (replicas
share nothing).

Metrics merge through ``serving.metrics.merge_metrics`` and
``obs.Histogram.merge`` (counters sum; latency percentiles come from the
merged histograms, never from averaging per-replica percentiles);
``prometheus()`` renders the merged cluster snapshot plus a per-replica
section labelled ``{replica="i"}``. The router is host code only: the
reference's ``cluster/router.py`` line for line.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

from ..obs import Histogram
from ..obs.metrics import render_prometheus, render_prometheus_labeled
from ..serving.metrics import EngineMetrics, merge_metrics
from ..serving.params import EngineSaturated, Request, RequestOutput, SamplingParams

__all__ = ["ReplicaRouter"]


class ReplicaRouter:
    """Least-outstanding-work router over N independent engine replicas.

    Presents the ``ServeEngine`` request surface (submit / step /
    run_until_drained / stream / abort / metrics / prometheus /
    reset_metrics / num_pending / num_active) so a
    ``TranslationPipeline`` can carry a router as its ``engine``.
    """

    def __init__(self, replicas: Sequence):
        self.replicas: List = list(replicas)
        if not self.replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self._next_gid = 0
        # gid -> (replica idx, local id, priority); entries live from
        # submit until the remapped output is handed to the caller
        self._owner: dict = {}
        # per-replica local id -> gid (the reverse map used on claim)
        self._local: List[dict] = [dict() for _ in self.replicas]

    # -- routing -------------------------------------------------------------

    def _competing(self, ridx: int, priority: int) -> int:
        """Live requests on replica ``ridx`` that outrank or match
        ``priority``."""
        return sum(1 for (r, _lid, p) in self._owner.values()
                   if r == ridx and p >= priority)

    def _order(self, priority: int) -> List[int]:
        """Replica indices, least loaded first: fewest >= priority
        competitors, then total backlog, then index."""
        def key(i: int):
            eng = self.replicas[i]
            return (self._competing(i, priority), eng.num_pending + eng.num_active, i)
        return sorted(range(len(self.replicas)), key=key)

    def submit(self, request, params: Optional[SamplingParams] = None, *,
               on_token: Optional[Callable[[int], None]] = None) -> int:
        """Route one request to the least-loaded replica; returns its
        cluster-global request id.

        Skips saturated replicas in load order and re-raises
        ``EngineSaturated``, with cluster-wide totals, only when every
        replica rejected. Validation errors (an over-long request, an
        unfittable page reservation) raise from the first replica tried:
        they would fail alike everywhere.
        """
        if params is not None:
            priority = params.priority
        elif isinstance(request, Request):
            priority = request.params.priority
        else:
            priority = 0
        for i in self._order(priority):
            try:
                lid = self.replicas[i].submit(request, params, on_token=on_token)
            except EngineSaturated:
                continue
            gid = self._next_gid
            self._next_gid += 1
            self._owner[gid] = (i, lid, priority)
            self._local[i][lid] = gid
            return gid
        raise EngineSaturated(sum(e.num_pending for e in self.replicas),
                              sum(e.max_pending or 0 for e in self.replicas))

    def _remap(self, ridx: int, outs: Sequence[RequestOutput]) -> List[RequestOutput]:
        remapped = []
        for out in outs:
            gid = self._local[ridx].pop(out.request_id)
            self._owner.pop(gid, None)
            remapped.append(dataclasses.replace(out, request_id=gid))
        return remapped

    def _claim(self, ridx: int) -> List[RequestOutput]:
        return self._remap(ridx, self.replicas[ridx].take_finished())

    # -- serving -------------------------------------------------------------

    def step(self, horizon: Optional[int] = None) -> List[RequestOutput]:
        """One scheduler round on every replica with work; returns the
        remapped outputs of every request that finished."""
        outs: List[RequestOutput] = []
        for i, eng in enumerate(self.replicas):
            if eng.num_pending or eng.num_active:
                eng.step(horizon)
            outs.extend(self._claim(i))
        return outs

    def stream(self, horizon: Optional[int] = None,
               on_round: Optional[Callable[[], None]] = None,
               max_rounds: int = 1_000_000) -> Iterator[RequestOutput]:
        """Serve until every replica drains, yielding each remapped
        RequestOutput as its request finishes. One cluster round
        advances every busy replica by one round; ``on_round`` fires once
        per cluster round, and work it submits keeps the loop alive."""
        for i in range(len(self.replicas)):
            yield from self._claim(i)
        rounds: dict = {}
        try:
            for _ in range(max_rounds):
                for i, eng in enumerate(self.replicas):
                    if i not in rounds and (eng.num_pending or eng.num_active):
                        rounds[i] = eng.serve_rounds(horizon)
                if not rounds:
                    break
                for i in sorted(rounds):
                    try:
                        next(rounds[i])
                    except StopIteration:
                        del rounds[i]
                    yield from self._claim(i)
                if on_round is not None:
                    on_round()
        finally:
            for gen in rounds.values():
                gen.close()     # walks any dispatched-ahead block
        for i in range(len(self.replicas)):
            yield from self._claim(i)

    def run_until_drained(self, max_steps: int = 1_000_000,
                          horizon: Optional[int] = None) -> List[RequestOutput]:
        """Serve every queued or in-flight request across all replicas;
        returns all remapped outputs."""
        return list(self.stream(horizon=horizon, max_rounds=max_steps))

    def stream_request(self, request, params=None, horizon=None):
        """Not supported at the router level: streaming one request binds
        the caller to one replica's round loop, which would stall the
        others. Submit with ``on_token=`` and drive ``stream()``."""
        raise NotImplementedError(
            "ReplicaRouter does not stream single requests; use "
            "submit(..., on_token=cb) + stream(), or deploy a "
            "single-engine pipeline for translate_stream()")

    def abort(self, request_id: int) -> Optional[RequestOutput]:
        """Cancel a routed request on its owning replica. Returns the
        remapped output (finish_reason 'abort'), or None if the id is
        unknown or the request already finished."""
        info = self._owner.get(request_id)
        if info is None:
            return None
        ridx, lid, _ = info
        out = self.replicas[ridx].abort(lid)
        if out is None:
            return None
        return self._remap(ridx, [out])[0]

    # -- cluster state and metrics -------------------------------------------

    @property
    def max_len(self) -> int:
        """Per-request cache budget (the least over replicas)."""
        return min(e.max_len for e in self.replicas)

    @property
    def trace(self):
        """Replica 0's tracer (the rest through ``replicas[i].trace``)."""
        return self.replicas[0].trace

    @property
    def num_pending(self) -> int:
        return sum(e.num_pending for e in self.replicas)

    @property
    def num_active(self) -> int:
        return sum(e.num_active for e in self.replicas)

    def merged_latency_histograms(self) -> dict:
        """Fresh Histograms holding every replica's TTFT / TPOT samples
        (the replicas' own histograms are never mutated)."""
        merged = {"ttft_ms": Histogram(), "tpot_ms": Histogram()}
        for eng in self.replicas:
            for name, h in eng.latency_histograms().items():
                merged[name].merge(h)
        return merged

    def metrics(self) -> EngineMetrics:
        """One merged cluster snapshot: counters summed across replicas,
        latency percentiles from the merged histograms."""
        hists = self.merged_latency_histograms()
        return merge_metrics([e.metrics() for e in self.replicas],
                             ttft_hist=hists["ttft_ms"], tpot_hist=hists["tpot_ms"])

    def prometheus(self) -> str:
        """Prometheus text: the merged snapshot and histograms under
        ``repro_cluster_*``, then a per-replica section under
        ``repro_cluster_replica_*`` labelled ``replica``."""
        text = render_prometheus(self.metrics(), self.merged_latency_histograms(),
                                 prefix="repro_cluster")
        text += render_prometheus_labeled(
            [({"replica": str(i)}, eng.metrics()) for i, eng in enumerate(self.replicas)],
            prefix="repro_cluster_replica")
        return text

    def reset_metrics(self) -> None:
        for eng in self.replicas:
            eng.reset_metrics()
