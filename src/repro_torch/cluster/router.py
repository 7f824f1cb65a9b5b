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

Composed dp x tp stacks
-----------------------
Under ``deploy_replicas(tp=K)`` each replica is a tensor-parallel engine
on its own group of K ranks, and no process holds every replica. The
control plane is replicated instead: every one of the N·K ranks runs a
:class:`GroupRouter`, the same placement rules over N
:class:`GroupReplica` handles, its own group's engine and N-1 mirrors of
the others. Each call that changes a replica (a submit, an abort) ends in
one broadcast from that replica group's rank 0 of its outcome and its
engine's queue and slot counts; each cluster round runs the rank's own
engine one round, then gathers every group's record (whether its round
loop ended, its counts, its finished outputs). So every rank's router
sees the same counts, places the next request alike and returns the
same outputs, timings included (group rank 0's); routing stays
host-only and deterministic, and only these records cross groups.

``on_token`` streams on every rank: the owning group's engine records
each token it emits, with its request, in emission order; the lead's
record rides the next broadcast of that replica (a submit's outcome, an
abort's, the round's gather), and every rank then calls the caller's
callback for each token in the lead's order, before it claims the
outputs finished in that round. So a mirror sees a token in the round
it was emitted, and every rank's streamed tokens equal the drained
``token_ids``. Each group decides what reads a clock on its own rank 0
(the engine's control channel); an expiry that frees a slot reaches
every rank's placement through the counts of the round's gather.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

from ..obs import Histogram
from ..obs.metrics import render_prometheus, render_prometheus_labeled
from ..serving.metrics import EngineMetrics, merge_metrics
from ..serving.params import EngineSaturated, Request, RequestOutput, SamplingParams

__all__ = ["ReplicaRouter", "GroupReplica", "GroupRouter"]


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


# ---------------------------------------------------------------------------
# composed dp x tp stacks: a replicated control plane over replica groups
# ---------------------------------------------------------------------------

def _broadcast(obj, src: int):
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class _Tap:
    """The engine-side ``on_token`` of a routed request: each token lands
    in its replica's log beside the request's local id (set once
    ``submit`` returns it; a dense engine emits the first token inside
    ``submit``)."""

    __slots__ = ("log", "lid")

    def __init__(self, log: list):
        self.log, self.lid = log, None

    def __call__(self, tok: int) -> None:
        self.log.append((self, int(tok)))


class GroupReplica:
    """One replica of a composed dp x tp stack as one rank sees it: its
    own group's tensor-parallel engine (``engine``), or a mirror of
    another group's (``engine`` None). ``lead`` is the global rank of the
    replica group's rank 0, whose broadcasts every handle of this replica
    replays. Every rank calls its handles in the same order (the
    :class:`GroupRouter` is replicated), so each collective meets its
    peers. The counts are the engine's as of the last broadcast."""

    def __init__(self, lead: int, engine, max_len: int, max_pending: Optional[int]):
        self.lead, self.engine = lead, engine
        self.max_len, self.max_pending = max_len, max_pending
        self.num_pending = self.num_active = 0
        self._finished: List[RequestOutput] = []
        self._log: list = []        # (tap, token) this rank's engine emitted
        self._taps: dict = {}       # local id -> the caller's on_token

    def _emitted(self) -> list:
        """Take this rank's log as ``(local id, token)`` pairs, in emission
        order (the lead's is the one every rank replays)."""
        out = [(tap.lid, tok) for tap, tok in self._log]
        self._log.clear()           # the taps hold this list
        return out

    def _deliver(self, emitted, finished=()) -> None:
        """Call the caller's callbacks for the lead's ``emitted`` tokens,
        in order, then forget those of the ``finished`` local ids."""
        for lid, tok in emitted:
            cb = self._taps.get(lid)
            if cb is not None:
                cb(tok)
        for lid in finished:
            self._taps.pop(lid, None)

    def _counts(self):
        e = self.engine
        return None if e is None else (e.num_pending, e.num_active)

    def _settle(self, value, counts):
        self.num_pending, self.num_active = counts
        return value

    def submit(self, request, params: Optional[SamplingParams] = None, *,
               on_token: Optional[Callable[[int], None]] = None) -> int:
        """The engine's submit on the replica's own group, then the lead's
        outcome on every rank: its local id, or the error it raised (the
        typed EngineSaturated, a validation error) raised alike. With
        ``on_token`` the engine records the request's tokens, and every
        rank calls ``on_token`` with the lead's (the first token of a
        dense admission before this returns, as one engine does)."""
        outcome = None
        if self.engine is not None:
            tap = None if on_token is None else _Tap(self._log)
            try:
                outcome = ("ok", self.engine.submit(request, params, on_token=tap))
                if tap is not None:
                    tap.lid = outcome[1]
            except EngineSaturated as exc:
                outcome = ("saturated", (exc.pending, exc.limit))
            except (ValueError, TypeError, NotImplementedError) as exc:
                outcome = ("error", exc)
            outcome += (self._counts(), self._emitted())
        kind, value, counts, emitted = _broadcast(outcome, self.lead)
        self._settle(None, counts)
        if kind == "ok" and on_token is not None:
            self._taps[value] = on_token
        self._deliver(emitted)
        if kind == "saturated":
            raise EngineSaturated(*value)
        if kind == "error":
            raise value
        return value

    def abort(self, request_id: int) -> Optional[RequestOutput]:
        out = None if self.engine is None else self.engine.abort(request_id)
        out, counts, emitted = _broadcast((out, self._counts(), self._emitted()), self.lead)
        self._deliver(emitted, () if out is None else (request_id,))
        return self._settle(out, counts)

    def take_finished(self) -> List[RequestOutput]:
        """The lead's outputs of the replica gathered by the last cluster
        round."""
        out, self._finished = self._finished, []
        return out

    def metrics(self):
        return _broadcast(None if self.engine is None else self.engine.metrics(),
                          self.lead)

    def latency_histograms(self):
        return _broadcast(None if self.engine is None
                          else self.engine.latency_histograms(), self.lead)

    def reset_metrics(self) -> None:
        if self.engine is not None:
            self.engine.reset_metrics()

    @property
    def device(self):
        return None if self.engine is None else self.engine.device

    @property
    def trace(self):
        return None if self.engine is None else self.engine.trace


class GroupRouter(ReplicaRouter):
    """The replicated control plane of a composed dp x tp stack (module
    docstring): :class:`ReplicaRouter`'s placement over
    :class:`GroupReplica` handles, ``group`` the index of this rank's own
    replica. A cluster round runs this rank's engine one round, then
    gathers every group lead's record over the world group; the claims
    follow in replica order, as the in-process router makes them."""

    def __init__(self, replicas: Sequence[GroupReplica], group: int):
        super().__init__(replicas)
        self.group = group

    @property
    def own(self):
        """This rank's own replica engine (its group's tensor-parallel
        engine)."""
        return self.replicas[self.group].engine

    def _exchange(self, ended: bool, outs=()) -> set:
        """Every group lead's record of the round (its round loop ended,
        its queue and slot counts, its finished outputs, the tokens its
        engine emitted for ``on_token``) to every rank, which streams the
        tokens, then queues the outputs for claiming; returns the
        replicas whose round loop ended."""
        import torch.distributed as dist
        eng, mine = self.own, self.replicas[self.group]
        finished = list(outs) + eng.take_finished()
        emitted = mine._emitted()
        rec = None
        if dist.get_rank() == mine.lead:
            rec = (ended, eng.num_pending, eng.num_active, finished, emitted)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rec)
        done = set()
        for i, h in enumerate(self.replicas):
            ended_i, h.num_pending, h.num_active, got, toks = every[h.lead]
            h._deliver(toks, [o.request_id for o in got])
            h._finished.extend(got)
            if ended_i:
                done.add(i)
        return done

    def _claim_all(self) -> List[RequestOutput]:
        return [o for i in range(len(self.replicas)) for o in self._claim(i)]

    def step(self, horizon: Optional[int] = None) -> List[RequestOutput]:
        h = self.replicas[self.group]
        outs = self.own.step(horizon) if h.num_pending or h.num_active else []
        self._exchange(False, outs)
        return self._claim_all()

    def stream(self, horizon: Optional[int] = None,
               on_round: Optional[Callable[[], None]] = None,
               max_rounds: int = 1_000_000) -> Iterator[RequestOutput]:
        self._exchange(False)
        yield from self._claim_all()
        live: set = set()
        own = None
        try:
            for _ in range(max_rounds):
                for i, h in enumerate(self.replicas):
                    if i not in live and (h.num_pending or h.num_active):
                        live.add(i)
                        if i == self.group:
                            own = self.own.serve_rounds(horizon)
                if not live:
                    break
                ended = False
                if self.group in live:
                    try:
                        next(own)
                    except StopIteration:
                        ended = True
                done = self._exchange(ended)
                for i in sorted(live):
                    if i in done:
                        live.discard(i)
                    yield from self._claim(i)
                if on_round is not None:
                    on_round()
        finally:
            if own is not None:
                own.close()     # walks any dispatched-ahead block
        self._exchange(False)
        yield from self._claim_all()

    @property
    def trace(self):
        """This rank's own engine's tracer."""
        return self.own.trace
