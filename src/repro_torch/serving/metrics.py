"""Engine-level serving metrics and SLA-aware admission control.

``EngineMetrics`` is the one snapshot type for everything the engine
counts, returned frozen by ``ServeEngine.metrics()``. Counters
accumulate across rounds and reset together via ``reset_metrics()``;
the two gauge fields (``kv_cache_bytes``, ``prefill_compiles``) are
recomputed from live engine state at snapshot time, and
``EngineMetrics.GAUGES`` names them. The fields are the reference's, one
for one, so the port's snapshot compares field by field with the JAX
engine's; the speculative-decoding, deadline and admission-rejection
counters stay 0 until those serving features are ported.
``prefill_compiles`` counts distinct prefill shapes, as the reference
does; the eager port compiles nothing per shape.

``SLATarget`` + ``SLAController`` close the serving loop on latency:
``deploy(..., sla=SLATarget(p95_ttft_ms=...))`` attaches a controller
that folds every retired request's TTFT/TPOT into a sliding window and
retunes two admission knobs against the measured p95s —

* the effective fused-decode **horizon** (a long horizon amortizes the
  host sync, so it lowers TPOT, but admission waits for horizon
  boundaries, so it raises queued-prompt TTFT), and
* the paged **prefill group cap** (how many queued prompts one batched
  prefill admits).

The controller is percentile-feedback only: it never inspects queue
depth or arrival-rate estimates.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

from ..obs.metrics import Histogram, percentile

__all__ = ["EngineMetrics", "SLATarget", "SLAController", "merge_metrics"]


@dataclasses.dataclass(frozen=True)
class EngineMetrics:
    """Frozen snapshot of every engine counter + derived ratio.

    All fields except those named in ``GAUGES`` are run-scoped: they
    start at zero, accumulate monotonically, and ``reset_metrics()``
    zeroes them (reset after a warm-up so that it never
    pollutes measured rates).
    """

    # decode-loop counters
    decode_steps: int            # decode micro-steps dispatched (incl. masked)
    decode_syncs: int            # host blocks on a device token buffer
    synced_tokens: int           # tokens actually emitted to requests
    active_slot_steps: int       # slot-steps that served a live request
    page_slot_steps: int         # page-steps attended (paged occupancy basis)
    overlap_rounds: int          # horizons dispatched before the previous sync
    # speculative-decoding counters
    verify_calls: int
    drafted_tokens: int
    accepted_tokens: int
    rejected_tokens: int
    # fault-tolerance counters
    preemptions: int             # requests evicted for page pressure
    resumed_requests: int        # preempted requests re-admitted (replay)
    deadline_expirations: int    # requests retired past deadline_ms
    admission_rejections: int    # submits bounced with EngineSaturated
    slot_errors: int             # slots failed by the NaN/Inf logits guard
    # derived ratios (0.0 when the denominator counter is still zero)
    mean_tokens_per_sync: float
    occupancy: float             # active slot-steps / dispatched slot-steps
    page_utilization: float
    acceptance_rate: float
    mean_accepted_per_verify: float
    # latency percentiles over retirements since the last reset (from
    # the engine's always-on obs.Histogram accumulators; 0.0 before the
    # first retirement — bucket upper edges, nearest rank)
    ttft_p50_ms: float
    ttft_p95_ms: float
    tpot_p50_ms: float
    tpot_p95_ms: float
    # scheduler round-phase totals (ms); populated only on a traced
    # engine — phase timing needs the tracer's extra clock reads, and
    # the untraced round loop must stay zero-cost
    phase_admit_ms: float
    phase_dispatch_ms: float
    phase_sync_ms: float
    phase_walk_ms: float
    # gauges — live engine state, not resettable accumulation
    kv_cache_bytes: int
    prefill_compiles: int

    GAUGES: ClassVar[Tuple[str, ...]] = ("kv_cache_bytes", "prefill_compiles")

    def as_dict(self) -> Dict[str, float]:
        """Plain dict for JSON rows (benchmarks, eval reports)."""
        return dataclasses.asdict(self)


def _weighted_mean(pairs: Sequence[Tuple[float, float]]) -> float:
    """sum(v * w) / sum(w), 0.0 when no weight accumulated."""
    den = sum(w for _, w in pairs)
    return sum(v * w for v, w in pairs) / den if den else 0.0


def merge_metrics(snapshots: Sequence[EngineMetrics],
                  ttft_hist: Optional[Histogram] = None,
                  tpot_hist: Optional[Histogram] = None) -> EngineMetrics:
    """Aggregate per-replica EngineMetrics into one cluster snapshot.

    Counters and gauges sum. Derived ratios recompute from the summed
    counters where the snapshot retains both sides of the division
    (mean_tokens_per_sync, acceptance_rate, mean_accepted_per_verify);
    occupancy and page_utilization — whose denominators fold in
    per-engine slot/pool sizes that a snapshot does not carry — merge
    as decode_steps-weighted means, which equals the pooled ratio when
    replicas are homogeneous (the router's deployment mode). Latency
    percentiles come from ``ttft_hist``/``tpot_hist`` when given —
    build them by ``Histogram.merge``-ing every replica's accumulators
    into a fresh ``Histogram()`` — and are 0.0 otherwise (a sum or
    mean of percentiles would be statistically meaningless).
    """
    if not snapshots:
        raise ValueError("merge_metrics needs at least one snapshot")

    def tot(field: str):
        return sum(getattr(s, field) for s in snapshots)

    decode_syncs = tot("decode_syncs")
    synced_tokens = tot("synced_tokens")
    drafted = tot("drafted_tokens")
    accepted = tot("accepted_tokens")
    verify_calls = tot("verify_calls")

    def pct(hist: Optional[Histogram], q: float) -> float:
        return round(hist.percentile(q), 4) if hist is not None else 0.0

    return EngineMetrics(
        decode_steps=tot("decode_steps"),
        decode_syncs=decode_syncs,
        synced_tokens=synced_tokens,
        active_slot_steps=tot("active_slot_steps"),
        page_slot_steps=tot("page_slot_steps"),
        overlap_rounds=tot("overlap_rounds"),
        verify_calls=verify_calls,
        drafted_tokens=drafted,
        accepted_tokens=accepted,
        rejected_tokens=tot("rejected_tokens"),
        preemptions=tot("preemptions"),
        resumed_requests=tot("resumed_requests"),
        deadline_expirations=tot("deadline_expirations"),
        admission_rejections=tot("admission_rejections"),
        slot_errors=tot("slot_errors"),
        mean_tokens_per_sync=(synced_tokens / decode_syncs
                              if decode_syncs else 0.0),
        occupancy=_weighted_mean([(s.occupancy, s.decode_steps)
                                  for s in snapshots]),
        page_utilization=_weighted_mean([(s.page_utilization, s.decode_steps)
                                         for s in snapshots]),
        acceptance_rate=accepted / drafted if drafted else 0.0,
        mean_accepted_per_verify=(accepted / verify_calls
                                  if verify_calls else 0.0),
        ttft_p50_ms=pct(ttft_hist, 50.0),
        ttft_p95_ms=pct(ttft_hist, 95.0),
        tpot_p50_ms=pct(tpot_hist, 50.0),
        tpot_p95_ms=pct(tpot_hist, 95.0),
        phase_admit_ms=round(tot("phase_admit_ms"), 4),
        phase_dispatch_ms=round(tot("phase_dispatch_ms"), 4),
        phase_sync_ms=round(tot("phase_sync_ms"), 4),
        phase_walk_ms=round(tot("phase_walk_ms"), 4),
        kv_cache_bytes=tot("kv_cache_bytes"),
        prefill_compiles=tot("prefill_compiles"))


@dataclasses.dataclass(frozen=True)
class SLATarget:
    """Latency objectives for SLA-aware admission.

    Either percentile target may be ``None`` (unconstrained). ``window``
    is how many request completions feed one retune decision — small
    windows react fast but chase noise; the default suits smoke-scale
    benchmarks. ``min_horizon``/``max_horizon`` bound the controller
    (``max_horizon=None`` means the deployed horizon is the ceiling).
    """

    p95_ttft_ms: Optional[float] = None
    p95_tpot_ms: Optional[float] = None
    window: int = 16
    min_horizon: int = 1
    max_horizon: Optional[int] = None

    def __post_init__(self):
        if self.p95_ttft_ms is None and self.p95_tpot_ms is None:
            raise ValueError("SLATarget needs p95_ttft_ms or p95_tpot_ms "
                             "(both None constrains nothing)")
        for name in ("p95_ttft_ms", "p95_tpot_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.min_horizon < 1:
            raise ValueError("min_horizon must be >= 1")
        if self.max_horizon is not None and self.max_horizon < self.min_horizon:
            raise ValueError("max_horizon < min_horizon")


class SLAController:
    """Percentile feedback loop over request completions.

    The engine calls ``observe(output)`` at every retirement; once a full
    window has accumulated the controller compares measured p95 TTFT/TPOT
    against the target and moves its two knobs:

    * p95 TTFT over target → **halve the horizon** and **halve the
      prefill group cap**: queued prompts admit at scan boundaries, so
      shorter scans and smaller admission groups get first tokens out
      sooner at some sync-rate cost.
    * p95 TPOT over target (TTFT fine) → **double the horizon** back:
      steady-state token cadence is gated by host syncs per token.
    * both under target → relax one step toward the deployed
      configuration (horizon first, then group cap), so a transient
      burst doesn't pin the engine in its defensive posture forever.

    TTFT wins ties: a breached first-token SLA is user-visible queueing,
    a breached TPOT usually follows from the same congestion.
    """

    def __init__(self, target: SLATarget, horizon: int, slots: int):
        self.target = target
        self.base_horizon = max(1, int(horizon))
        self.max_horizon = (target.max_horizon
                            if target.max_horizon is not None
                            else self.base_horizon)
        self.max_horizon = max(self.max_horizon, target.min_horizon)
        self.horizon = min(self.base_horizon, self.max_horizon)
        self.slots = max(1, int(slots))
        self.prefill_cap = self.slots
        self.retunes = 0
        self.windows = 0
        self.last: Dict[str, float] = {}
        self._window: List[Tuple[float, float]] = []

    def observe(self, output) -> bool:
        """Fold one retired RequestOutput; True if a retune fired."""
        return bool(self.fold([(output.ttft_ms, output.tpot_ms)]))

    def fold(self, pairs) -> int:
        """Fold ``(ttft_ms, tpot_ms)`` pairs in order, as that many
        ``observe`` calls would; returns the retunes that fired. A
        tensor-parallel engine folds rank 0's pairs on every rank at a
        round boundary, so ``holding()`` and ``retunes`` read alike on
        every rank."""
        fired = 0
        for ttft, tpot in pairs:
            self._window.append((ttft, tpot))
            if len(self._window) >= self.target.window:
                fired += self._retune()
        return fired

    def _p95(self, idx: int) -> float:
        # the repo-wide nearest-rank definition (obs.metrics.percentile
        # was lifted from this controller, so consolidating onto it
        # changed no admission decisions)
        return percentile((w[idx] for w in self._window), 95.0)

    def _retune(self) -> bool:
        ttft, tpot = self._p95(0), self._p95(1)
        self._window.clear()
        self.windows += 1
        self.last = {"ttft_p95_ms": ttft, "tpot_p95_ms": tpot}
        t = self.target
        old = (self.horizon, self.prefill_cap)
        if t.p95_ttft_ms is not None and ttft > t.p95_ttft_ms:
            self.horizon = max(t.min_horizon, self.horizon // 2)
            self.prefill_cap = max(1, self.prefill_cap // 2)
        elif t.p95_tpot_ms is not None and tpot > t.p95_tpot_ms:
            self.horizon = min(self.max_horizon, max(1, self.horizon * 2))
        elif self.horizon < min(self.base_horizon, self.max_horizon):
            self.horizon = min(self.base_horizon, self.max_horizon,
                               self.horizon * 2)
        elif self.prefill_cap < self.slots:
            self.prefill_cap = min(self.slots, self.prefill_cap * 2)
        changed = (self.horizon, self.prefill_cap) != old
        self.retunes += int(changed)
        return changed

    def holding(self) -> Optional[bool]:
        """Did the last full window meet the target? None before one."""
        if not self.last:
            return None
        t = self.target
        ok = True
        if t.p95_ttft_ms is not None:
            ok &= self.last["ttft_p95_ms"] <= t.p95_ttft_ms
        if t.p95_tpot_ms is not None:
            ok &= self.last["tpot_p95_ms"] <= t.p95_tpot_ms
        return ok
