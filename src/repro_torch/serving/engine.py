"""Scheduler-owned serving engine: continuous batching with
horizon-fused decode, over a dense or a block-paged KV cache.

    rid  = engine.submit(inputs, SamplingParams(...))   # enqueue
    outs = engine.step()       # admit + one fused decode horizon
    outs = engine.run_until_drained()                   # serve everything

Admission prefills each queued request (prompt right-padded to its
power-of-two bucket, true length in ``lengths``) and samples its first
token from the logits at ``length - 1``. The dense engine (the default)
admits at ``submit`` when a slot is free: it prefills one request at a
time into a one-slot cache and splices it into the ``(slots, max_len)``
batch cache. The paged engine (``paged=True``) admits at the next round,
so a burst of submits lands as one batched prefill of same-shaped
requests whose prompt K/V scatters into page chains.

A decode horizon runs ``K`` decode + sample micro-steps on the device
with per-slot ``alive`` / remaining-budget masks — a slot that emits its
``eos_id`` or exhausts ``max_new_tokens`` keeps decoding into masked
positions (the trash page when paged), frozen — and its ``(K, slots)``
token block comes to the host once. The host walk emits, streams
(``on_token``) and retires; queued requests fill freed slots at the next
round. ``K`` is clamped to the power-of-two bucket of the largest
remaining budget.

Overlapped rounds (``overlap=True``, the default)
-------------------------------------------------
Every drain runs through ONE loop, ``_rounds()``: with a block in
flight, the next horizon is dispatched from the in-flight horizon's own
final ``alive`` / ``rem`` device tensors before the host walks the
block. On the card, dispatching means issuing the horizon's eager
launches; the block then comes back through a non-blocking copy into
pinned host memory that records a CUDA event, and the walk waits on that
event alone. Host-to-device uploads inside the round (the masks, the
block-table growth, admission's sampling knobs) go through pinned
buffers with non-blocking copies, so nothing else in a steady round
waits on the device. Slots admitted, aborted or preempted since the last
dispatch take their masks from host state (``_dirty_slots``); every
other slot's device carry equals what the walk will find, because the
in-horizon retirement rule is the walk's rule. A block is walked only
for slots whose occupant is still the request it was dispatched for
(``seqs``). Slots never attend to each other and each request draws its
noise from its own seeded stream, so the token streams depend neither on
the horizon, nor on overlap, nor on admission timing, nor on the cache
layout. ``horizon=1`` and ``overlap=False`` run serially.

On-demand paging and preemption
-------------------------------
A paged engine admits a request with its prefill feed's pages only and
grows every active chain just ahead of each dispatched horizon, so block
tables stay fixed across a horizon. When the pool runs out, the
lowest-``priority``, then youngest, request is preempted: its tokens are
stashed on the host, its chain freed, and it is requeued at the head. It
resumes by a prefill of its prompt plus all but its last stashed token;
the last stashed token is its pending decode token and its PRNG offset
restarts at the stash length, so nothing is emitted twice. In f32 on the
CPU the replay is bit-exact against incremental decode; in bf16 on the
card the prefill rows round differently from decode rows, so a resumed
stream may part from an uncontended one at a near tie. After
``preempt_limit`` evictions a request retires as ``preempted_limit``
with its prefix.

Metrics and tracing
-------------------
``metrics()`` returns one frozen ``EngineMetrics`` snapshot (counters,
ratios, TTFT / TPOT percentiles from histograms recorded at every
retirement); ``prometheus()`` renders it. ``trace=TraceConfig()`` adds
per-request lifecycle spans and scheduler phase spans (admit, dispatch,
sync, walk); every emission sits behind ``if self.trace is not None``.
``sla=SLATarget(...)`` retunes the effective horizon and the paged
prefill-group cap against the measured p95s.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import random as prng
from ..obs import PHASES, SCHED_TID, Histogram, TraceConfig, Tracer
from ..obs.metrics import render_prometheus
from ..unported import later
from .metrics import EngineMetrics, SLAController, SLATarget
from .paged_cache import TRASH_PAGE, PageAllocator, paged_insert, pages_needed
from .params import GREEDY, Request, RequestOutput, RequestStats, SamplingParams
from .sampler import ERR_TOKEN, sample_tokens, sample_tokens_scan

__all__ = ["ServeEngine", "greedy_generate", "translate"]


@dataclasses.dataclass
class _Slot:
    id: int
    tokens: list = dataclasses.field(default_factory=list)
    active: bool = False
    request: Optional[Request] = None
    seq: int = -1       # admission order (preemption picks the youngest)


class _Block:
    """A dispatched (K, slots) token block on its way to the host: on the
    card a non-blocking copy into pinned memory and the event it
    recorded; on the CPU the block itself."""

    __slots__ = ("host", "event")

    def __init__(self, block: torch.Tensor):
        self.event = None
        if block.is_cuda:
            self.host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
            self.host.copy_(block, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = block

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()        # the round's one wait on the device
        return self.host.numpy()


class ServeEngine:
    """Fixed-slot continuous-batching engine over a dense or paged KV
    cache, with an internal queue (see the module docstring)."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 kv_dtype: str = "bf16", ctx=None, paged: bool = False,
                 page_size: int = 8, num_pages: Optional[int] = None,
                 max_src_len: Optional[int] = None, horizon: int = 1,
                 overlap: bool = True, sla: Optional[SLATarget] = None,
                 preempt_limit: int = 3, trace=None, device="cuda"):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if preempt_limit < 0:
            raise ValueError(f"preempt_limit must be >= 0, got {preempt_limit}")
        if model.cfg.family != "encdec":
            raise later(f"serving the {model.cfg.family!r} family", 4)
        self.model = model
        self.params = params
        self.ctx = ctx
        self.device = torch.device(device)
        self.kv_dtype = kv_dtype
        self.max_len = max_len
        self.n_slots = slots
        self.horizon = int(horizon)
        self.enc_cap = int(max_src_len or model.cfg.enc_len)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.allocator: Optional[PageAllocator] = None
        if self.paged:
            self.max_pages = pages_needed(max_len, self.page_size)
            usable = num_pages if num_pages is not None else slots * self.max_pages
            self.allocator = PageAllocator(usable + 1, reserved=1)
            self.cache = model.init_paged_cache(slots, self.max_pages, usable + 1,
                                                self.page_size, kv_dtype,
                                                enc_len=self.enc_cap)
        else:
            self.cache = model.init_cache(slots, max_len, kv_dtype,
                                          enc_len=self.enc_cap)
        self._chains: Dict[int, list] = {}          # request id -> pages
        self.slots = [_Slot(i) for i in range(slots)]
        dev = self.device
        self.cur = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        # per-slot sampling state, read by every decode micro-step
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self._top_ps = torch.ones((slots,), dtype=torch.float32, device=dev)
        self._keys = torch.zeros((slots, 2), dtype=torch.int64, device=dev)
        self._offsets = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self._queue: collections.deque = collections.deque()
        self._finished: List[RequestOutput] = []
        self._next_id = 0
        self._stats: Dict[int, RequestStats] = {}
        self.prefill_shapes: set = set()
        # -- scheduling ------------------------------------------------
        self.overlap = bool(overlap)      # dispatch horizon N+1 before
        # slots (re)admitted, aborted or preempted since the last dispatch:
        # the carry merge takes THEIR masks from host state
        self._dirty_slots: set = set()
        self.sla = SLAController(sla, self.horizon, slots) if sla is not None else None
        # on-demand paging: every paged engine admits with the prefill
        # feed's pages and grows chains per dispatched horizon
        self.on_demand = self.paged
        self.preempt_limit = int(preempt_limit)
        self._admit_seq = 0
        self._preempted: Dict[int, list] = {}       # rid -> stashed tokens
        self._preempt_counts: Dict[int, int] = {}   # rid -> eviction count
        self._flow_ids: Dict[int, int] = {}         # rid -> open trace flow
        self._disp_len: Dict[int, int] = {}         # slot -> dispatched positions
        # -- observability ---------------------------------------------
        # trace is a Tracer, a TraceConfig (builds one) or None; every
        # emission sits behind `if self.trace is not None`
        if isinstance(trace, TraceConfig):
            trace = Tracer(trace)
        self.trace: Optional[Tracer] = trace
        self._round_no = 0
        self._ttft_hist = Histogram()
        self._tpot_hist = Histogram()
        self.reset_metrics()

    # -- request API -------------------------------------------------------

    def submit(self, request, params: Optional[SamplingParams] = None, *,
               on_token: Optional[Callable[[int], None]] = None) -> int:
        """Enqueue a request (a Request or a B=1 batch dict with
        ``src_tokens`` and ``tgt_in``); returns its id. A dense engine
        admits it at once when a slot is free (its first token, and
        ``on_token``'s first call, come before submit returns); a paged
        engine admits at the next round, so a burst of submits lands as
        one batched prefill.

        ``on_token`` (or ``Request.on_token``) is called with each token
        id as the block carrying it lands on the host; it runs on the
        scheduler's walk, so keep it cheap."""
        if not isinstance(request, Request):
            request = Request(inputs=dict(request), params=params or GREEDY)
        elif params is not None:
            request = dataclasses.replace(request, params=params)
        if on_token is not None:
            request = dataclasses.replace(request, on_token=on_token)
        sp = request.params
        if sp.deadline_ms is not None:
            raise later("request deadlines", 2)
        inputs = {}
        for key in ("tgt_in", "src_tokens"):
            t = torch.as_tensor(request.inputs[key], dtype=torch.int32).cpu()
            inputs[key] = t[None] if t.ndim == 1 else t
        prompt_len = int(inputs["tgt_in"].shape[1])
        budget = prompt_len + sp.max_new_tokens
        if budget > self.max_len:
            raise ValueError(
                f"request needs prompt_len + max_new_tokens = {prompt_len} + "
                f"{sp.max_new_tokens} = {budget} cache positions but the "
                f"engine was built with max_len={self.max_len}")
        if self.paged:
            need = pages_needed(budget, self.page_size)
            usable = self.allocator.capacity - self.allocator.reserved
            if need > usable:
                raise ValueError(f"request needs {need} KV pages but the pool "
                                 f"holds only {usable}")
        se = int(inputs["src_tokens"].shape[1])
        if se > self.enc_cap:
            raise ValueError(f"source length {se} exceeds the engine's "
                             f"cross-attention capacity {self.enc_cap}")
        request = dataclasses.replace(request, inputs=inputs, id=self._next_id)
        self._next_id += 1
        arrival = self._now()
        self._stats[request.id] = RequestStats(arrival_s=arrival, prompt_len=prompt_len)
        if self.trace is not None:
            tid = request.id + 1
            self.trace.name_track(tid, f"req {request.id}")
            self.trace.begin(tid, "request", arrival, rid=request.id,
                             prompt_len=prompt_len, max_new_tokens=sp.max_new_tokens)
            self.trace.begin(tid, "queued", arrival)
        self._queue.append(request)
        if not self.paged:          # paged admission batches at the next round
            self._admit_pending()
        return request.id

    def step(self, horizon: Optional[int] = None) -> List[RequestOutput]:
        """Admit pending requests, run one fused decode horizon, and
        return the outputs of every request finished in this step."""
        K = self._effective_horizon(horizon)
        if self.trace is not None:
            self._round_begin()
        self._round_boundary()
        if self.num_active and K == 1:
            self._token_step()
        elif self.num_active:
            _, _, block, Kd, seqs = self._dispatch_horizon(
                min(K, self._bucket(self._max_rem())))
            self._walk_block(block, Kd, seqs)
        if self.trace is not None:
            self._round_end()
        return self._take_finished()

    def run_until_drained(self, max_steps: int = 1_000_000,
                          horizon: Optional[int] = None) -> List[RequestOutput]:
        """Serve every queued and in-flight request; returns all outputs
        (the overlapped round loop; ``horizon`` overrides the engine's
        for every round)."""
        outs: List[RequestOutput] = list(self._take_finished())
        for _ in self._rounds(horizon, max_rounds=max_steps):
            outs.extend(self._take_finished())
        outs.extend(self._take_finished())
        return outs

    def stream(self, horizon: Optional[int] = None,
               on_round: Optional[Callable[[], None]] = None,
               max_rounds: int = 1_000_000) -> Iterator[RequestOutput]:
        """Serve until drained, yielding each RequestOutput as its
        request finishes. ``on_round`` is called after every round;
        requests it submits keep the loop alive. It never fires on an
        engine already drained at call time."""
        yield from self._take_finished()
        for _ in self._rounds(horizon, max_rounds=max_rounds):
            if on_round is not None:
                on_round()
            yield from self._take_finished()
        yield from self._take_finished()

    def stream_request(self, request, params: Optional[SamplingParams] = None,
                       horizon: Optional[int] = None) -> Iterator[int]:
        """Submit ONE request and yield its token ids as each block
        lands; the finished RequestOutput is the generator's return value
        (``StopIteration.value``), None if the request was aborted from
        outside. Other requests keep being served; their outputs stay
        claimable."""
        buf: List[int] = []
        rid = self.submit(request, params, on_token=buf.append)

        def claim():
            for i, o in enumerate(self._finished):
                if o.request_id == rid:
                    return self._finished.pop(i)
            return None

        out = claim()       # dense admission may already have finished it
        while buf:
            yield buf.pop(0)
        rounds = self._rounds(horizon)
        try:
            while out is None:
                try:
                    next(rounds)
                except (StopIteration, RuntimeError):
                    break   # drained (abort) or round budget exhausted
                while buf:
                    yield buf.pop(0)
                out = claim()
        finally:
            # closing the loop walks a dispatched-ahead block, so other
            # slots' synced tokens are never dropped
            rounds.close()
        while buf:
            yield buf.pop(0)
        return out

    def serve_rounds(self, horizon: Optional[int] = None,
                     max_rounds: int = 1_000_000) -> Iterator[None]:
        """The round loop itself: each ``next()`` runs one round (admit,
        dispatch ahead, sync + walk); finished outputs accumulate for
        :meth:`take_finished`. Closing it early walks a dispatched-ahead
        block."""
        return self._rounds(horizon, max_rounds=max_rounds)

    def take_finished(self) -> List[RequestOutput]:
        """Claim (and clear) the outputs finished since the last claim."""
        return self._take_finished()

    def abort(self, request_id: int) -> Optional[RequestOutput]:
        """Cancel a queued or in-flight request: returns its output
        (finish reason ``abort``, tokens cut at the last synced position,
        pages freed once), or None if the id is unknown or finished."""
        for i, r in enumerate(self._queue):
            if r.id == request_id:
                del self._queue[i]
                return self._finish_queued(r, "abort")
        for s in self.slots:
            if s.active and s.request.id == request_id:
                self._retire(s, "abort")
                return self._finished.pop()
        return None

    @property
    def num_pending(self) -> int:
        return len(self._queue)

    @property
    def num_active(self) -> int:
        return sum(s.active for s in self.slots)

    def free_slot(self) -> Optional[int]:
        return next((s.id for s in self.slots if not s.active), None)

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> EngineMetrics:
        """One frozen snapshot of every counter, ratio and gauge."""
        return EngineMetrics(
            decode_steps=self._decode_steps,
            decode_syncs=self._decode_syncs,
            synced_tokens=self._synced_tokens,
            active_slot_steps=self._active_slot_steps,
            page_slot_steps=self._page_slot_steps,
            overlap_rounds=self._overlap_rounds,
            verify_calls=0, drafted_tokens=0, accepted_tokens=0, rejected_tokens=0,
            preemptions=self._preemptions,
            resumed_requests=self._resumed,
            deadline_expirations=0, admission_rejections=0,
            slot_errors=self._slot_errors,
            mean_tokens_per_sync=self.mean_tokens_per_sync,
            occupancy=self.occupancy,
            page_utilization=self.page_utilization,
            acceptance_rate=0.0, mean_accepted_per_verify=0.0,
            ttft_p50_ms=round(self._ttft_hist.percentile(50.0), 4),
            ttft_p95_ms=round(self._ttft_hist.percentile(95.0), 4),
            tpot_p50_ms=round(self._tpot_hist.percentile(50.0), 4),
            tpot_p95_ms=round(self._tpot_hist.percentile(95.0), 4),
            phase_admit_ms=round(self._phase_ms["admit"], 4),
            phase_dispatch_ms=round(self._phase_ms["dispatch"], 4),
            phase_sync_ms=round(self._phase_ms["sync"], 4),
            phase_walk_ms=round(self._phase_ms["walk"], 4),
            kv_cache_bytes=self.kv_cache_bytes,
            prefill_compiles=len(self.prefill_shapes))

    def prometheus(self) -> str:
        """Prometheus text of metrics() plus the TTFT / TPOT and round
        phase histograms (phases record on traced engines only)."""
        hists = {"ttft_ms": self._ttft_hist, "tpot_ms": self._tpot_hist}
        for p in PHASES:
            hists[f"round_phase_{p}_ms"] = self._phase_hist[p]
        return render_prometheus(self.metrics(), hists)

    def latency_histograms(self) -> Dict[str, Histogram]:
        """The live TTFT / TPOT histograms (one sample per retirement
        since the last reset); merge them into a fresh Histogram."""
        return {"ttft_ms": self._ttft_hist, "tpot_ms": self._tpot_hist}

    def reset_metrics(self) -> None:
        """Zero every EngineMetrics counter and histogram (e.g. after a
        warm-up), and the host timers ``prefill_calls``, ``prefill_s``
        (admission prefills) and ``decode_s`` (decode dispatches and
        block waits). The gauges are live state and stay."""
        self._decode_steps = 0
        self._active_slot_steps = 0
        self._page_slot_steps = 0
        self._decode_syncs = 0
        self._synced_tokens = 0
        self._overlap_rounds = 0
        self._preemptions = 0
        self._resumed = 0
        self._slot_errors = 0
        self._ttft_hist.reset()
        self._tpot_hist.reset()
        self._phase_ms: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        self._phase_hist: Dict[str, Histogram] = {p: Histogram() for p in PHASES}
        self.prefill_calls = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0

    @property
    def decode_steps(self) -> int:
        """Decode micro-steps dispatched (masked ones included)."""
        return self._decode_steps

    @property
    def decode_syncs(self) -> int:
        """Token blocks brought to the host: one per horizon walked."""
        return self._decode_syncs

    @property
    def overlap_rounds(self) -> int:
        """Rounds that dispatched the next horizon before walking the
        previous block."""
        return self._overlap_rounds

    @property
    def preemptions(self) -> int:
        """Requests evicted from a slot for page pressure."""
        return self._preemptions

    @property
    def resumed_requests(self) -> int:
        """Preempted requests re-admitted by prefill replay."""
        return self._resumed

    @property
    def slot_errors(self) -> int:
        """Slots retired as ``error`` by the non-finite-logits guard."""
        return self._slot_errors

    @property
    def mean_tokens_per_sync(self) -> float:
        return self._synced_tokens / self._decode_syncs if self._decode_syncs else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode slots active per dispatched step."""
        if not self._decode_steps:
            return 0.0
        return self._active_slot_steps / (self._decode_steps * self.n_slots)

    @property
    def page_utilization(self) -> float:
        """Mean fraction of the page pool in use per dispatched step."""
        if not self.paged or not self._decode_steps:
            return 0.0
        usable = self.allocator.capacity - self.allocator.reserved
        return self._page_slot_steps / (self._decode_steps * usable)

    @property
    def kv_cache_bytes(self) -> int:
        """Allocated KV-cache storage, every leaf of the cache."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    # -- the round loop ------------------------------------------------------

    def _take_finished(self) -> List[RequestOutput]:
        out, self._finished = self._finished, []
        return out

    def _now(self) -> float:
        return time.perf_counter()

    def _phase_done(self, phase: str, t0: float, **args) -> None:
        """Close one scheduler phase (tracing only): accumulate its wall
        time and emit the complete event."""
        dur = time.perf_counter() - t0
        self._phase_ms[phase] += dur * 1e3
        self._phase_hist[phase].record(dur * 1e3)
        self.trace.complete(SCHED_TID, phase, self._now() - dur, dur, **args)

    def _round_begin(self) -> None:
        self._round_no += 1
        self.trace.begin(SCHED_TID, "round", self._now(), n=self._round_no)

    def _round_end(self) -> None:
        self.trace.end(SCHED_TID, "round", self._now())

    def _round_boundary(self) -> None:
        """Host work at every round boundary: admit from the queue."""
        t0 = time.perf_counter()
        self._admit_pending()
        if self.trace is not None:
            self._phase_done("admit", t0)

    def _effective_horizon(self, horizon: Optional[int]) -> int:
        """One round's horizon: explicit argument > SLA controller >
        engine default."""
        if horizon is not None:
            K = int(horizon)
        elif self.sla is not None:
            K = self.sla.horizon
        else:
            K = self.horizon
        if K < 1:
            raise ValueError(f"horizon must be >= 1, got {K}")
        return K

    def _ahead_horizon(self, K_cfg: int, Kd: int) -> int:
        """Length of the horizon to dispatch before walking the in-flight
        Kd-step block, or 0 to stay serial: only when some slot's budget
        outlasts the in-flight block."""
        if not self.overlap or K_cfg <= 1:
            return 0
        rem_after = self._max_rem() - Kd
        if rem_after <= 0:
            return 0
        return min(K_cfg, self._bucket(rem_after))

    def _rounds(self, horizon: Optional[int] = None,
                max_rounds: int = 1_000_000) -> Iterator[None]:
        """The overlapped scheduler loop; yields once per round. A round
        admits into freed slots, then, with a block in flight, dispatches
        the next horizon from the in-flight horizon's device carry and
        only then waits for and walks the block. horizon=1 runs serially.
        Closing the generator walks a dispatched-ahead block first, so
        host state stays consistent with the device."""
        pending = None
        rounds = 0
        try:
            while True:
                tr = self.trace
                if tr is not None:
                    self._round_begin()
                self._round_boundary()
                if pending is None and not self._queue and not self.num_active:
                    if tr is not None:
                        self._round_end()
                    return
                rounds += 1
                if rounds > max_rounds:
                    if tr is not None:
                        self._round_end()
                    raise RuntimeError("run_until_drained did not converge")
                if pending is not None:
                    alive_d, rem_d, block, Kd, seqs = pending
                    pending = None
                    nk = self._ahead_horizon(self._effective_horizon(horizon), Kd)
                    if nk:
                        pending = self._dispatch_horizon(nk, carry=(alive_d, rem_d))
                        self._overlap_rounds += 1
                    self._walk_block(block, Kd, seqs)
                elif self.num_active:
                    K = self._effective_horizon(horizon)
                    if K == 1:
                        self._token_step()
                    else:
                        pending = self._dispatch_horizon(
                            min(K, self._bucket(self._max_rem())))
                        if not self.overlap:
                            _, _, block, Kd, seqs = pending
                            pending = None
                            self._walk_block(block, Kd, seqs)
                # else: the queue is blocked with nothing active, a no-op
                # round; the round budget turns a livelock into an error
                if tr is not None:
                    self._round_end()
                yield
        finally:
            if pending is not None:
                self._walk_block(pending[2], pending[3], pending[4])

    # -- decode ----------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Smallest power of two >= n, capped at max_len."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _max_rem(self) -> int:
        """Largest remaining token budget among active slots (host view)."""
        return max((s.request.params.max_new_tokens - len(s.tokens)
                    for s in self.slots if s.active), default=0)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a wait on the device: on
        the card through a pinned buffer and a non-blocking copy (the
        caching host allocator keeps the buffer until the copy ran)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _scan_masks(self, fresh=()):
        """Per-slot alive, remaining budget, eos id and "take host state"
        rows for one horizon, from host slot state, in one upload."""
        m = np.zeros((4, self.n_slots), np.int32)
        m[2] = -1
        for s in self.slots:
            if s.active:
                sp = s.request.params
                m[0, s.id] = 1
                m[1, s.id] = sp.max_new_tokens - len(s.tokens)
                if sp.eos_id is not None:
                    m[2, s.id] = sp.eos_id
        for sid in fresh:
            m[3, sid] = 1
        return self._upload(m).unbind(0)

    @staticmethod
    def _all_greedy(requests) -> bool:
        """Whether none of ``requests`` samples: the sampler then takes
        the argmax alone."""
        return all(r.params.greedy for r in requests)

    def _first_tokens(self, logits, requests, slots):
        """Token 0 of newly admitted ``requests`` in ``slots``: each draws
        fold 0 of its key."""
        return sample_tokens(logits, self._temps[slots], self._top_ks[slots],
                             self._top_ps[slots], self._keys[slots],
                             torch.zeros_like(slots),
                             all_greedy=self._all_greedy(requests))

    def _token_step(self) -> None:
        """horizon=1: one decode + sample micro-step and its walk, with
        the reference per-token path's slot-step accounting."""
        _, _, block, _, _ = self._dispatch_horizon(1, per_token=True)
        self._walk_block(block, 1, count_slot_steps=False)

    @torch.no_grad()
    def _dispatch_horizon(self, K: int, carry=None, per_token: bool = False):
        """Launch one K-step horizon without waiting for its block.

        Returns ``(alive, rem, block, K, seqs)``: the device carry, the
        block on its way to the host, and the per-slot admission
        sequence numbers at dispatch. ``carry=None`` builds the masks
        from host slot state; ``carry=(alive, rem)`` reuses the previous
        horizon's device carry, with host state for dirty slots (fresh
        admissions take their own masks; aborted and preempted slots are
        forced dead by the minimum). On-demand engines first grow every
        active chain to cover the K micro-steps, preempting on
        exhaustion."""
        tr = self.trace
        t0 = time.perf_counter()
        self._grow_chains(K)
        self._decode_steps += K
        if per_token:
            self._active_slot_steps += self.num_active
        if self.paged:
            self._page_slot_steps += K * self.allocator.pages_in_use
        alive_h, rem_h, eos, fresh = self._scan_masks(
            self._dirty_slots if carry is not None else ())
        if carry is None:
            alive, rem = alive_h, rem_h
        else:
            alive_c, rem_c = carry
            fresh = fresh > 0
            alive = torch.where(fresh, alive_h, torch.minimum(alive_c, alive_h))
            rem = torch.where(fresh, rem_h, rem_c)
        self._dirty_slots.clear()
        seqs = tuple(s.seq if s.active else -1 for s in self.slots)
        greedy = self._all_greedy(s.request for s in self.slots if s.active)
        cache, cur, offsets, toks = self.cache, self.cur, self._offsets, []
        for _ in range(K):
            # dense caches take the mask for the step only; paged caches
            # keep it
            cache = dict(cache, active=alive)
            cache, logits = self.model.decode_step(self.ctx, self.params, cur, cache)
            if not self.paged:
                del cache["active"]
            tok = sample_tokens_scan(logits[:, -1], self._temps, self._top_ks,
                                     self._top_ps, self._keys, offsets, alive,
                                     all_greedy=greedy)
            offsets = offsets + 1
            rem = rem - alive
            done = ((alive > 0) & (eos >= 0) & (tok == eos)) | (rem <= 0) \
                | (tok == ERR_TOKEN)
            alive = torch.where(done, 0, alive)
            cur = tok[:, None]
            toks.append(tok)
        self.cache, self.cur, self._offsets = cache, cur, offsets
        block = _Block(torch.stack(toks))
        self._note_dispatched(K)
        self.decode_s += time.perf_counter() - t0
        if tr is not None:
            self._phase_done("dispatch", t0, K=K)
        return alive, rem, block, K, seqs

    def _walk_block(self, block: _Block, K: int, seqs=None,
                    count_slot_steps: bool = True) -> None:
        """Wait for one dispatched block and walk it: emit, stream and
        retire exactly as a serial horizon. A slot's rows are walked only
        if its occupant is still the request the block was dispatched for
        (``seqs``); a block no live slot owns is dropped without a wait."""
        eligible = [s for s in self.slots
                    if s.active and (seqs is None or seqs[s.id] == s.seq)]
        if not eligible:
            return
        tr = self.trace
        t0 = time.perf_counter()
        self._decode_syncs += 1
        blk = block.numpy()
        self.decode_s += time.perf_counter() - t0
        if tr is not None:
            self._phase_done("sync", t0, K=K)
            t0 = time.perf_counter()
        for s in eligible:
            if not s.active:    # retired by a groupmate's callback mid-walk
                continue
            if tr is not None:
                tr.instant(s.request.id + 1, "decode-round", self._now(), planned=K)
            for t in range(K):
                if count_slot_steps:
                    self._active_slot_steps += 1
                self._emit(s, int(blk[t, s.id]))
                if not s.active:
                    break
        if tr is not None:
            self._phase_done("walk", t0)

    def _emit(self, s: _Slot, tok: int, synced: bool = True) -> None:
        """Deliver one token: append, count, call the streaming hook,
        retire on EOS or budget. ``synced=False`` marks a prefill token.
        ERR_TOKEN (non-finite logits) retires only this slot, as
        ``error``."""
        if tok == ERR_TOKEN:
            self._retire(s, "error")
            return
        s.tokens.append(tok)
        if synced:
            self._synced_tokens += 1
        cb = s.request.on_token
        if cb is not None:
            cb(tok)
        if s.active:    # the callback may have aborted its own request
            sp = s.request.params
            if sp.eos_id is not None and tok == sp.eos_id:
                self._retire(s, "eos")
            elif len(s.tokens) >= sp.max_new_tokens:
                self._retire(s, "length")

    def _retire(self, s: _Slot, reason: str) -> None:
        rid = s.request.id
        st = self._stats.pop(rid)
        st.finished_s = self._now()
        st.new_tokens = len(s.tokens)
        out = RequestOutput(rid, s.request.inputs, list(s.tokens), reason, st, slot=s.id)
        self._finished.append(out)
        # every served retirement feeds the latency histograms
        self._ttft_hist.record(out.ttft_ms)
        self._tpot_hist.record(out.tpot_ms)
        if self.trace is not None:
            tid = rid + 1
            if reason == "error":
                self.trace.instant(tid, reason, st.finished_s)
            self.trace.instant(tid, "retired", st.finished_s, reason=reason,
                               tokens=st.new_tokens)
            self.trace.end(tid, "request", st.finished_s)
        if reason == "error":
            self._slot_errors += 1
        if self.sla is not None and reason in ("eos", "length"):
            # only clean completions feed the percentile window
            self.sla.observe(out)
        self._preempted.pop(rid, None)
        self._preempt_counts.pop(rid, None)
        self._disp_len.pop(s.id, None)
        s.active, s.request, s.tokens = False, None, []
        if self.paged:
            self.allocator.free_chain(self._chains.pop(rid))
            self._park(s.id)

    def _park(self, sid: int) -> None:
        """Point a freed paged slot at the trash page so that its idle
        decode writes cannot touch live pages."""
        self.cache["block_tables"][sid] = TRASH_PAGE
        self.cache["active"][sid] = 0
        self.cache["len"][sid] = 0

    def _finish_queued(self, r: Request, reason: str) -> RequestOutput:
        """Finish a request that is not in a slot (queued, possibly with
        tokens stashed from a preemption)."""
        st = self._stats.pop(r.id)
        toks = self._preempted.pop(r.id, [])
        self._preempt_counts.pop(r.id, None)
        fid = self._flow_ids.pop(r.id, None)
        st.finished_s = self._now()
        if st.first_token_s == 0.0:
            st.first_token_s = st.finished_s
        st.new_tokens = len(toks)
        if self.trace is not None:
            tid = r.id + 1
            self.trace.end(tid, "queued", st.finished_s)
            if fid is not None:
                # the stash died before its resume: close the link here
                self.trace.flow_end(tid, "resume", st.finished_s, fid, reason=reason)
            self.trace.instant(tid, "retired", st.finished_s, reason=reason,
                               tokens=st.new_tokens)
            self.trace.end(tid, "request", st.finished_s)
        return RequestOutput(r.id, r.inputs, list(toks), reason, st)

    # -- on-demand paging and preemption ---------------------------------------

    def _pos_cap(self, request: Request) -> int:
        """Most cache positions a request can occupy: prompt + budget."""
        return min(request.inputs["tgt_in"].shape[1] + request.params.max_new_tokens,
                   self.max_len)

    def _note_dispatched(self, K: int) -> None:
        """Advance each active slot's dispatched-positions bound."""
        if not self.on_demand:
            return
        for s in self.slots:
            if s.active:
                self._disp_len[s.id] = min(self._disp_len[s.id] + K,
                                           self._pos_cap(s.request))

    def _grow_chains(self, K: int) -> None:
        """Extend every active chain to cover the next K micro-steps, so
        block tables stay fixed across the horizon. On exhaustion the
        lowest-priority, then youngest, request is preempted (possibly
        the grower itself); growth walks slots highest-priority, then
        oldest, first."""
        if not self.on_demand:
            return
        for s in sorted((t for t in self.slots if t.active),
                        key=lambda t: (-t.request.params.priority, t.seq)):
            if not s.active:    # preempted as a victim earlier in this pass
                continue
            r = s.request
            want = min(self._disp_len[s.id] + K, self._pos_cap(r))
            chain = self._chains[r.id]
            while s.active:
                need = pages_needed(want, self.page_size) - len(chain)
                if need <= 0:
                    break
                got = self.allocator.try_alloc_chain(need)
                if got is not None:
                    start = len(chain)
                    chain.extend(got)
                    self.cache["block_tables"][s.id, start:start + len(got)] = \
                        self._upload(np.asarray(got, np.int32))
                    break
                victim = min((t for t in self.slots if t.active),
                             key=lambda t: (t.request.params.priority, -t.seq))
                self._preempt(victim)

    def _preempt(self, s: _Slot) -> None:
        """Evict an in-flight request for pages: stash its tokens, free
        its chain and requeue it at the head for a prefill-replay resume;
        past ``preempt_limit`` evictions retire it as
        ``preempted_limit``. Freeing pages a dispatched horizon still
        writes is safe: device work runs in submission order, so those
        writes land before a new owner's."""
        r = s.request
        n = self._preempt_counts.get(r.id, 0) + 1
        self._preemptions += 1
        self._stats[r.id].preemptions = n
        if self.trace is not None:
            self.trace.instant(r.id + 1, "preempted", self._now(), count=n,
                               tokens=len(s.tokens))
        if n > self.preempt_limit:
            self._retire(s, "preempted_limit")
            return
        if self.trace is not None:
            now = self._now()
            self.trace.begin(r.id + 1, "queued", now)
            # links the two residencies; closed at the resume, or at
            # retirement if the stash dies queued
            self._flow_ids[r.id] = self.trace.flow_start(r.id + 1, "resume", now, count=n)
        self._preempt_counts[r.id] = n
        self._preempted[r.id] = list(s.tokens)
        s.active, s.request, s.tokens = False, None, []
        self._disp_len.pop(s.id, None)
        self._dirty_slots.add(s.id)
        self.allocator.free_chain(self._chains.pop(r.id))
        self._park(s.id)
        self._queue.appendleft(r)

    def _feed_tokens(self, r: Request) -> torch.Tensor:
        """A request's prefill feed: its prompt, plus all but the last
        stashed token when it resumes (the last becomes the pending
        decode token)."""
        toks = r.inputs["tgt_in"]
        stash = self._preempted.get(r.id)
        if stash and len(stash) > 1:
            toks = torch.cat([toks, torch.tensor(stash[:-1], dtype=torch.int32)[None]], 1)
        return toks

    # -- admission ----------------------------------------------------------------

    def _admit_pending(self) -> None:
        if not self.paged:
            while self._queue and self.free_slot() is not None:
                self._admit(self._queue.popleft())
            return
        while self._queue:
            group = self._take_group()
            if not group:
                break
            self._admit_group(group)

    def _set_sampling(self, slot_ids, requests, offsets) -> None:
        """Load the requests' sampling knobs, base keys and PRNG offsets
        into their slots (one upload)."""
        sps = [r.params for r in requests]
        f = self._upload(np.array([[sp.temperature, sp.top_p] for sp in sps], np.float32))
        i = self._upload(np.array(
            [[sp.top_k, off, *prng.prng_key(sp.seed).tolist()]
             for sp, off in zip(sps, offsets)], np.int64))
        self._temps[slot_ids] = f[:, 0]
        self._top_ps[slot_ids] = f[:, 1]
        self._top_ks[slot_ids] = i[:, 0]
        self._offsets[slot_ids] = i[:, 1]
        self._keys[slot_ids] = i[:, 2:]

    def _note_prefill_shape(self, tgt, src, n: int) -> None:
        """Record a prefill batch shape, keyed as the reference keys its
        compiled prefills."""
        self.prefill_shapes.add((("lengths", (n,)), ("src_tokens", tuple(src.shape)),
                                 ("tgt_in", tuple(tgt.shape))))

    @torch.no_grad()
    def _admit(self, request: Request) -> None:
        """Dense admission: prefill one request into a one-slot cache,
        sample its first token, and splice the cache into a free slot."""
        sid = self.free_slot()
        s = self.slots[sid]
        tr = self.trace
        if tr is not None:
            tr.end(request.id + 1, "queued", self._now())
        t0 = time.perf_counter()
        true_len = request.inputs["tgt_in"].shape[1]
        tgt = torch.nn.functional.pad(request.inputs["tgt_in"],
                                      (0, self._bucket(true_len) - true_len))
        src = request.inputs["src_tokens"]
        self._note_prefill_shape(tgt, src, 1)
        one = self.model.init_cache(1, self.max_len, self.kv_dtype, enc_len=src.shape[1])
        one, logits = self.model.prefill(
            self.ctx, self.params, one,
            {"tgt_in": self._upload(tgt.numpy()), "src_tokens": self._upload(src.numpy()),
             "lengths": self._upload(np.array([true_len], np.int32))})
        slot = self._upload(np.array([sid], np.int64))
        self._set_sampling(slot, [request], [1])
        first = self._first_tokens(logits[:, true_len - 1], [request], slot)
        self._splice(one, sid)
        self.cur[sid, 0] = first[0]
        tok = int(first[0])             # admission waits for its first token
        now = self._now()
        self.prefill_calls += 1
        self.prefill_s += time.perf_counter() - t0
        if tr is not None:
            p_dur = time.perf_counter() - t0
            tr.complete(request.id + 1, "prefill", now - p_dur, p_dur)
        s.request, s.tokens, s.active = request, [], True
        s.seq = self._admit_seq
        self._admit_seq += 1
        self._dirty_slots.add(sid)
        self._stats[request.id].first_token_s = now
        self._emit(s, tok, synced=False)

    def _splice(self, one, sid: int) -> None:
        """Write a one-slot cache into batch slot ``sid``, in place. The
        cross-attention leaves are zero-padded from the request's source
        length to the engine's capacity (``cross_len`` masks the rest);
        ``pos`` / ``len`` / ``cross_len`` carry the batch axis first, the
        layer-stacked K/V leaves second."""
        for key, c in self.cache.items():
            o = one[key].to(c.dtype)
            if key in ("pos", "len", "cross_len"):
                c[sid] = o[0]
            elif key.startswith("cross_"):
                c[:, sid] = 0
                c[:, sid, :o.shape[2]] = o[:, 0]
            else:
                c[:, sid] = o[:, 0]

    def _admit_pages(self, request: Request) -> int:
        """Pages a paged admission allocates now: the prefill feed's."""
        return pages_needed(self._feed_tokens(request).shape[1], self.page_size)

    def _shape_key(self, request: Request):
        """Batched-prefill key: the feed's bucket (prompt, plus replayed
        tokens on a resume) and the source shape."""
        return (self._bucket(self._feed_tokens(request).shape[1]),
                tuple(request.inputs["src_tokens"].shape[1:]))

    def _take_group(self) -> List[Request]:
        """Pop the next batched-prefill group off the queue: same-shaped
        requests from the head while slots (capped by the SLA controller)
        and pages last, trimmed to a power-of-two size. An empty return
        means the head is blocked; admission never skips it."""
        free = sum(not s.active for s in self.slots)
        if self.sla is not None:
            free = min(free, self.sla.prefill_cap)
        if not free or not self._queue:
            return []
        head_key = self._shape_key(self._queue[0])
        group: List[Request] = []
        need = 0
        for r in self._queue:
            if len(group) >= free or self._shape_key(r) != head_key:
                break
            pages = self._admit_pages(r)
            if not self.allocator.can_alloc(need + pages):
                break
            group.append(r)
            need += pages
        n = 1
        while n * 2 <= len(group):
            n *= 2
        group = group[:n]
        for _ in group:
            self._queue.popleft()
        return group

    @torch.no_grad()
    def _admit_group(self, group: List[Request]) -> None:
        """Admit a same-shape group under one batched prefill + insert.
        A resumed request prefills its prompt plus its stash minus the
        last token; its sampled token is discarded, its pending token is
        the last stashed one, its PRNG offset restarts at the stash
        length, and it re-emits nothing. Every slot of the group goes
        live before any first-token callback fires, so a callback that
        aborts a groupmate finds it admitted."""
        n = len(group)
        free = [s.id for s in self.slots if not s.active][:n]
        tr = self.trace
        if tr is not None:
            t_adm = self._now()
            for r in group:
                tr.end(r.id + 1, "queued", t_adm)
        t0 = time.perf_counter()
        feeds = [self._feed_tokens(r) for r in group]
        true_lens = [f.shape[1] for f in feeds]
        pad_to = self._bucket(max(true_lens))
        tgt = np.zeros((n, pad_to), np.int32)
        rows = np.zeros((n, self.max_pages), np.int32)      # 0 = trash page
        chains = []
        for i, (r, f) in enumerate(zip(group, feeds)):
            tgt[i, :true_lens[i]] = f[0].numpy()
            chain = self.allocator.alloc_chain(pages_needed(true_lens[i], self.page_size))
            chains.append(chain)
            rows[i, :len(chain)] = chain
        src = np.concatenate([r.inputs["src_tokens"].numpy() for r in group])
        self._note_prefill_shape(tgt, src, n)
        stashes = [self._preempted.pop(r.id, None) for r in group]
        lengths = self._upload(np.array(true_lens, np.int32))
        mini = self.model.init_cache(n, pad_to, self.kv_dtype, enc_len=src.shape[1])
        mini, logits = self.model.prefill(
            self.ctx, self.params, mini,
            {"tgt_in": self._upload(tgt), "src_tokens": self._upload(src),
             "lengths": lengths})
        slot_ids = self._upload(np.array(free, np.int64))
        self._set_sampling(slot_ids, group, [len(st) if st else 1 for st in stashes])
        first = self._first_tokens(
            logits[torch.arange(n, device=self.device), lengths.long() - 1], group, slot_ids)
        paged_insert(self.cache, mini, slot_ids, self._upload(rows), lengths)
        first = first.cpu().tolist()    # admission waits for its first tokens
        toks = [st[-1] if st else tok for st, tok in zip(stashes, first)]
        self.cur[slot_ids, 0] = self._upload(np.array(toks, np.int32))
        now = self._now()
        self.prefill_calls += 1
        self.prefill_s += time.perf_counter() - t0
        if tr is not None:
            # one batched prefill covers the group; each member gets the
            # same complete event on its own track
            p_dur = time.perf_counter() - t0
            for r in group:
                tr.complete(r.id + 1, "prefill", now - p_dur, p_dur, group=n)
        admitted = []
        for r, sid, chain, stash, tok, L in zip(group, free, chains, stashes, toks,
                                               true_lens):
            s = self.slots[sid]
            if stash:
                self._resumed += 1
                fid = self._flow_ids.pop(r.id, None)
                if tr is not None:
                    tr.instant(r.id + 1, "resumed", now, replayed=len(stash))
                    if fid is not None:
                        tr.flow_end(r.id + 1, "resume", now, fid)
            self._chains[r.id] = chain
            s.request, s.tokens, s.active = r, list(stash) if stash else [], True
            s.seq = self._admit_seq
            self._admit_seq += 1
            self._disp_len[sid] = L
            self._dirty_slots.add(sid)
            admitted.append((s, r, tok, bool(stash)))
        # first tokens only once every slot of the group is live; resumed
        # requests streamed their stashed tokens before eviction
        for s, r, tok, resumed in admitted:
            if resumed or not s.active or s.request is not r:
                continue    # resumed, or a groupmate's callback aborted it
            self._stats[r.id].first_token_s = now
            self._emit(s, tok, synced=False)


# ---------------------------------------------------------------------------
# legacy one-shot wrappers (thin shims over a single-shot engine)
# ---------------------------------------------------------------------------

_DEPRECATION = (
    " is deprecated and will be removed: deploy() a TranslationPipeline and "
    "use pipe.generate()/pipe.translate(), or the streaming surface "
    "(pipe.translate_stream / engine.submit(on_token=...) / engine.stream()) "
    "for token-at-a-time delivery")


def greedy_generate(model, ctx, params, batch, *, steps: int, max_len: int,
                    kv_dtype: str = "bf16", eos_id: Optional[int] = None,
                    device="cuda"):
    """Deprecated prefill + greedy decode shim; see ``_DEPRECATION``.
    Returns (tokens (B, steps), cache)."""
    warnings.warn("greedy_generate" + _DEPRECATION, DeprecationWarning, stacklevel=2)
    return _greedy_generate(model, ctx, params, batch, steps=steps, max_len=max_len,
                            kv_dtype=kv_dtype, eos_id=eos_id, device=device)


def _greedy_generate(model, ctx, params, batch, *, steps: int, max_len: int,
                     kv_dtype: str, eos_id: Optional[int], device):
    """One slot per batch row; a row stops at its first EOS and the rest
    of its positions hold ``eos_id`` (0 without one)."""
    B = batch["tgt_in"].shape[0]
    eng = ServeEngine(model, params, slots=B, max_len=max_len, kv_dtype=kv_dtype,
                      ctx=ctx, device=device)
    sp = SamplingParams(max_new_tokens=steps, eos_id=eos_id)
    ids = [eng.submit({k: v[i:i + 1] for k, v in batch.items()}, sp) for i in range(B)]
    outs = {o.request_id: o for o in eng.run_until_drained()}
    pad = 0 if eos_id is None else eos_id
    rows = [outs[r].token_ids + [pad] * (steps - len(outs[r].token_ids)) for r in ids]
    return torch.tensor(rows, dtype=torch.int32), eng.cache


def translate(model, ctx, params, src_tokens, lang_code: int, *, steps: int,
              max_len: int = 0, kv_dtype: str = "bf16",
              eos_id: Optional[int] = None, device="cuda"):
    """Deprecated NMT shim: many-to-many via the target language code;
    see ``_DEPRECATION``. ``max_len`` defaults to the one-token prompt +
    ``steps``; a smaller explicit one raises."""
    warnings.warn("translate" + _DEPRECATION, DeprecationWarning, stacklevel=2)
    src = torch.as_tensor(src_tokens, dtype=torch.int32)
    max_len = max_len or 1 + steps
    if 1 + steps > max_len:
        raise ValueError(f"translate needs prompt_len + steps = 1 + {steps} = "
                         f"{1 + steps} cache positions but max_len={max_len}")
    batch = {"src_tokens": src,
             "tgt_in": torch.full((src.shape[0], 1), lang_code, dtype=torch.int32)}
    toks, _ = _greedy_generate(model, ctx, params, batch, steps=steps, max_len=max_len,
                               kv_dtype=kv_dtype, eos_id=eos_id, device=device)
    return toks
