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

Deadlines, bounded admission and fault injection
------------------------------------------------
``SamplingParams.deadline_ms`` is checked at every round boundary on the
engine clock (wall time plus any injected skew; no device sync):
expired requests, active or queued, retire as ``deadline`` with their
synced tokens. ``max_pending`` bounds the queue: ``submit`` raises the
typed ``EngineSaturated`` instead of queueing. ``faults=FaultPlan(...)``
(serving/faults.py) steals pages and skews the clock at round
boundaries and forces NaN logits on chosen slots of a target dispatch;
the sampler's guard retires only the poisoned slot as ``error``.

Speculative decoding (``draft=DraftArm(...)``)
----------------------------------------------
With a draft arm (serving/spec_decode.py) every round whose active slots
are all greedy is a speculative round: the draft proposes ``lookahead``
tokens through the horizon loop, the target replays them teacher-forced
(``models.decode_block``), and the longest matching prefix plus the
target's token at the first divergence is emitted, token for token the
target-only stream. A sampled request in the batch sends the round down
the target-only path. Both arms keep a cache per slot (a paged engine
holds two chains per request out of one allocator and reserves whole
budgets); a rejection rolls both back to the emitted length. Speculative
rounds are serial.

Metrics and tracing
-------------------
``metrics()`` returns one frozen ``EngineMetrics`` snapshot (counters,
ratios, TTFT / TPOT percentiles from histograms recorded at every
retirement); ``prometheus()`` renders it. ``trace=TraceConfig()`` adds
per-request lifecycle spans and scheduler phase spans (admit, dispatch,
sync, walk); every emission sits behind ``if self.trace is not None``.
``sla=SLATarget(...)`` retunes the effective horizon and the paged
prefill-group cap against the measured p95s.

Tensor parallelism (``deploy(mesh=tp_mesh(K))``)
------------------------------------------------
On every rank of the mesh ``deploy`` builds the engine from the rank's
parts (``parallel.tp.tp_engine_parts``): a model of the rank's local
widths, its shard of the quantized weights and a ctx carrying the group
(``ctx.tp``). The engine builds its caches from that model (an SSM's and
a hybrid's recurrent states at the rank's heads and channels; a draft
arm's cache, dense or its own chains of the one paged pool, likewise)
and serves the same requests on every rank. Every quantization arm
serves so: act-quantizing specs (a row-parallel product's dynamic scale
is the ranks' absmax), calibrated scales (calibrated on the shard, the
site tables merged), QLoRA adapters and a draft arm sharded like the
target. The logits every rank samples from are the same bits, so
sampling, retirement on eos or length, paging, preemption, admission
order, draft acceptance and the fault plan's seeded page steals and NaN
schedule (each rank builds the same plan, ticked at the same rounds and
dispatches) agree on every rank with no message. A decoder-only LM's
prefill gathers only the rows the engine samples from.

What reads a clock would part the ranks, whose clocks differ: one rank
would retire a slot that another keeps decoding, or admit a prefill
group of another size, and the collectives would stop matching. So under
a mesh every such decision is rank 0's, through a control channel
(``TPGroup.broadcast``): at each round boundary, after the fault plan's
tick and before admission, rank 0 sends one small f64 tensor, its round
number and counts, a flag for each deadlined request (active slots in
slot order, then the queue) that expired on its clock (its injected skew
included; the other ranks' skews change only what their own clocks say),
and the (TTFT, TPOT) of each request that retired clean since the last
boundary. Every rank, rank 0 included, retires exactly those requests in
one device's order and folds those observations into its SLA controller
there (``SLAController.fold``), so every rank's horizon, prefill cap,
retunes and windows agree after every round; a retune lands at most one
round later than on one device, and no stream depends on the horizon.
The channel runs once a round where ``sla`` or ``faults`` is set or a
queued or active request carries a ``deadline_ms``, a predicate every
rank computes alike from host state; an engine with none of them runs no
channel, and a decode step's collectives are unchanged. Two rank-local
quantities drive no decision and may differ: a rank's own timings
(``RequestOutput.ttft_ms`` / ``tpot_ms``, its latency histograms) and
its trace timestamps.
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
from ..models.api import decode_block
from .metrics import EngineMetrics, SLAController, SLATarget
from .paged_cache import TRASH_PAGE, PageAllocator, paged_insert, pages_needed
from .params import (GREEDY, EngineSaturated, Request, RequestOutput, RequestStats,
                     SamplingParams)
from .sampler import ERR_TOKEN, sample_tokens, sample_tokens_scan
from .spec_decode import DraftArm, accept_longest_prefix

__all__ = ["ServeEngine", "greedy_generate", "translate"]

# the families served (SSM and hybrid dense only, unbucketed: a
# recurrent state would absorb pad tokens)
_SERVED = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec", "audio")
# an enc-dec request's source: token ids, or an audio model's frames
_SOURCES = ("src_tokens", "frames")
# families safe to prefill right-padded: attention caches with pos / len
# masking and token-only prompts (a VLM's logits interleave its image
# patches, so its last real token is not lengths-derived)
_PAD_SAFE = ("dense", "moe", "encdec", "audio")
# cache leaves whose first axis is the batch (the others are layer-stacked)
_BATCH_LEADING = ("pos", "len", "cross_len", "pos_roll")


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
                 draft: Optional[DraftArm] = None, overlap: bool = True,
                 sla: Optional[SLATarget] = None, max_pending: Optional[int] = None,
                 preempt_limit: int = 3, faults=None, trace=None, device="cuda"):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if preempt_limit < 0:
            raise ValueError(f"preempt_limit must be >= 0, got {preempt_limit}")
        # a rank of a tensor-parallel mesh serves the model of its local
        # widths over its shard of the weights (deploy places them); its
        # ctx carries the group the row-parallel sums and the vocabulary
        # gathers run over (parallel/tp.py)
        self.tp = ctx.tp if ctx is not None else None
        # the control channel of a mesh (module docstring): rank 0 decides
        # what reads a clock
        self._channel = self.tp if self.tp is not None and self.tp.size > 1 else None
        fam = model.cfg.family
        if fam not in _SERVED:
            raise ValueError(f"unknown family {fam!r}; the engine serves {_SERVED}")
        if draft is not None and fam not in _PAD_SAFE:
            raise ValueError(f"speculative decoding supports families {_PAD_SAFE}, "
                             f"got {fam!r} (the draft / verify loops need pos / "
                             "len-masked attention caches)")
        if paged and fam not in _PAD_SAFE:
            raise ValueError(f"paged serving supports families {_PAD_SAFE}, got "
                             f"{fam!r} (vlm prompt lengths are not lengths-derived)")
        self.model = model
        self.params = params
        self.ctx = ctx
        self.device = torch.device(device)
        self.kv_dtype = kv_dtype
        self.max_len = max_len
        self.n_slots = slots
        self.horizon = int(horizon)
        # enc-dec requests carry a source, tokens or an audio model's
        # frames (cross-attention capacity enc_cap); LM requests a
        # "tokens" prompt, after a VLM's patches
        self._enc_dec = fam in ("encdec", "audio")
        self.enc_cap = int(max_src_len or model.cfg.enc_len) if self._enc_dec else 0
        self._tkey = "tgt_in" if self._enc_dec else "tokens"
        self._bucketed = fam in _PAD_SAFE
        # dense caches take the horizon's "active" mask (an inactive slot's
        # writes land masked, its len freezes); paged caches keep their own
        self._mask_active = not paged and fam in _PAD_SAFE
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.draft = draft
        self.allocator: Optional[PageAllocator] = None
        kvs = [kv_dtype] + ([draft.kv_dtype] if draft is not None else [])
        cross = {"enc_len": self.enc_cap} if self._enc_dec else {}
        if self.paged:
            self.max_pages = pages_needed(max_len, self.page_size)
            # a draft arm doubles the default pool: both arms hold a chain
            # per request out of the same allocator
            usable = num_pages if num_pages is not None \
                else slots * self.max_pages * len(kvs)
            self.allocator = PageAllocator(usable + 1, reserved=1)
            caches = [model.init_paged_cache(slots, self.max_pages, usable + 1,
                                             self.page_size, kv, **cross)
                      for kv in kvs]
        else:
            caches = [model.init_cache(slots, max_len, kv, **cross) for kv in kvs]
        self.cache = caches[0]
        self.draft_cache = caches[1] if draft is not None else None
        self._chains: Dict[int, list] = {}          # request id -> pages
        self._draft_chains: Dict[int, list] = {}    # request id -> draft pages
        self.slots = [_Slot(i) for i in range(slots)]
        dev = self.device
        self.cur = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        # per-slot sampling state, read by every decode micro-step
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self._top_ps = torch.ones((slots,), dtype=torch.float32, device=dev)
        self._keys = torch.zeros((slots, 2), dtype=torch.int64, device=dev)
        self._offsets = torch.zeros((slots,), dtype=torch.int64, device=dev)
        # the draft scan retires no slot: no EOS ids
        self._no_eos = torch.full((slots,), -1, dtype=torch.int32, device=dev)
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
        # on a mesh: the (TTFT, TPOT) of clean retirements since the last
        # boundary, folded there from rank 0's channel message
        self._observed: List[tuple] = []
        self._boundaries = 0
        # -- fault tolerance -------------------------------------------
        self.max_pending = max_pending
        self.faults = faults                # a FaultPlan (serving/faults.py)
        if faults is not None:
            faults.reset()                  # one plan per engine, from 0
        self._skew_s = 0.0                  # fault-injected clock skew
        # on-demand paging: a target-only paged engine admits with the
        # prefill feed's pages and grows chains per dispatched horizon; a
        # draft arm reserves whole budgets (two chains that roll back
        # together)
        self.on_demand = self.paged and draft is None
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
        """Enqueue a request (a Request or a B=1 batch dict: ``src_tokens``
        (or an audio model's ``frames``) and ``tgt_in`` for an enc-dec
        model, ``tokens`` and a VLM's
        ``img_embeds`` for an LM); returns its id. A dense engine
        admits it at once when a slot is free (its first token, and
        ``on_token``'s first call, come before submit returns); a paged
        engine admits at the next round, so a burst of submits lands as
        one batched prefill.

        ``on_token`` (or ``Request.on_token``) is called with each token
        id as the block carrying it lands on the host; it runs on the
        scheduler's walk, so keep it cheap.

        With ``max_pending`` set, a full queue raises the typed
        ``EngineSaturated`` (retry after a round drains it)."""
        if self.max_pending is not None and len(self._queue) >= self.max_pending:
            self._admission_rejections += 1
            raise EngineSaturated(len(self._queue), self.max_pending)
        if not isinstance(request, Request):
            request = Request(inputs=dict(request), params=params or GREEDY)
        elif params is not None:
            request = dataclasses.replace(request, params=params)
        if on_token is not None:
            request = dataclasses.replace(request, on_token=on_token)
        sp = request.params
        inputs = {}
        keys = [(self._tkey, torch.int32), ("img_embeds", torch.float32)]
        if self._enc_dec:
            keys += [("src_tokens", torch.int32), ("frames", torch.float32)]
        for key, dt in keys:
            if key == self._tkey or key in request.inputs:
                t = torch.as_tensor(request.inputs[key]).to(device="cpu", dtype=dt)
                inputs[key] = t[None] if t.ndim == 1 else t
        if self._enc_dec and not any(k in inputs for k in _SOURCES):
            raise ValueError(f"an enc-dec request needs one of {_SOURCES}")
        prompt_len = int(inputs[self._tkey].shape[1])
        # a VLM's image patches fill cache positions ahead of its prompt
        patches = int(inputs["img_embeds"].shape[1]) if "img_embeds" in inputs else 0
        budget = patches + prompt_len + sp.max_new_tokens
        if budget > self.max_len:
            raise ValueError(
                f"request needs prompt_len + max_new_tokens = "
                + (f"{patches} image rows + " if patches else "")
                + f"{prompt_len} + {sp.max_new_tokens} = {budget} cache positions "
                f"but the engine was built with max_len={self.max_len}")
        request = dataclasses.replace(request, inputs=inputs)
        if self.paged:
            need = self._request_pages(request)
            usable = self.allocator.capacity - self.allocator.reserved
            if need > usable:
                raise ValueError(f"request needs {need} KV pages"
                                 + (" (target + draft arms)" if self.draft else "")
                                 + f" but the pool holds only {usable}")
        se = self._src_len(inputs)
        if se > self.enc_cap:
            raise ValueError(f"source length {se} exceeds the engine's "
                             f"cross-attention capacity {self.enc_cap}")
        request = dataclasses.replace(request, id=self._next_id)
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
        if self._speculate_now():
            self._spec_round()
        elif self.num_active and K == 1:
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

    # -- legacy slot-level surface ---------------------------------------------

    def add_request(self, batch_one: dict, gen_tokens: int) -> int:
        """Legacy: a greedy request into a free slot, admitted now;
        returns the slot id (the first free one: admission takes it)."""
        sid = self.free_slot()
        if self._queue or sid is None:
            raise RuntimeError("no free slots")
        rid = self.submit(batch_one, SamplingParams(max_new_tokens=gen_tokens))
        if self.paged:
            self._admit_pending()
        if self._queue:             # paged: the page pool is exhausted
            self.abort(rid)
            raise RuntimeError("no free pages")
        return sid

    def tick(self) -> List[int]:
        """Legacy: one step; returns the slot ids finished in it."""
        return [o.slot for o in self.step()]

    def result(self, slot: int) -> list:
        """Legacy: the token ids of the request last served in ``slot``."""
        return self.slots[slot].tokens

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
            verify_calls=self._verify_calls,
            drafted_tokens=self._drafted,
            accepted_tokens=self._accepted,
            rejected_tokens=self._rejected,
            preemptions=self._preemptions,
            resumed_requests=self._resumed,
            deadline_expirations=self._deadline_expirations,
            admission_rejections=self._admission_rejections,
            slot_errors=self._slot_errors,
            mean_tokens_per_sync=self.mean_tokens_per_sync,
            occupancy=self.occupancy,
            page_utilization=self.page_utilization,
            acceptance_rate=self.acceptance_rate,
            mean_accepted_per_verify=self.mean_accepted_per_verify,
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
        self._verify_calls = 0
        self._drafted = 0
        self._accepted = 0
        self._rejected = 0
        self._preemptions = 0
        self._resumed = 0
        self._deadline_expirations = 0
        self._admission_rejections = 0
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
    def deadline_expirations(self) -> int:
        """Requests retired because their ``deadline_ms`` elapsed."""
        return self._deadline_expirations

    @property
    def admission_rejections(self) -> int:
        """``submit`` calls refused with EngineSaturated."""
        return self._admission_rejections

    @property
    def slot_errors(self) -> int:
        """Slots retired as ``error`` by the non-finite-logits guard."""
        return self._slot_errors

    @property
    def verify_calls(self) -> int:
        """Speculative rounds run: one target replay of a drafted block each."""
        return self._verify_calls

    @property
    def drafted_tokens(self) -> int:
        return self._drafted

    @property
    def accepted_tokens(self) -> int:
        return self._accepted

    @property
    def rejected_tokens(self) -> int:
        return self._rejected

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target accepted (0.0 before any
        speculative round)."""
        return self._accepted / self._drafted if self._drafted else 0.0

    @property
    def mean_accepted_per_verify(self) -> float:
        """Accepted draft tokens per verify round, summed over slots."""
        return self._accepted / self._verify_calls if self._verify_calls else 0.0

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
        """Allocated KV-cache storage, every leaf of the cache and of the
        draft arm's cache."""
        return sum(t.numel() * t.element_size() for c in (self.cache, self.draft_cache)
                   if c is not None for t in c.values())

    # -- the round loop ------------------------------------------------------

    def _take_finished(self) -> List[RequestOutput]:
        out, self._finished = self._finished, []
        return out

    def _now(self) -> float:
        """The engine clock: wall time plus any fault-injected skew."""
        return time.perf_counter() + self._skew_s

    def _phase_done(self, phase: str, t0: float, **args) -> None:
        """Close one scheduler phase (tracing only): accumulate its wall
        time, from raw ``perf_counter`` deltas so that a skew injected
        inside the phase does not inflate it, and emit the complete event
        on the engine clock."""
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
        """Host work at every round boundary, no-op rounds included: tick
        the fault plan (release / steal pages, skew the clock), expire
        deadlines (on a mesh: rank 0's expiries and SLA observations
        through the control channel), then admit from the queue."""
        t0 = time.perf_counter()
        self._boundaries += 1
        if self.faults is not None:
            self.faults.on_round(self)
        deadlined = self._deadlined()
        if self._channel is not None and (deadlined or self.sla is not None
                                          or self.faults is not None):
            expired = self._rank0_decides(deadlined)
        else:
            now = self._now()
            expired = {r.id for r in deadlined if self._deadline_passed(r, now)}
        if expired:
            self._expire(expired)
        self._admit_pending()
        if self.trace is not None:
            self._phase_done("admit", t0)

    def _deadline_passed(self, request: Request, now: float) -> bool:
        dl = request.params.deadline_ms
        if dl is None:
            return False
        return (now - self._stats[request.id].arrival_s) * 1e3 > dl

    def _deadlined(self) -> List[Request]:
        """The requests that carry a ``deadline_ms``: active slots in slot
        order, then the queue in order (the order expiry retires them)."""
        return ([s.request for s in self.slots
                 if s.active and s.request.params.deadline_ms is not None]
                + [r for r in self._queue if r.params.deadline_ms is not None])

    def _expire(self, expired: set) -> None:
        """Retire the requests of ``expired``, active or queued, as
        ``deadline`` (a host compare on the engine clock decided them, no
        device sync): active slots first, freeing their pages through
        ``_retire`` with their tokens cut at the last synced position, as
        an abort's are; then the queue."""
        for s in self.slots:
            if s.active and s.request.id in expired:
                self._retire(s, "deadline")
        keep = collections.deque()
        for r in self._queue:
            if r.id in expired:
                self._finished.append(self._finish_queued(r, "deadline"))
            else:
                keep.append(r)
        self._queue = keep

    def _rank0_decides(self, deadlined: List[Request]) -> set:
        """The control channel's round (module docstring): rank 0's
        round number, counts, expiry flags of ``deadlined`` on its clock
        and its SLA observations since the last boundary, broadcast in one
        f64 tensor whose length every rank knows from host state; every
        rank folds the observations and returns the ids to expire. A
        rank whose round or counts are not rank 0's raises: the ranks'
        schedules parted."""
        n, obs = len(deadlined), self._observed
        self._observed = []
        msg = np.zeros(3 + n + 2 * len(obs), np.float64)
        msg[:3] = self._boundaries, n, len(obs)
        if self._channel.rank == 0:
            now = self._now()
            msg[3:3 + n] = [self._deadline_passed(r, now) for r in deadlined]
            msg[3 + n:] = np.asarray(obs, np.float64).reshape(-1)
        got = self._channel.broadcast(torch.from_numpy(msg)).numpy()
        if not np.array_equal(got[:3], msg[:3]):
            raise RuntimeError(f"rank {self._channel.rank} is at round {msg[:3].tolist()} "
                               f"(round, deadlined, observed), rank 0 at "
                               f"{got[:3].tolist()}: the ranks' schedules parted")
        if self.sla is not None:
            self.sla.fold(got[3 + n:].reshape(-1, 2).tolist())
        return {r.id for r, hit in zip(deadlined, got[3:3 + n]) if hit}

    def _speculate_now(self) -> bool:
        """A speculative round needs a draft arm and only greedy active
        requests: exact-match acceptance reproduces the argmax alone."""
        return (self.draft is not None and self.num_active > 0
                and self._all_greedy(s.request for s in self.slots if s.active))

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
        outlasts the in-flight block, and never with a draft arm (its
        rounds are host decision points)."""
        if not self.overlap or K_cfg <= 1 or self.draft is not None:
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
                    if self._speculate_now():
                        self._spec_round()
                    elif K == 1:
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

    @staticmethod
    def _src_len(inputs) -> int:
        """Cross-attention source length of a request: its source tokens'
        or frames' (0 for an LM)."""
        for key in _SOURCES:
            if key in inputs:
                return int(inputs[key].shape[1])
        return 0

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
        self.cache, self.cur, self._offsets, alive, rem, toks = self._decode_loop(
            self.ctx, self.params, self.cache, self.cur, self._offsets, alive, rem,
            eos, K, greedy=greedy, poison=self._poison_arr(K))
        block = _Block(toks)
        self._note_dispatched(K)
        self.decode_s += time.perf_counter() - t0
        if tr is not None:
            self._phase_done("dispatch", t0, K=K)
        return alive, rem, block, K, seqs

    def _decode_loop(self, ctx, params, cache, cur, offsets, alive, rem, eos, K: int,
                     *, greedy: bool, poison: Optional[torch.Tensor] = None):
        """K decode + sample micro-steps of one arm, with in-loop
        retirement: a slot that emits its eos id, exhausts its budget or
        samples ERR_TOKEN goes dead and decodes into masked positions.
        ``greedy`` takes the argmax whatever the slots' knobs (the draft
        scan passes it and drops the returned offsets).
        ``poison`` (S,) is the fault plan's NaN schedule: at micro-step
        i the logits of every slot whose entry equals i become NaN.
        Returns ``(cache, cur, offsets, alive, rem, tokens (K, S))``."""
        toks = []
        for i in range(K):
            # dense caches take the mask for the step only; paged caches
            # keep it
            if self._mask_active or self.paged:
                cache = dict(cache, active=alive)
            cache, logits = self.model.decode_step(ctx, params, cur, cache)
            if self._mask_active:
                del cache["active"]
            lg = logits[:, -1]
            if poison is not None:
                lg = torch.where((poison == i)[:, None], float("nan"), lg)
            tok = sample_tokens_scan(lg, self._temps, self._top_ks, self._top_ps,
                                     self._keys, offsets, alive, all_greedy=greedy)
            offsets = offsets + 1
            rem = rem - alive
            done = ((alive > 0) & (eos >= 0) & (tok == eos)) | (rem <= 0) \
                | (tok == ERR_TOKEN)
            alive = torch.where(done, 0, alive)
            cur = tok[:, None]
            toks.append(tok)
        return cache, cur, offsets, alive, rem, torch.stack(toks)

    def _poison_arr(self, K: int) -> Optional[torch.Tensor]:
        """The fault plan's NaN schedule for one target dispatch of K
        micro-steps: (S,) micro-step indices, -1 = clean, uploaded without
        a wait; None for a clean dispatch (nothing is added to it)."""
        if self.faults is None:
            return None
        arr = self.faults.poison(self.n_slots, K)
        if arr is None:
            return None
        sched = np.asarray(arr, np.int32)
        if self.trace is not None:
            self.trace.instant(SCHED_TID, "fault:nan", self._now(),
                               slots=[int(i) for i in np.nonzero(sched >= 0)[0]])
        return self._upload(sched)

    @torch.no_grad()
    def _spec_round(self) -> None:
        """One speculative round: the draft arm proposes K tokens through
        the horizon loop (greedy, no EOS, a budget that outlasts the scan,
        its own ctx, params and cache), the target replays
        ``[cur, d_0..d_{K-2}]`` teacher-forced, and each live slot emits
        the longest matching prefix plus the target's token at the first
        divergence (1..K tokens). Both caches roll back to the emitted
        length; the round waits on the device once."""
        draft = self.draft
        tr = self.trace
        t0 = time.perf_counter()
        K = max(1, min(draft.lookahead, self._bucket(self._max_rem())))
        self._decode_steps += K
        if self.paged:
            self._page_slot_steps += K * self.allocator.pages_in_use
        alive, _, _, _ = self._scan_masks()
        dcache, _, _, _, _, block = self._decode_loop(
            draft.ctx, draft.params, self.draft_cache, self.cur, self._offsets, alive,
            (K + 1) * alive, self._no_eos, K, greedy=True)
        feed = torch.cat([self.cur, block[:K - 1].t()], dim=1)
        cache, logits = decode_block(self.model, self.ctx, self.params, feed,
                                     dict(self.cache, active=alive))
        if not self.paged:
            del cache["active"]
        lg32 = logits.to(torch.float32)                          # (S, K, V)
        tgt = lg32.argmax(dim=-1).t().to(block.dtype)            # (K, S)
        out, n_emit, acc, new_cur = accept_longest_prefix(block, tgt, alive)
        # a slot whose target logits went non-finite emits one ERR_TOKEN
        # and accepts nothing; a non-finite draft token just mismatches
        bad = (alive > 0) & ~torch.isfinite(lg32).all(dim=-1).all(dim=-1)
        n_emit = torch.where(bad, 1, n_emit)
        acc = torch.where(bad, 0, acc)
        first = torch.arange(K, device=out.device)[:, None] == 0
        out = torch.where(bad[None, :] & first, ERR_TOKEN, out)
        roll = torch.where(alive > 0, K - n_emit, 0)
        self.cache = self._rollback(cache, roll)
        self.draft_cache = self._rollback(dcache, roll)
        self.cur = new_cur[:, None]
        self._verify_calls += 1
        res = _Block(torch.cat([out, n_emit[None], acc[None]]))
        self.decode_s += time.perf_counter() - t0
        if tr is not None:
            self._phase_done("dispatch", t0, K=K, spec=1)
        t0 = time.perf_counter()
        self._decode_syncs += 1
        host = res.numpy()                  # the round's one wait on the device
        blk, n_emit, acc = host[:K], host[K], host[K + 1]
        self.decode_s += time.perf_counter() - t0
        if tr is not None:
            self._phase_done("sync", t0, K=K)
            t0 = time.perf_counter()
        for s in self.slots:
            if not s.active:
                continue
            a = int(acc[s.id])
            st = self._stats[s.request.id]
            st.drafted += K
            st.accepted += a
            st.rejected += K - a
            self._drafted += K
            self._accepted += a
            self._rejected += K - a
            if tr is not None:
                tr.instant(s.request.id + 1, "verify", self._now(), drafted=K,
                           accepted=a, emitted=int(n_emit[s.id]))
            for t in range(int(n_emit[s.id])):
                self._active_slot_steps += 1
                self._emit(s, int(blk[t, s.id]))
                if not s.active:
                    break
        if tr is not None:
            self._phase_done("walk", t0)

    @staticmethod
    def _rollback(cache, roll: torch.Tensor):
        """Keep the first ``len - roll`` positions of a cache that ran K
        positions this round; a dense cache also re-masks ``pos`` past
        the new length, so rolled-back positions read as invalid."""
        new = dict(cache)
        new_len = cache["len"] - roll.to(cache["len"].dtype)
        new["len"] = new_len
        if "pos" in cache:
            pos = cache["pos"]
            idx = torch.arange(pos.shape[1], dtype=pos.dtype, device=pos.device)
            new["pos"] = torch.where(idx[None, :] >= new_len[:, None], -1, pos)
        return new

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
            if reason in ("deadline", "error"):
                self.trace.instant(tid, reason, st.finished_s)
            self.trace.instant(tid, "retired", st.finished_s, reason=reason,
                               tokens=st.new_tokens)
            self.trace.end(tid, "request", st.finished_s)
        if reason == "deadline":
            self._deadline_expirations += 1
        elif reason == "error":
            self._slot_errors += 1
        if self.sla is not None and reason in ("eos", "length"):
            # only clean completions feed the percentile window; on a mesh
            # rank 0's ride the next boundary's channel message
            if self._channel is None:
                self.sla.observe(out)
            else:
                self._observed.append((out.ttft_ms, out.tpot_ms))
        self._preempted.pop(rid, None)
        self._preempt_counts.pop(rid, None)
        self._disp_len.pop(s.id, None)
        # the slot keeps its tokens until its next admission (``result``)
        s.active, s.request = False, None
        if self.paged:
            # both arms' chains are freed together, by this one path,
            # whatever the finish reason
            self.allocator.free_chain(self._chains.pop(rid))
            if self.draft is not None:
                self.allocator.free_chain(self._draft_chains.pop(rid))
            self._park(s.id)

    def _park(self, sid: int) -> None:
        """Point a freed paged slot at the trash page, in both arms'
        caches, so that its idle decode writes cannot touch live pages."""
        for c in (self.cache, self.draft_cache):
            if c is not None:
                c["block_tables"][sid] = TRASH_PAGE
                c["active"][sid] = 0
                c["len"][sid] = 0

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
        if reason == "deadline":
            self._deadline_expirations += 1
        if self.trace is not None:
            tid = r.id + 1
            self.trace.end(tid, "queued", st.finished_s)
            if fid is not None:
                # the stash died before its resume: close the link here
                self.trace.flow_end(tid, "resume", st.finished_s, fid, reason=reason)
            if reason == "deadline":
                self.trace.instant(tid, "deadline", st.finished_s)
            self.trace.instant(tid, "retired", st.finished_s, reason=reason,
                               tokens=st.new_tokens)
            self.trace.end(tid, "request", st.finished_s)
        return RequestOutput(r.id, r.inputs, list(toks), reason, st)

    # -- on-demand paging and preemption ---------------------------------------

    def _pos_cap(self, request: Request) -> int:
        """Most cache positions a request can occupy: prompt + budget."""
        return min(request.inputs[self._tkey].shape[1] + request.params.max_new_tokens,
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
        toks = r.inputs[self._tkey]
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

    def _prefill_batch(self, requests, toks: np.ndarray, lengths) -> dict:
        """The prefill batch of ``requests``: their padded prompts ``toks``,
        the true ``lengths`` (a bucketed family's), their sources (tokens
        or frames) or image embeddings; recorded as a prefill shape, keyed
        as the reference keys its compiled prefills."""
        batch = {self._tkey: self._upload(toks)}
        if self._bucketed:
            batch["lengths"] = lengths
        for key in _SOURCES + ("img_embeds",):
            if key in requests[0].inputs:
                batch[key] = self._upload(np.concatenate(
                    [r.inputs[key].numpy() for r in requests]))
        self.prefill_shapes.add(tuple(sorted((k, tuple(v.shape)) for k, v in batch.items())))
        return batch

    def _prefill(self, cache, batch, read: torch.Tensor):
        """One target prefill into ``cache``: (cache, the logits (B, V) of
        position ``read`` (B,) of each row, -1 the last). A decoder-only
        LM's rank of a mesh gathers those rows only (``lm_prefill(read=)``:
        the whole (B, S, V) would cross the ranks); elsewhere they are
        read from the whole logits."""
        if self.tp is not None and not self._enc_dec:
            return self.model.prefill(self.ctx, self.params, cache, batch, read=read)
        cache, logits = self.model.prefill(self.ctx, self.params, cache, batch)
        return cache, logits[torch.arange(read.shape[0], device=logits.device), read]

    def _mini_cache(self, n: int, length: int, kv_dtype: str, batch):
        """A dense prefill cache for ``batch``; an enc-dec one holds the
        batch's sources. A dense engine's is laid out as its batch cache
        (a rank's block of the sequence, ``models.layers.seq_rows``); a
        paged engine's is whole, since its pool is."""
        cross = {"enc_len": self._src_len(batch)} if self._enc_dec else {}
        return self.model.init_cache(n, length, kv_dtype, seq_split=not self.paged, **cross)

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
        toks = request.inputs[self._tkey]
        true_len = toks.shape[1]
        # a bucketed family's prompt is right-padded: its last real token
        # sits at true_len - 1; a VLM's prompt runs unpadded, after its
        # image patches, and its last token is the last row
        if self._bucketed:
            toks = torch.nn.functional.pad(toks, (0, self._bucket(true_len) - true_len))
        batch = self._prefill_batch([request], toks.numpy(),
                                    self._upload(np.array([true_len], np.int32)))
        one = self._mini_cache(1, self.max_len, self.kv_dtype, batch)
        one, last = self._prefill(one, batch, self._upload(
            np.array([true_len - 1 if self._bucketed else -1], np.int64)))
        slot = self._upload(np.array([sid], np.int64))
        self._set_sampling(slot, [request], [1])
        first = self._first_tokens(last, [request], slot)
        self._splice(self.cache, one, sid)
        if self.draft is not None:
            # the draft only warms its own cache: the first token is the
            # target's
            d = self.draft
            d_one = self._mini_cache(1, self.max_len, d.kv_dtype, batch)
            d_one, _ = self.model.prefill(d.ctx, d.params, d_one, batch)
            self._splice(self.draft_cache, d_one, sid)
        self.cur[sid, 0] = first[0]
        tok = int(first[0])             # admission waits for its first token
        now = self._now()
        self.prefill_calls += 1
        self.prefill_s += time.perf_counter() - t0
        if tr is not None:
            # the span [t0, now] on the engine clock: a duration read after
            # ``now`` would start it before its request under a slow host
            p_dur = now - self._skew_s - t0
            tr.complete(request.id + 1, "prefill", now - p_dur, p_dur)
        s.request, s.tokens, s.active = request, [], True
        s.seq = self._admit_seq
        self._admit_seq += 1
        self._dirty_slots.add(sid)
        self._stats[request.id].first_token_s = now
        self._emit(s, tok, synced=False)

    @staticmethod
    def _splice(cache, one, sid: int) -> None:
        """Write a one-slot cache into batch slot ``sid`` of ``cache``, in
        place, cast to the leaf's dtype (a prefilled SSM conv state rounds
        to its bf16 leaf). The cross-attention leaves are zero-padded from
        the request's source length to the engine's capacity
        (``cross_len`` masks the rest); ``pos`` / ``len`` / ``cross_len`` /
        ``pos_roll`` and every 1-D leaf carry the batch axis first, the
        layer-stacked K/V and state leaves second."""
        for key, c in cache.items():
            o = one[key].to(c.dtype)
            if key in _BATCH_LEADING or c.dim() == 1:
                c[sid] = o[0]
            elif key.startswith("cross_"):
                c[:, sid] = 0
                c[:, sid, :o.shape[2]] = o[:, 0]
            else:
                c[:, sid] = o[:, 0]

    def _arm_pages(self, request: Request) -> int:
        """Pages one KV arm reserves under whole-budget reservation
        (draft-armed engines): the full prompt + decode budget."""
        budget = request.inputs[self._tkey].shape[1] + request.params.max_new_tokens
        return pages_needed(min(budget, self.max_len), self.page_size)

    def _request_pages(self, request: Request) -> int:
        """The whole-budget reservation across arms (a draft arm holds a
        second chain of the same length in its own KV format): the most a
        request holds, and what a draft-armed engine admits with."""
        return self._arm_pages(request) * (2 if self.draft is not None else 1)

    def _admit_pages(self, request: Request) -> int:
        """Pages a paged admission allocates now: the prefill feed's when
        on demand, else every arm's whole budget."""
        if self.on_demand:
            return pages_needed(self._feed_tokens(request).shape[1], self.page_size)
        return self._request_pages(request)

    def _shape_key(self, request: Request):
        """Batched-prefill key: the feed's bucket (prompt, plus replayed
        tokens on a resume) and the source (tokens or frames) or image
        shape."""
        return (self._bucket(self._feed_tokens(request).shape[1]),) + tuple(
            (k, tuple(request.inputs[k].shape[1:])) for k in _SOURCES + ("img_embeds",)
            if k in request.inputs)

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
            chain = self.allocator.alloc_chain(
                pages_needed(true_lens[i], self.page_size) if self.on_demand
                else self._arm_pages(r))
            chains.append(chain)
            rows[i, :len(chain)] = chain
        dchains = []
        if self.draft is not None:
            drows = np.zeros((n, self.max_pages), np.int32)
            for i, r in enumerate(group):
                dchains.append(self.allocator.alloc_chain(self._arm_pages(r)))
                drows[i, :len(dchains[i])] = dchains[i]
        stashes = [self._preempted.pop(r.id, None) for r in group]
        lengths = self._upload(np.array(true_lens, np.int32))
        batch = self._prefill_batch(group, tgt, lengths)
        mini = self._mini_cache(n, pad_to, self.kv_dtype, batch)
        mini, last = self._prefill(mini, batch, lengths.long() - 1)
        slot_ids = self._upload(np.array(free, np.int64))
        self._set_sampling(slot_ids, group, [len(st) if st else 1 for st in stashes])
        first = self._first_tokens(last, group, slot_ids)
        paged_insert(self.cache, mini, slot_ids, self._upload(rows), lengths)
        if self.draft is not None:
            # the draft only warms its own cache: first tokens are the
            # target's
            d = self.draft
            dmini = self._mini_cache(n, pad_to, d.kv_dtype, batch)
            dmini, _ = self.model.prefill(d.ctx, d.params, dmini, batch)
            paged_insert(self.draft_cache, dmini, slot_ids, self._upload(drows), lengths)
        first = first.cpu().tolist()    # admission waits for its first tokens
        toks = [st[-1] if st else tok for st, tok in zip(stashes, first)]
        self.cur[slot_ids, 0] = self._upload(np.array(toks, np.int32))
        now = self._now()
        self.prefill_calls += 1
        self.prefill_s += time.perf_counter() - t0
        if tr is not None:
            # one batched prefill covers the group; each member gets the
            # same complete event on its own track
            p_dur = now - self._skew_s - t0
            for r in group:
                tr.complete(r.id + 1, "prefill", now - p_dur, p_dur, group=n)
        admitted = []
        for i, (r, sid, chain, stash, tok, L) in enumerate(
                zip(group, free, chains, stashes, toks, true_lens)):
            s = self.slots[sid]
            if stash:
                self._resumed += 1
                fid = self._flow_ids.pop(r.id, None)
                if tr is not None:
                    tr.instant(r.id + 1, "resumed", now, replayed=len(stash))
                    if fid is not None:
                        tr.flow_end(r.id + 1, "resume", now, fid)
            self._chains[r.id] = chain
            if self.draft is not None:
                self._draft_chains[r.id] = dchains[i]
            s.request, s.tokens, s.active = r, list(stash) if stash else [], True
            s.seq = self._admit_seq
            self._admit_seq += 1
            if self.on_demand:
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
    B = batch["tgt_in" if model.cfg.family in ("encdec", "audio") else "tokens"].shape[0]
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
