"""Scheduler-owned serving engine: continuous batching with
horizon-fused decode, over a dense or a block-paged KV cache.

    rid  = engine.submit(inputs, SamplingParams(...))   # enqueue
    outs = engine.step()       # admit + one fused decode horizon
    outs = engine.run_until_drained()                   # serve everything

Admission prefills each queued request (prompt right-padded to its
power-of-two bucket, true length in ``lengths``) and samples its first
token from the logits at ``length - 1``. The dense engine (the default)
prefills one request at a time into a one-slot cache and splices it into
a free slot of the ``(slots, max_len)`` batch cache. The paged engine
(``paged=True``) batches same-shaped requests into one prefill and
scatters the prompt K/V into page chains reserved for the request's
whole budget.

A decode horizon then runs ``K`` decode + sample micro-steps on the
device with per-slot ``alive`` / remaining-budget masks — a slot that
emits its ``eos_id`` or exhausts ``max_new_tokens`` keeps decoding into
masked positions (the trash page when paged), frozen — and brings the
``(K, slots)`` token block to the host with ONE sync. The host walk
retires slots on EOS or length (reclaiming their pages when paged);
queued requests fill freed slots at the next horizon boundary. ``K`` is
clamped to the power-of-two bucket of the largest remaining budget.
Slots never attend to each other and each request draws its sampling
noise from its own seeded stream, so the token streams depend neither on
the horizon, nor on admission timing, nor on the cache layout.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import random as prng
from ..unported import later
from .paged_cache import TRASH_PAGE, PageAllocator, paged_insert, pages_needed
from .params import GREEDY, Request, RequestOutput, RequestStats, SamplingParams
from .sampler import ERR_TOKEN, sample_tokens, sample_tokens_scan

__all__ = ["ServeEngine"]


@dataclasses.dataclass
class _Slot:
    id: int
    tokens: list = dataclasses.field(default_factory=list)
    active: bool = False
    request: Optional[Request] = None


class ServeEngine:
    """Fixed-slot continuous-batching engine over a dense or paged KV cache."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 kv_dtype: str = "bf16", ctx=None, paged: bool = False,
                 page_size: int = 8, num_pages: Optional[int] = None,
                 max_src_len: Optional[int] = None, horizon: int = 1,
                 device="cuda"):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
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
        self._chains: Dict[int, list] = {}
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
        self.decode_steps = 0        # micro-steps run on the device
        self.decode_syncs = 0        # token blocks brought to the host
        self.prefill_calls = 0
        # host wall time of the synced prefill / decode calls
        self.prefill_s = 0.0
        self.decode_s = 0.0

    # -- request API -------------------------------------------------------

    def submit(self, request, params: Optional[SamplingParams] = None) -> int:
        """Enqueue a request (a Request or a B=1 batch dict with
        ``src_tokens`` and ``tgt_in``); returns its id. Admission happens
        at the next step, so a burst of submits lands as one batched
        prefill."""
        if not isinstance(request, Request):
            request = Request(inputs=dict(request), params=params or GREEDY)
        elif params is not None:
            request = dataclasses.replace(request, params=params)
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
        self._stats[request.id] = RequestStats(arrival_s=time.perf_counter(),
                                               prompt_len=prompt_len)
        self._queue.append(request)
        return request.id

    def step(self, horizon: Optional[int] = None) -> List[RequestOutput]:
        """Admit pending requests, run one fused decode horizon, and
        return the outputs of every request finished in this step."""
        K = int(horizon or self.horizon)
        if K < 1:
            raise ValueError(f"horizon must be >= 1, got {K}")
        self._admit_pending()
        if any(s.active for s in self.slots):
            K = min(K, self._bucket(self._max_rem()))
            self._walk_block(self._run_horizon(K))
        out, self._finished = self._finished, []
        return out

    def run_until_drained(self, max_steps: int = 1_000_000,
                          horizon: Optional[int] = None) -> List[RequestOutput]:
        """Serve every queued and in-flight request; returns all outputs."""
        outs: List[RequestOutput] = []
        for _ in range(max_steps):
            if not self._queue and not any(s.active for s in self.slots):
                return outs + self.step(horizon)
            outs.extend(self.step(horizon))
        raise RuntimeError("run_until_drained did not converge")

    # -- decode ---------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Smallest power of two >= n, capped at max_len."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _max_rem(self) -> int:
        return max((s.request.params.max_new_tokens - len(s.tokens)
                    for s in self.slots if s.active), default=0)

    def _scan_masks(self):
        alive = np.zeros((self.n_slots,), np.int32)
        rem = np.zeros((self.n_slots,), np.int32)
        eos = np.full((self.n_slots,), -1, np.int32)
        for s in self.slots:
            if s.active:
                sp = s.request.params
                alive[s.id] = 1
                rem[s.id] = sp.max_new_tokens - len(s.tokens)
                if sp.eos_id is not None:
                    eos[s.id] = sp.eos_id
        return (torch.from_numpy(a).to(self.device) for a in (alive, rem, eos))

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

    @torch.no_grad()
    def _run_horizon(self, K: int) -> np.ndarray:
        """K decode + sample micro-steps on the device; one host sync."""
        t0 = time.perf_counter()
        alive, rem, eos = self._scan_masks()
        greedy = self._all_greedy(s.request for s in self.slots if s.active)
        cache, cur, toks = self.cache, self.cur, []
        for _ in range(K):
            # dense caches take the mask for the step only; paged caches
            # keep it
            cache = dict(cache, active=alive)
            cache, logits = self.model.decode_step(self.ctx, self.params, cur, cache)
            if not self.paged:
                del cache["active"]
            tok = sample_tokens_scan(logits[:, -1], self._temps, self._top_ks,
                                     self._top_ps, self._keys, self._offsets, alive,
                                     all_greedy=greedy)
            self._offsets = self._offsets + 1
            rem = rem - alive
            done = ((alive > 0) & (eos >= 0) & (tok == eos)) | (rem <= 0) \
                | (tok == ERR_TOKEN)
            alive = torch.where(done, 0, alive)
            cur = tok[:, None]
            toks.append(tok)
        self.cache, self.cur = cache, cur
        block = torch.stack(toks).cpu().numpy()
        self.decode_steps += K
        self.decode_syncs += 1
        self.decode_s += time.perf_counter() - t0
        return block

    def _walk_block(self, block: np.ndarray) -> None:
        for s in self.slots:
            for t in range(block.shape[0]):
                if not s.active:
                    break
                self._emit(s, int(block[t, s.id]))

    def _emit(self, s: _Slot, tok: int) -> None:
        if tok == ERR_TOKEN:
            self._retire(s, "error")
            return
        s.tokens.append(tok)
        sp = s.request.params
        if sp.eos_id is not None and tok == sp.eos_id:
            self._retire(s, "eos")
        elif len(s.tokens) >= sp.max_new_tokens:
            self._retire(s, "length")

    def _retire(self, s: _Slot, reason: str) -> None:
        rid = s.request.id
        st = self._stats.pop(rid)
        st.finished_s = time.perf_counter()
        st.new_tokens = len(s.tokens)
        self._finished.append(RequestOutput(rid, s.request.inputs, list(s.tokens),
                                            reason, st, slot=s.id))
        s.active, s.request, s.tokens = False, None, []
        if self.paged:
            # reclaim the chain and park the slot on the trash page
            self.allocator.free_chain(self._chains.pop(rid))
            self.cache["block_tables"][s.id] = TRASH_PAGE
            self.cache["active"][s.id] = 0
            self.cache["len"][s.id] = 0

    # -- admission ----------------------------------------------------------------

    def _admit_pending(self) -> None:
        if not self.paged:
            while self._queue and not all(s.active for s in self.slots):
                self._admit(self._queue.popleft())
            return
        while self._queue:
            group = self._take_group()
            if not group:
                break
            self._admit_group(group)

    def _set_sampling(self, slot_ids, requests) -> None:
        """Load the requests' sampling knobs and base keys into their
        slots (token 0 draws fold 0, so offsets start at 1)."""
        dev = self.device
        sps = [r.params for r in requests]
        self._temps[slot_ids] = torch.tensor([sp.temperature for sp in sps],
                                             dtype=torch.float32, device=dev)
        self._top_ks[slot_ids] = torch.tensor([sp.top_k for sp in sps],
                                              dtype=torch.int64, device=dev)
        self._top_ps[slot_ids] = torch.tensor([sp.top_p for sp in sps],
                                              dtype=torch.float32, device=dev)
        self._keys[slot_ids] = torch.stack([prng.prng_key(sp.seed, dev) for sp in sps])
        self._offsets[slot_ids] = 1

    def _go_live(self, requests, slot_ids, first, now) -> None:
        for r, sid in zip(requests, slot_ids):
            s = self.slots[sid]
            s.request, s.tokens, s.active = r, [], True
            self._stats[r.id].first_token_s = now
        for sid, tok in zip(slot_ids, first):
            self._emit(self.slots[sid], tok)

    # -- dense admission ----------------------------------------------------------

    @torch.no_grad()
    def _admit(self, request: Request) -> None:
        """Prefill one request into a one-slot cache, sample its first
        token, and splice the cache into the first free slot."""
        t0 = time.perf_counter()
        sid = next(s.id for s in self.slots if not s.active)
        dev = self.device
        true_len = request.inputs["tgt_in"].shape[1]
        tgt = torch.nn.functional.pad(request.inputs["tgt_in"],
                                      (0, self._bucket(true_len) - true_len))
        src = request.inputs["src_tokens"]
        one = self.model.init_cache(1, self.max_len, self.kv_dtype,
                                    enc_len=src.shape[1])
        one, logits = self.model.prefill(
            self.ctx, self.params, one,
            {"tgt_in": tgt.to(dev), "src_tokens": src.to(dev),
             "lengths": torch.tensor([true_len], dtype=torch.int32, device=dev)})
        slot = torch.tensor([sid], dtype=torch.int64, device=dev)
        self._set_sampling(slot, [request])
        first = self._first_tokens(logits[:, true_len - 1], [request], slot)
        self._splice(one, sid)
        self.cur[sid, 0] = first[0]
        first = first.cpu().tolist()
        now = time.perf_counter()
        self.prefill_calls += 1
        self.prefill_s += now - t0
        self._go_live([request], [sid], first, now)

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

    # -- paged admission --------------------------------------------------------

    def _arm_pages(self, request: Request) -> int:
        """Pages reserved at admission: the whole prompt + decode budget."""
        budget = request.inputs["tgt_in"].shape[1] + request.params.max_new_tokens
        return pages_needed(min(budget, self.max_len), self.page_size)

    def _shape_key(self, request: Request):
        return (self._bucket(request.inputs["tgt_in"].shape[1]),
                tuple(request.inputs["src_tokens"].shape[1:]))

    def _take_group(self) -> List[Request]:
        """Pop the next batched-prefill group off the queue: same-shaped
        requests from the head while slots and pages last, trimmed to a
        power-of-two size. An empty return means the head is blocked."""
        free = sum(not s.active for s in self.slots)
        if not free or not self._queue:
            return []
        head_key = self._shape_key(self._queue[0])
        group: List[Request] = []
        need = 0
        for r in self._queue:
            if len(group) >= free or self._shape_key(r) != head_key:
                break
            pages = self._arm_pages(r)
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
        """Admit a same-shape group under one batched prefill + insert."""
        t0 = time.perf_counter()
        n = len(group)
        free = [s.id for s in self.slots if not s.active][:n]
        dev = self.device
        true_lens = [r.inputs["tgt_in"].shape[1] for r in group]
        pad_to = self._bucket(max(true_lens))
        tgt = torch.cat([torch.nn.functional.pad(r.inputs["tgt_in"],
                                                 (0, pad_to - L))
                         for r, L in zip(group, true_lens)])
        src = torch.cat([r.inputs["src_tokens"] for r in group])
        lengths = torch.tensor(true_lens, dtype=torch.int32)
        rows = torch.zeros((n, self.max_pages), dtype=torch.int32)  # 0 = trash
        for i, r in enumerate(group):
            chain = self.allocator.alloc_chain(self._arm_pages(r))
            self._chains[r.id] = chain
            rows[i, :len(chain)] = torch.tensor(chain, dtype=torch.int32)
        lengths_d = lengths.to(dev)
        mini = self.model.init_cache(n, pad_to, self.kv_dtype,
                                     enc_len=src.shape[1])
        mini, logits = self.model.prefill(
            self.ctx, self.params, mini,
            {"tgt_in": tgt.to(dev), "src_tokens": src.to(dev),
             "lengths": lengths_d})
        slot_ids = torch.tensor(free, dtype=torch.int64, device=dev)
        self._set_sampling(slot_ids, group)
        first = self._first_tokens(
            logits[torch.arange(n, device=dev), lengths_d.long() - 1], group, slot_ids)
        paged_insert(self.cache, mini, slot_ids, rows.to(dev), lengths_d)
        self.cur[slot_ids, 0] = first
        first = first.cpu().tolist()
        now = time.perf_counter()
        self.prefill_calls += 1
        self.prefill_s += now - t0
        self._go_live(group, free, first, now)
