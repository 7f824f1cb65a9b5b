"""Deterministic fault injection for the serving engine (the port's
own copy of the reference's ``serving/faults.py``; numpy only).

The paper's deployment target is resource-limited hardware where pool
exhaustion, stragglers, and numerically fragile sub-octet arms are the
steady state — so the fault paths (deadlines, preemption, the sampler's
NaN guard) need a way to be exercised *deterministically*, not by
hoping a real fault shows up. ``FaultPlan`` is that harness: a seeded
schedule of synthetic faults that ``deploy(..., faults=plan)`` threads
into the engine, which then calls back at two well-defined points:

  * ``on_round(engine)`` — once at every scheduler round boundary
    (``step()`` and each ``_rounds`` iteration, including no-op rounds
    while the queue is blocked, so transient faults always clear).
    Injects **allocator exhaustion** (steal pages from the engine's
    free list and hold them for ``hold`` rounds — the engine sees a
    genuinely shrunken pool and must preempt; ``PageAllocator.check()``
    still passes because the steal is a real allocation) and **clock
    skew** (advance the engine's deadline clock by ``ms`` without
    sleeping — deadline tests run in microseconds of real time).
  * ``poison(n_slots, K)`` — once per decode dispatch; returns a per-
    slot micro-step index at which that slot's logits are forced to
    NaN (or ``None`` for a clean dispatch), driving the sampler's
    poisoned-request isolation path.

Faults come from explicit event lists (exact round / dispatch
coordinates — CI tripwires want guaranteed fault counts) and/or seeded
random rates (chaos testing wants coverage). Every injected fault is
appended to ``plan.events``, so two plans with the same seed driving
the same engine produce identical event logs — the determinism the
chaos equivalence tests assert.

Under a tensor-parallel mesh every rank builds its plan from the same
arguments and its engine resets it at construction; the plan ticks
``on_round`` once a round and ``poison`` once a dispatch, and draws from
its own seeded RNG, so every rank steals the same pages at the same
rounds, poisons the same slots (the NaN lands on the gathered logits)
and logs the same events. A skew moves only what a rank's own clock
says, and only rank 0's clock decides an expiry (the engine's control
channel), so the skew expires the same requests on every rank.

A plan is stateful and belongs to ONE engine at a time: the engine
resets it at construction, and ``release_all(engine)`` returns any
still-held pages after a drain (tests call it before asserting
``pages_in_use == 0``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["FaultPlan"]


class FaultPlan:
    """Seeded, deterministic schedule of synthetic serving faults.

    Explicit events (all optional, exact coordinates):
      * ``exhaust_at``: ``(round, pages, hold)`` — at scheduler round
        ``round``, steal up to ``pages`` free pages and hold them for
        ``hold`` rounds.
      * ``nan_at``: ``(dispatch, slot, micro_step)`` — at the
        ``dispatch``-th decode dispatch, force slot ``slot``'s logits
        to NaN at micro-step ``micro_step`` (clamped into the scan).
      * ``skew_at``: ``(round, ms)`` — advance the engine's deadline
        clock by ``ms`` at round ``round``.

    Random rates (chaos mode, driven by ``seed``):
      * ``exhaust_prob`` / ``exhaust_pages`` / ``exhaust_hold``: per
        round, with probability ``exhaust_prob``, steal
        ``exhaust_pages`` pages for ``exhaust_hold`` rounds.
      * ``nan_prob``: per dispatch, poison one uniformly-drawn
        (slot, micro_step).
      * ``skew_prob`` / ``skew_ms``: per round, advance the clock.

    Holds are always finite (``hold >= 1``), so a blocked queue drains
    once the hold expires — no plan can wedge the engine forever.
    """

    def __init__(self, seed: int = 0, *,
                 exhaust_at: Sequence[Tuple[int, int, int]] = (),
                 exhaust_prob: float = 0.0, exhaust_pages: int = 0,
                 exhaust_hold: int = 2,
                 nan_at: Sequence[Tuple[int, int, int]] = (),
                 nan_prob: float = 0.0,
                 skew_at: Sequence[Tuple[int, float]] = (),
                 skew_prob: float = 0.0, skew_ms: float = 0.0):
        for name, p in (("exhaust_prob", exhaust_prob),
                        ("nan_prob", nan_prob), ("skew_prob", skew_prob)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if exhaust_hold < 1:
            raise ValueError(f"exhaust_hold must be >= 1, got {exhaust_hold}")
        for r, pages, hold in exhaust_at:
            if hold < 1:
                raise ValueError(
                    f"exhaust_at hold must be >= 1 (round {r}): a page "
                    "held forever would wedge the admission queue")
        self.seed = int(seed)
        self.exhaust_at = tuple((int(r), int(p), int(h))
                                for r, p, h in exhaust_at)
        self.exhaust_prob = float(exhaust_prob)
        self.exhaust_pages = int(exhaust_pages)
        self.exhaust_hold = int(exhaust_hold)
        self.nan_at = tuple((int(d), int(s), int(m)) for d, s, m in nan_at)
        self.nan_prob = float(nan_prob)
        self.skew_at = tuple((int(r), float(m)) for r, m in skew_at)
        self.skew_prob = float(skew_prob)
        self.skew_ms = float(skew_ms)
        self.reset()

    def reset(self) -> None:
        """Rewind to round/dispatch 0 with a fresh seeded RNG (the
        engine calls this at construction). Drops any held pages
        without freeing them — call ``release_all`` first if the plan
        is being moved off a live engine."""
        self._rng = np.random.default_rng(self.seed)
        self._round = 0
        self._dispatch = 0
        self._holds: List[Tuple[int, list]] = []   # (release_round, chain)
        self.events: List[tuple] = []

    # -- engine hooks ---------------------------------------------------

    def on_round(self, engine) -> None:
        """Tick one scheduler round: release expired holds, then apply
        this round's exhaustion / clock-skew events. On a traced engine
        every injection additionally lands as an instant on the
        scheduler track, so a trace shows faults at the round they
        fired."""
        r = self._round
        self._round += 1
        tr = getattr(engine, "trace", None)
        paged = bool(getattr(engine, "paged", False))
        if paged and self._holds:
            keep = []
            for rel, chain in self._holds:
                if rel <= r:
                    engine.allocator.free_chain(chain)
                    self.events.append(("release", r, len(chain)))
                    if tr is not None:
                        tr.instant(0, "fault:release", engine._now(),
                                   round=r, pages=len(chain))
                else:
                    keep.append((rel, chain))
            self._holds = keep
        pages = hold = 0
        for rr, p, h in self.exhaust_at:
            if rr == r:
                pages, hold = max(pages, p), max(hold, h)
        if self.exhaust_prob and self._rng.random() < self.exhaust_prob:
            pages = max(pages, self.exhaust_pages)
            hold = max(hold, self.exhaust_hold)
        if pages and paged:
            # a real allocation from the engine's free list: the pool
            # genuinely shrinks, allocator invariants keep holding
            k = min(pages, engine.allocator.num_free)
            if k:
                self._holds.append((r + hold, engine.allocator.alloc_chain(k)))
                self.events.append(("exhaust", r, k, hold))
                if tr is not None:
                    tr.instant(0, "fault:exhaust", engine._now(),
                               round=r, pages=k, hold=hold)
        ms = 0.0
        for rr, m in self.skew_at:
            if rr == r:
                ms += m
        if self.skew_prob and self._rng.random() < self.skew_prob:
            ms += self.skew_ms
        if ms:
            engine._skew_s += ms / 1e3
            self.events.append(("skew", r, ms))
            if tr is not None:
                # stamped AFTER the jump: the instant lands where the
                # skewed clock resumed, making the jump visible
                tr.instant(0, "fault:skew", engine._now(), round=r, ms=ms)

    def poison(self, n_slots: int, K: int):
        """NaN-injection schedule for one decode dispatch: an (S,) i32
        array of per-slot micro-step indices (-1 = clean), or None for
        a dispatch with no injection."""
        d = self._dispatch
        self._dispatch += 1
        arr = None
        for dd, slot, step in self.nan_at:
            if dd == d and 0 <= slot < n_slots:
                if arr is None:
                    arr = np.full((n_slots,), -1, np.int32)
                arr[slot] = min(max(step, 0), K - 1)
        if self.nan_prob and self._rng.random() < self.nan_prob:
            if arr is None:
                arr = np.full((n_slots,), -1, np.int32)
            arr[int(self._rng.integers(n_slots))] = int(self._rng.integers(K))
        if arr is not None:
            self.events.append(("nan", d, tuple(arr.tolist())))
        return arr

    # -- test / bench helpers -------------------------------------------

    @property
    def held_pages(self) -> int:
        return sum(len(chain) for _, chain in self._holds)

    def release_all(self, engine) -> None:
        """Free every still-held page back to the engine's allocator
        (after a drain, before asserting ``pages_in_use == 0``)."""
        for _, chain in self._holds:
            engine.allocator.free_chain(chain)
        self._holds = []
