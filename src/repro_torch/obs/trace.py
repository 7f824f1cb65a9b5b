"""Ring-buffered structured tracer with a Chrome/Perfetto exporter.

Design constraints, in order:

1. **Zero cost when disabled.** The serving engine guards every emission
   behind ``if self.trace is not None`` — no tracer object, no event
   allocation, no clock read. The tracer itself never touches the
   device, so enabling it cannot add host<->device syncs (the
   tests assert ``decode_syncs`` parity between traced/untraced runs).
2. **Bounded memory.** Events land in a ring of ``capacity`` entries;
   once full the oldest events are dropped and counted in
   ``Tracer.dropped``. Smoke-scale runs must never drop (tripwired).
3. **Engine-clock timestamps.** Callers stamp events from the engine's
   own ``_now()`` (perf_counter + fault-injected skew), so a
   ``FaultPlan`` skew step is visible as a jump in the trace. Skew in
   the repo's fault plans only moves the clock forward; as a belt for
   hypothetical negative skew, ``begin``/``end`` stamps are clamped to
   be non-decreasing so span nesting stays valid.

Track (``tid``) convention: tid 0 (:data:`SCHED_TID`) is the scheduler
track carrying ``round`` spans with ``admit``/``dispatch``/``sync``/
``walk`` phase events; each request gets tid ``rid + 1`` carrying its
lifecycle span (``request`` wrapping ``queued``, a ``prefill`` complete
event, ``decode-round``/``verify``/``preempted``/``resumed`` instants,
and a ``retired`` instant with the finish reason). A ``resume`` flow
pair (``flow_start`` at each preemption, ``flow_end`` at the matching
resume — or at retirement if the stashed request dies queued) links a
preempted request's two slot residencies, so Perfetto draws the
continuity arrow across the gap.

Export is the Chrome ``trace_event`` JSON array format — load the file
in ``chrome://tracing`` or https://ui.perfetto.dev.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = ["PHASES", "SCHED_TID", "TraceConfig", "TraceEvent", "Tracer"]

# Scheduler round phases, in the order they run inside a round.
PHASES: Tuple[str, ...] = ("admit", "dispatch", "sync", "walk")

SCHED_TID = 0
_PID = 1  # single-process engine; one pid for the whole trace


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Tracer knobs. ``capacity`` bounds resident events (ring buffer)."""

    capacity: int = 1 << 16

    def __post_init__(self) -> None:
        if self.capacity < 16:
            raise ValueError(f"trace capacity must be >= 16, got {self.capacity}")


@dataclasses.dataclass
class TraceEvent:
    """One structured event. ``ph`` follows the Chrome trace_event
    phases this exporter emits: B/E (span begin/end), X (complete, with
    ``dur_us``), i (instant), s/f (flow start/finish, carrying
    ``flow_id`` — Perfetto draws an arrow between the slices enclosing
    the two endpoints)."""

    ph: str
    name: str
    ts_us: float
    tid: int
    dur_us: float = 0.0
    args: Optional[Dict[str, Any]] = None
    flow_id: Optional[int] = None

    def to_chrome(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name, "cat": "serving", "ph": self.ph,
            "ts": self.ts_us, "pid": _PID, "tid": self.tid,
        }
        if self.ph == "X":
            d["dur"] = self.dur_us
        if self.ph == "i":
            d["s"] = "t"  # instant scoped to its thread/track
        if self.ph in ("s", "f"):
            d["id"] = self.flow_id
            if self.ph == "f":
                d["bp"] = "e"  # bind to the enclosing slice, not the next
        if self.args:
            d["args"] = self.args
        return d


class Tracer:
    """Collects :class:`TraceEvent` s; see module docstring for the
    track/span conventions the serving engine uses."""

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config or TraceConfig()
        self.events: Deque[TraceEvent] = deque(maxlen=self.config.capacity)
        self.dropped = 0
        self._floor_us = float("-inf")
        self._next_flow = 0
        self._track_names: Dict[int, str] = {SCHED_TID: "scheduler"}

    def __len__(self) -> int:
        return len(self.events)

    def name_track(self, tid: int, name: str) -> None:
        self._track_names.setdefault(tid, name)

    def _record(self, ev: TraceEvent) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def _stamp(self, ts_s: float) -> float:
        """Span-edge stamp, clamped non-decreasing (negative-skew belt)."""
        us = ts_s * 1e6
        if us < self._floor_us:
            return self._floor_us
        self._floor_us = us
        return us

    def begin(self, tid: int, name: str, ts_s: float, **args: Any) -> None:
        self._record(TraceEvent("B", name, self._stamp(ts_s), tid,
                                args=args or None))

    def end(self, tid: int, name: str, ts_s: float, **args: Any) -> None:
        self._record(TraceEvent("E", name, self._stamp(ts_s), tid,
                                args=args or None))

    def instant(self, tid: int, name: str, ts_s: float, **args: Any) -> None:
        # Instants are points: they cannot break B/E nesting, so they
        # keep their caller-supplied timestamp un-clamped (a decode
        # round's instant is stamped at its walk start, which may
        # precede an already-recorded retire edge from another slot).
        self._record(TraceEvent("i", name, ts_s * 1e6, tid,
                                args=args or None))

    def complete(self, tid: int, name: str, ts_s: float, dur_s: float,
                 **args: Any) -> None:
        self._record(TraceEvent("X", name, ts_s * 1e6, tid,
                                dur_us=max(dur_s, 0.0) * 1e6,
                                args=args or None))

    def flow_start(self, tid: int, name: str, ts_s: float,
                   **args: Any) -> int:
        """Open a flow link (Chrome ``s`` event) and return its fresh
        flow id. The serving engine links a preempted request's two
        slot residencies this way: ``flow_start`` at the preemption,
        ``flow_end`` with the returned id at the resume (or at
        retirement, if the request dies while stashed) — Perfetto draws
        the arrow, and :meth:`check` enforces the pairing. Flow stamps
        are points, un-clamped like instants."""
        self._next_flow += 1
        self._record(TraceEvent("s", name, ts_s * 1e6, tid,
                                args=args or None,
                                flow_id=self._next_flow))
        return self._next_flow

    def flow_end(self, tid: int, name: str, ts_s: float, flow_id: int,
                 **args: Any) -> None:
        """Close the flow link opened by :meth:`flow_start` under the
        same ``name`` and the id it returned."""
        self._record(TraceEvent("f", name, ts_s * 1e6, tid,
                                args=args or None, flow_id=flow_id))

    # ------------------------------------------------------------------
    # Validation — used by bench/CI tripwires and tests.
    # ------------------------------------------------------------------

    def check(self) -> List[str]:
        """Validate span discipline; returns a list of problems (empty
        means the trace is well-formed).

        Checks, per track, in recorded order: every E closes the
        matching innermost B (same name, end >= begin), child events do
        not start before their enclosing span, a span does not end
        before a child event recorded inside it ended, and nothing is
        left open. Flow links are pair-checked globally: every ``f``
        must consume a prior ``s`` with the same flow id and name at a
        non-earlier stamp, each id is consumed at most once, and no
        link is left dangling (the engine closes every preemption link
        — at the resume, or at retirement if the stashed request dies
        queued). Recorded order is the ground truth for nesting —
        the engine emits strictly stack-disciplined spans.
        """
        problems: List[str] = []
        # tid -> stack of [begin_event, max_child_end_us]
        stacks: Dict[int, List[List[Any]]] = {}
        open_flows: Dict[int, TraceEvent] = {}
        for ev in self.events:
            st = stacks.setdefault(ev.tid, [])
            if ev.ph in ("s", "f"):
                if ev.ph == "s":
                    if ev.flow_id in open_flows:
                        problems.append(
                            f"tid {ev.tid}: flow {ev.flow_id} started twice")
                    open_flows[ev.flow_id] = ev
                else:
                    s = open_flows.pop(ev.flow_id, None)
                    if s is None:
                        problems.append(
                            f"tid {ev.tid}: f {ev.name!r} flow {ev.flow_id} "
                            f"without matching s")
                    else:
                        if s.name != ev.name:
                            problems.append(
                                f"flow {ev.flow_id}: f {ev.name!r} closes "
                                f"s {s.name!r}")
                        if ev.ts_us < s.ts_us:
                            problems.append(
                                f"flow {ev.flow_id} ({ev.name!r}) ends "
                                f"before it starts")
                continue
            if ev.ph == "B":
                if st and ev.ts_us < st[-1][0].ts_us:
                    problems.append(
                        f"tid {ev.tid}: B {ev.name!r} at {ev.ts_us:.1f}us "
                        f"starts before parent {st[-1][0].name!r}")
                st.append([ev, ev.ts_us])
            elif ev.ph == "E":
                if not st:
                    problems.append(f"tid {ev.tid}: E {ev.name!r} without open span")
                    continue
                b, max_child_end = st.pop()
                if b.name != ev.name:
                    problems.append(
                        f"tid {ev.tid}: E {ev.name!r} closes B {b.name!r}")
                if ev.ts_us < b.ts_us:
                    problems.append(
                        f"tid {ev.tid}: span {ev.name!r} ends before it begins")
                if ev.ts_us < max_child_end:
                    problems.append(
                        f"tid {ev.tid}: span {ev.name!r} ends at "
                        f"{ev.ts_us:.1f}us before child at {max_child_end:.1f}us")
                if st:
                    st[-1][1] = max(st[-1][1], ev.ts_us)
            else:  # X / i
                end = ev.ts_us + ev.dur_us
                if st:
                    if ev.ts_us + 1e-3 < st[-1][0].ts_us:  # 1ns grace
                        problems.append(
                            f"tid {ev.tid}: {ev.ph} {ev.name!r} starts before "
                            f"enclosing {st[-1][0].name!r}")
                    st[-1][1] = max(st[-1][1], end)
        for tid, st in stacks.items():
            for b, _ in st:
                problems.append(f"tid {tid}: span {b.name!r} never closed")
        for fid, s in open_flows.items():
            problems.append(
                f"tid {s.tid}: flow {fid} ({s.name!r}) never finished")
        return problems

    def request_spans(self) -> Dict[int, Dict[str, Any]]:
        """Summarize request lifecycle spans, keyed by request id.

        Each entry has ``closed`` (the ``request`` span got its E),
        ``begin_us``/``end_us``, ``reason`` (from the ``retired``
        instant), and ``events`` (child event names in recorded order).
        """
        spans: Dict[int, Dict[str, Any]] = {}
        open_by_tid: Dict[int, int] = {}
        for ev in self.events:
            if ev.tid == SCHED_TID:
                continue
            if ev.ph == "B" and ev.name == "request":
                rid = int((ev.args or {}).get("rid", ev.tid - 1))
                spans[rid] = {"closed": False, "begin_us": ev.ts_us,
                              "end_us": None, "reason": None, "events": []}
                open_by_tid[ev.tid] = rid
                continue
            rid = open_by_tid.get(ev.tid)
            if rid is None:
                continue
            span = spans[rid]
            if ev.ph == "E" and ev.name == "request":
                span["closed"] = True
                span["end_us"] = ev.ts_us
                del open_by_tid[ev.tid]
            elif ev.ph not in ("E", "s", "f"):
                span["events"].append(ev.name)
                if ev.name == "retired":
                    span["reason"] = (ev.args or {}).get("reason")
        return spans

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object format."""
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": _PID,
            "args": {"name": "repro_torch.serving"},
        }]
        for tid in sorted(self._track_names):
            meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                         "tid": tid,
                         "args": {"name": self._track_names[tid]}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": _PID,
                         "tid": tid, "args": {"sort_index": tid}})
        return {
            "traceEvents": meta + [ev.to_chrome() for ev in self.events],
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
