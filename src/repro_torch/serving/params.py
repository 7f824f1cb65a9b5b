"""Request-level serving types: SamplingParams / Request / RequestOutput.

Every inference call is a ``Request`` carrying its own frozen
``SamplingParams``; every completion is a ``RequestOutput`` with a finish
reason and timing stats:

  * ``eos`` / ``length``    — normal completion.
  * ``abort``               — cancelled by the caller.
  * ``preempted_limit``     — preempted for pages more than the engine's
    ``preempt_limit`` times; retired with its partial tokens.
  * ``error``               — the model gave the slot non-finite logits.
  * ``deadline``            — ``deadline_ms`` elapsed before completion;
    the synced tokens are returned.

  * ``temperature == 0.0`` -> greedy argmax; ``> 0`` samples after the
    ``top_k`` / ``top_p`` filters from the request's own ``seed`` stream.
  * ``eos_id``             -> generation stops the step this token is
    emitted (it is included in the output); ``None`` disables EOS stopping.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..obs.metrics import percentile

__all__ = ["SamplingParams", "GREEDY", "Request", "RequestOutput",
           "RequestStats", "FINISH_REASONS", "EngineSaturated",
           "latency_percentiles"]

FINISH_REASONS = ("eos", "length", "abort", "deadline", "preempted_limit",
                  "error")


class EngineSaturated(RuntimeError):
    """Typed backpressure signal: ``submit`` found the engine's bounded
    pending queue (``max_pending``) full. Carries ``pending`` (queue depth
    at rejection) and ``limit``, so callers retry after a round without
    parsing the message."""

    def __init__(self, pending: int, limit: int):
        self.pending = pending
        self.limit = limit
        super().__init__(
            f"engine saturated: {pending} requests pending >= "
            f"max_pending={limit}; retry after draining")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. Frozen: shareable across requests."""

    temperature: float = 0.0      # 0.0 = greedy
    top_k: int = 0                # 0 = disabled
    top_p: float = 1.0            # 1.0 = disabled
    eos_id: Optional[int] = None  # None = never stop on a token id
    max_new_tokens: int = 16      # includes the prefill-sampled first token
    seed: int = 0
    deadline_ms: Optional[float] = None   # budget from submit, checked at
    #                               round boundaries (None = no deadline)
    priority: int = 0             # preemption victim ordering: on page-pool
    #                               exhaustion the lowest-priority (then
    #                               youngest) request is evicted first

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, got {self.deadline_ms}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    """One inference request: a B=1 model batch dict + sampling params.
    ``id`` is assigned by the engine at submit time.

    ``on_token`` is the streaming hook: the engine calls it with each
    token id as the horizon block carrying that token lands on the host
    (the prefill-sampled first token fires at admission). Callbacks run
    on the scheduler's walk of the synced block; aborting the request
    from inside its own callback wins over an EOS in the same block.
    """

    inputs: Dict[str, Any]
    params: SamplingParams = GREEDY
    id: Optional[int] = None
    on_token: Optional[Callable[[int], None]] = None


@dataclasses.dataclass
class RequestStats:
    """Wall-clock stamps (time.perf_counter) + derived serving metrics.

    ``new_tokens`` is the count of tokens delivered to the caller (an
    aborted request is cut at its last synced position).
    ``drafted`` / ``accepted`` / ``rejected`` count the request's
    speculative-decoding draft tokens (0 without a draft arm).
    ``preemptions`` counts how many times the request was evicted from
    its slot for page pressure.
    """

    arrival_s: float = 0.0
    first_token_s: float = 0.0
    finished_s: float = 0.0
    prompt_len: int = 0
    new_tokens: int = 0
    drafted: int = 0
    accepted: int = 0
    rejected: int = 0
    preemptions: int = 0

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def total_s(self) -> float:
        return self.finished_s - self.arrival_s


@dataclasses.dataclass
class RequestOutput:
    """Completion record for one request."""

    request_id: int
    prompt: Dict[str, Any]
    token_ids: List[int]
    finish_reason: str            # one of FINISH_REASONS
    stats: RequestStats
    slot: int = -1

    @property
    def num_generated(self) -> int:
        return len(self.token_ids)

    @property
    def tok_s(self) -> float:
        dt = self.stats.total_s
        return self.num_generated / dt if dt > 0 else float("inf")

    @property
    def ttft_ms(self) -> float:
        """Time to first token (ms): submit -> prefill token delivered."""
        return self.stats.ttft_s * 1e3

    @property
    def tpot_ms(self) -> float:
        """Per-output-token latency (ms) after the first token: the
        post-first-token span over ``new_tokens - 1`` decode steps (a
        one-token request contributes its whole span)."""
        return ((self.stats.total_s - self.stats.ttft_s)
                / max(self.num_generated - 1, 1)) * 1e3


def latency_percentiles(outputs: Sequence[RequestOutput]) -> Dict[str, float]:
    """p50/p95 TTFT and per-output-token latency (ms) over completions,
    by the nearest-rank ``obs.metrics.percentile``."""
    ttft = [o.ttft_ms for o in outputs]
    tpot = [o.tpot_ms for o in outputs]
    return {"ttft_p50_ms": round(percentile(ttft, 50), 3),
            "ttft_p95_ms": round(percentile(ttft, 95), 3),
            "tpot_p50_ms": round(percentile(tpot, 50), 3),
            "tpot_p95_ms": round(percentile(tpot, 95), 3)}
