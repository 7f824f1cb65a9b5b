"""Request-level serving types: SamplingParams / Request / RequestOutput.

Every inference call is a ``Request`` carrying its own frozen
``SamplingParams``; every completion is a ``RequestOutput`` with a finish
reason (``eos``, ``length`` or ``error`` — the last when the model gave a
slot non-finite logits) and timing stats.

  * ``temperature == 0.0`` -> greedy argmax; ``> 0`` samples after the
    ``top_k`` / ``top_p`` filters from the request's own ``seed`` stream.
  * ``eos_id``             -> generation stops the step this token is
    emitted (it is included in the output); ``None`` disables EOS stopping.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

__all__ = ["SamplingParams", "GREEDY", "Request", "RequestOutput",
           "RequestStats", "FINISH_REASONS"]

FINISH_REASONS = ("eos", "length", "error")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. Frozen: shareable across requests."""

    temperature: float = 0.0      # 0.0 = greedy
    top_k: int = 0                # 0 = disabled
    top_p: float = 1.0            # 1.0 = disabled
    eos_id: Optional[int] = None  # None = never stop on a token id
    max_new_tokens: int = 16      # includes the prefill-sampled first token
    seed: int = 0
    deadline_ms: Optional[float] = None
    priority: int = 0

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
    ``id`` is assigned by the engine at submit time."""

    inputs: Dict[str, Any]
    params: SamplingParams = GREEDY
    id: Optional[int] = None


@dataclasses.dataclass
class RequestStats:
    """Wall-clock stamps (time.perf_counter) of one request."""

    arrival_s: float = 0.0
    first_token_s: float = 0.0
    finished_s: float = 0.0
    prompt_len: int = 0
    new_tokens: int = 0


@dataclasses.dataclass
class RequestOutput:
    """Completion record for one request."""

    request_id: int
    prompt: Dict[str, Any]
    token_ids: List[int]
    finish_reason: str            # one of FINISH_REASONS
    stats: RequestStats
    slot: int = -1
