"""Serving: deploy() -> TranslationPipeline -> SamplingParams / Request /
RequestOutput, scheduled by the queue-owning ServeEngine (submit / step /
run_until_drained / stream / abort) over a dense (default) or block-paged
KV cache with on-demand paging and preemption. Tokens stream as each
fused horizon block lands (``submit(..., on_token=cb)``,
``engine.stream_request``, ``pipe.translate_stream``);
``engine.metrics()`` returns the frozen EngineMetrics snapshot,
``deploy(..., sla=SLATarget(...))`` attaches percentile-feedback
admission control, and ``deploy(..., trace=TraceConfig())`` the tracer.
``SamplingParams(deadline_ms=)`` and ``deploy(max_pending=)`` bound
latency and the queue, ``deploy(faults=FaultPlan(...))`` injects faults,
and ``deploy(draft_spec=...)`` adds a quantized speculative draft arm.
``greedy_generate`` / ``translate`` remain as deprecated single-shot
wrappers."""

from ..obs import TraceConfig, Tracer
from .engine import ServeEngine, greedy_generate, translate
from .faults import FaultPlan
from .metrics import EngineMetrics, SLATarget, merge_metrics
from .paged_cache import PageAllocator, pages_needed
from .params import (FINISH_REASONS, GREEDY, EngineSaturated, Request,
                     RequestOutput, RequestStats, SamplingParams,
                     latency_percentiles)
from .pipeline import (DEFAULT_IMPL, IMPL_CHOICES, TranslationPipeline, deploy,
                       impl_routes)
from .sampler import ERR_TOKEN
from .spec_decode import DraftArm, accept_longest_prefix, build_draft_arm

__all__ = ["ServeEngine", "greedy_generate", "translate", "SamplingParams",
           "GREEDY", "Request", "RequestOutput", "RequestStats",
           "latency_percentiles", "TranslationPipeline", "deploy",
           "impl_routes", "DEFAULT_IMPL", "IMPL_CHOICES", "PageAllocator", "pages_needed",
           "EngineMetrics", "SLATarget", "merge_metrics", "EngineSaturated",
           "FINISH_REASONS", "ERR_TOKEN", "TraceConfig", "Tracer", "FaultPlan",
           "DraftArm", "accept_longest_prefix", "build_draft_arm"]
