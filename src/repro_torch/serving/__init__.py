"""Serving: deploy() -> TranslationPipeline -> SamplingParams / Request /
RequestOutput, scheduled by the queue-owning ServeEngine over a dense
(default) or block-paged KV cache."""

from .engine import ServeEngine
from .paged_cache import PageAllocator, pages_needed
from .params import (FINISH_REASONS, GREEDY, Request, RequestOutput,
                     RequestStats, SamplingParams)
from .pipeline import DEFAULT_IMPL, TranslationPipeline, deploy, impl_routes
from .sampler import ERR_TOKEN

__all__ = ["ServeEngine", "SamplingParams", "GREEDY", "Request",
           "RequestOutput", "RequestStats", "FINISH_REASONS",
           "TranslationPipeline", "deploy", "impl_routes", "DEFAULT_IMPL",
           "PageAllocator", "pages_needed", "ERR_TOKEN"]
