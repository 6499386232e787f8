"""Continuous-batching inference over the compiled PCG: KV caches
(kv_cache), prefill/decode steps (engine), the iteration-level scheduler
(scheduler) and the ServeConfig / generate() surface (api)."""

from flexflow_tpu_torch.serving.api import ServeConfig, build_scheduler, generate
from flexflow_tpu_torch.serving.engine import GenerationEngine
from flexflow_tpu_torch.serving.kv_cache import KVCache, KVCacheSpec, PagedKVCache
from flexflow_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestStatus,
    SchedulerStats,
    StaticBatchingScheduler,
    latency_percentiles,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "GenerationEngine",
    "KVCache",
    "KVCacheSpec",
    "PagedKVCache",
    "Request",
    "RequestStatus",
    "SchedulerStats",
    "ServeConfig",
    "StaticBatchingScheduler",
    "build_scheduler",
    "generate",
    "latency_percentiles",
]
