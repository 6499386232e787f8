"""Continuous-batching inference over the compiled PCG: KV caches
(kv_cache), prefill/decode/verify steps (engine), the iteration-level
scheduler (scheduler), speculative decoding's drafts and acceptance
rules (spec) and the ServeConfig / generate() surface (api)."""

from flexflow_tpu_torch.serving.api import ServeConfig, build_proposer, build_scheduler, generate
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
from flexflow_tpu_torch.serving.spec import (
    DraftTree,
    NGramDraftProposer,
    accept_drafts,
    accept_tree,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "DraftTree",
    "GenerationEngine",
    "KVCache",
    "KVCacheSpec",
    "NGramDraftProposer",
    "PagedKVCache",
    "Request",
    "RequestStatus",
    "SchedulerStats",
    "ServeConfig",
    "StaticBatchingScheduler",
    "accept_drafts",
    "accept_tree",
    "build_proposer",
    "build_scheduler",
    "generate",
    "latency_percentiles",
]
