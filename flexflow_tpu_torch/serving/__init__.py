"""Continuous-batching inference over the compiled PCG: KV caches
(kv_cache), prefill/decode/verify steps (engine), the iteration-level
scheduler (scheduler), speculative decoding's drafts and acceptance
rules (spec), multi-tenant adapters and weighted-fair classes (tenancy)
and the ServeConfig / generate() surface (api)."""

from flexflow_tpu_torch.serving.api import ServeConfig, build_proposer, build_scheduler, generate
from flexflow_tpu_torch.serving.engine import GenerationEngine, InflightStep
from flexflow_tpu_torch.serving.kv_cache import KVCache, KVCacheSpec, PagedKVCache
from flexflow_tpu_torch.serving.scheduler import (
    AsyncContinuousBatchingScheduler,
    ContinuousBatchingScheduler,
    Request,
    RequestStatus,
    SchedulerStats,
    StaticBatchingScheduler,
    latency_percentiles,
)
from flexflow_tpu_torch.serving.spec import (
    DraftTree,
    ModelDraftProposer,
    NGramDraftProposer,
    accept_drafts,
    accept_tree,
)
from flexflow_tpu_torch.serving.tenancy import (
    AdapterPool,
    AdapterPoolExhausted,
    DeficitRoundRobin,
    PriorityClass,
    make_lora_weights,
    parse_classes,
)

__all__ = [
    "AdapterPool",
    "AdapterPoolExhausted",
    "AsyncContinuousBatchingScheduler",
    "ContinuousBatchingScheduler",
    "DeficitRoundRobin",
    "DraftTree",
    "GenerationEngine",
    "InflightStep",
    "KVCache",
    "KVCacheSpec",
    "ModelDraftProposer",
    "NGramDraftProposer",
    "PagedKVCache",
    "PriorityClass",
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
    "make_lora_weights",
    "parse_classes",
]
