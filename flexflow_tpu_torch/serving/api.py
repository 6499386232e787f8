"""User-facing serving surface: ServeConfig, build_proposer,
build_scheduler and generate() (port of the single-device part of
flexflow_tpu/serving/api.py). `FFModel.generate` delegates here.
Speculative decoding (`spec_draft="ngram"`, linear or token-tree by
`spec_branch`) and int8 paged KV pools (`kv_dtype="int8"`) run through
the CUDA kernels #4-#9 on the card; `decode_multistep=True` fuses runs
of decode steps into CUDA-graph windows there. `temperature` > 0 samples
with the reference's keys under `seed`; `token_budget` > 0 streams
prompts in as chunks of `chunk_size` tokens; `prefix_cache` shares the
pages of common prefixes; `admission="optimistic"` admits on the
prompt's pages and preempts by recompute, up to `max_preemptions` times a
request; `prefix_evict="lru"` keeps released published prefix pages
until the pool needs them; `serve_async` serves with the double-buffered
AsyncContinuousBatchingScheduler. `adapters` > 0 attaches a paged
multi-LoRA AdapterPool (requests pick an adapter by `adapter_id`);
`classes` with more than one class makes admission, chunk grants and
preemption weighted-fair; `spec_draft="model"` drafts with a second,
smaller decoder LM passed as `draft_model`."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from flexflow_tpu_torch.ops.attention import check_mode
from flexflow_tpu_torch.ops.cuda.decode_kernel import MAX_W
from flexflow_tpu_torch.serving.engine import GenerationEngine
from flexflow_tpu_torch.serving.kv_cache import KVCache, PagedKVCache
from flexflow_tpu_torch.serving.scheduler import (
    CHUNK_ALIGN,
    AsyncContinuousBatchingScheduler,
    ContinuousBatchingScheduler,
    Request,
    StaticBatchingScheduler,
)
from flexflow_tpu_torch.serving.spec import ModelDraftProposer, NGramDraftProposer
from flexflow_tpu_torch.serving.tenancy import AdapterPool, parse_classes

_SCHEDULERS = {
    "continuous": ContinuousBatchingScheduler,
    "static": StaticBatchingScheduler,
}

# options of the reference's ServeConfig this port does not take yet:
# field -> (the values accepted, the ROADMAP item that brings the rest)
_NOT_PORTED = {
    "kv_swap": ((False,), "Port queue: swap-to-host, with the cost model's swap decider"),
    "prefix_evict": (("none", "lru"), "Port queue: cost-priced prefix eviction, with the cost model's "
                                      "build_evict_pricer"),
}


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs: the reference's defaults — paged KV layout with
    16-token pages, the continuous scheduler, greedy decoding, an fp32
    cache and no speculation. kv_dtype "int8" stores the paged pools as
    int8 with an fp32 scale per (page, head). spec_draft "ngram" turns
    on speculative decoding with prompt-lookup drafts of spec_k tokens
    (n-gram size spec_ngram), "model" with a small draft LM's (the
    draft_model of build_scheduler / generate); spec_branch > 1 verifies
    a token tree of up to spec_k * spec_branch nodes instead of one
    chain."""

    max_seqs: int = 8  # KV-cache slots = max in-flight requests
    max_seq_len: int = 256  # max tokens per sequence (prompt + generation)
    scheduler: str = "continuous"  # "continuous" | "static"
    eos_token: Optional[int] = None
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0  # sampling keys: fold_in(fold_in(PRNGKey(seed), slot), position)
    prefill_buckets: Tuple[int, ...] = ()  # () = powers of two
    kv_layout: str = "paged"  # "paged" | "slot"
    kv_page_size: int = 0  # 0 = auto (16, halved to divide max_len)
    kv_pages: int = 0  # 0 = max_seqs * max_seq_len / page_size
    decode_kernel: str = "auto"
    debug_invariants: bool = False
    # paged admission policy: "reserve" admits only when the pool covers
    # the request's worst case (no preemption ever); "optimistic" admits
    # on the prompt's pages and preempts the youngest request by
    # recompute when the pool runs dry, at most max_preemptions times a
    # request
    admission: str = "reserve"
    max_preemptions: int = 3
    kv_dtype: str = "fp32"  # "fp32" | "int8" (paged layout only)
    # hashed prefix-page cache (paged layout): admissions map registered
    # full pages matching a prefix of their sequence, copy-on-write at
    # the first divergent write
    prefix_cache: bool = False
    # "lru": a published page whose last holder leaves stays matchable
    # until the pool needs it back (least recently released first)
    prefix_evict: str = "none"
    kv_swap: bool = False
    spec_draft: str = ""  # "" (off) | "ngram" | "model"
    spec_k: int = 4
    spec_branch: int = 1
    spec_ngram: int = 2
    # chunked prefill (Sarathi-Serve): token_budget > 0 caps each
    # iteration's token work, prompts streaming in as chunk_size-aligned
    # chunks beside the in-flight decodes
    token_budget: int = 0
    chunk_size: int = 16
    # the double-buffered loop: each step's reconcile runs an iteration
    # after its dispatch, the host's next dispatch overlapping its device
    # work (continuous scheduler only)
    serve_async: bool = False
    # device-resident multi-step decode: runs of decode iterations that no
    # host-visible event interrupts fuse into one window of up to
    # max_fused_steps steps (on the card, replays of a captured CUDA
    # graph), read by the host once; token- and logit-identical to
    # stepping one at a time
    decode_multistep: bool = False
    max_fused_steps: int = 8
    # multi-tenant serving (serving/tenancy/): adapters > 0 attaches a
    # paged multi-LoRA AdapterPool for that many resident adapters of
    # rank <= adapter_rank (requests pick one by Request.adapter_id, -1 =
    # the base model); classes, "name:weight[:ttft_ms[:itl_ms]]" entries
    # comma-separated: more than one class makes admission and chunk
    # grants weighted-fair (deficit round-robin) and preemption victims
    # class-priced
    adapters: int = 0
    adapter_rank: int = 8
    classes: str = ""

    def __post_init__(self):
        if self.prefix_evict not in ("none", "lru", "cost"):
            raise ValueError(f"prefix_evict must be 'none', 'lru', or 'cost', got {self.prefix_evict!r}")
        for name, (taken, item) in _NOT_PORTED.items():
            if getattr(self, name) not in taken:
                raise NotImplementedError(
                    f"ServeConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet (ROADMAP, {item}); this port takes {' or '.join(map(repr, taken))}"
                )
        if self.scheduler not in _SCHEDULERS:
            raise ValueError(
                f"scheduler must be one of {sorted(_SCHEDULERS)}, got {self.scheduler!r}"
            )
        if self.max_seqs < 1 or self.max_seq_len < 2:
            raise ValueError("max_seqs >= 1 and max_seq_len >= 2 required")
        if self.serve_async and self.scheduler != "continuous":
            raise ValueError(
                "serve_async requires the continuous scheduler (the static "
                "baseline is deliberately synchronous)"
            )
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or 'optimistic', got {self.admission!r}")
        if self.max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0")
        if self.kv_layout not in ("paged", "slot"):
            raise ValueError(f"kv_layout must be 'paged' or 'slot', got {self.kv_layout!r}")
        if self.kv_page_size < 0 or self.kv_pages < 0:
            raise ValueError("kv_page_size and kv_pages must be >= 0")
        if self.kv_page_size and self.max_seq_len % self.kv_page_size:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} is not divisible by "
                f"kv_page_size {self.kv_page_size}"
            )
        if self.kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype must be 'fp32' or 'int8', got {self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError(
                "kv_dtype='int8' requires kv_layout='paged' (the scale side "
                "pools are per page)"
            )
        if self.prefix_cache and self.kv_layout != "paged":
            raise ValueError(
                "prefix_cache requires kv_layout='paged' (sharing is "
                "page-aligned: whole pages map through block tables)"
            )
        if self.prefix_evict != "none" and not self.prefix_cache:
            raise ValueError(
                "prefix_evict needs prefix_cache=True (only published "
                "prefix pages are ever evictable)"
            )
        if self.token_budget < 0 or self.chunk_size < 1:
            raise ValueError(
                "token_budget must be >= 0 and chunk_size >= 1, got "
                f"token_budget={self.token_budget} chunk_size={self.chunk_size}"
            )
        if self.token_budget:
            if self.scheduler != "continuous":
                raise ValueError("token_budget (chunked prefill) requires the continuous scheduler")
            if self.token_budget < self.chunk_size:
                raise ValueError(
                    f"token_budget {self.token_budget} < chunk_size {self.chunk_size}: "
                    "an iteration could never fit one chunk"
                )
            if self.chunk_size % CHUNK_ALIGN:
                raise ValueError(
                    f"chunk_size {self.chunk_size} must be a multiple of {CHUNK_ALIGN} "
                    f"when decode_kernel is {self.decode_kernel!r}"
                )
        if self.spec_draft not in ("", "ngram", "model"):
            raise ValueError(f"spec_draft must be '', 'ngram' or 'model', got {self.spec_draft!r}")
        if self.spec_k < 1 or self.spec_branch < 1 or self.spec_ngram < 1:
            raise ValueError("spec_k, spec_branch and spec_ngram must be >= 1")
        if self.spec_draft:
            w = 1 + self.spec_k * self.spec_branch
            if w > MAX_W:
                raise ValueError(
                    f"a verify of 1 + spec_k * spec_branch = {w} rows exceeds "
                    f"the decode kernels' {MAX_W}"
                )
        check_mode(self.decode_kernel)
        if self.max_fused_steps < 1:
            raise ValueError(f"max_fused_steps must be >= 1, got {self.max_fused_steps}")
        if self.decode_multistep and self.scheduler == "static":
            raise ValueError(
                "decode_multistep requires the continuous scheduler (the "
                "static baseline is the reference the fused loop is proved "
                "identical against)"
            )
        if self.adapters < 0:
            raise ValueError(f"adapters must be >= 0 (0 = no pool), got {self.adapters}")
        if self.adapters and self.adapter_rank < 1:
            raise ValueError(f"adapter_rank must be >= 1, got {self.adapter_rank}")
        if self.classes:
            parse_classes(self.classes)  # raises on malformed text

    @staticmethod
    def from_config(cfg) -> "ServeConfig":
        """Lift the serve_* fields of an FFConfig."""
        return ServeConfig(
            max_seqs=cfg.serve_max_seqs,
            max_seq_len=cfg.serve_max_seq_len,
            scheduler=cfg.serve_scheduler,
            eos_token=cfg.serve_eos_token if cfg.serve_eos_token >= 0 else None,
            kv_layout=cfg.serve_kv_layout,
            kv_page_size=cfg.serve_kv_page_size,
            kv_pages=cfg.serve_kv_pages,
            kv_dtype=cfg.serve_kv_dtype,
            seed=cfg.seed,
            spec_draft=cfg.serve_spec_draft,
            spec_k=cfg.serve_spec_k,
            spec_branch=cfg.serve_spec_branch,
            decode_kernel=cfg.serve_decode_kernel,
            decode_multistep=cfg.serve_decode_multistep,
            max_fused_steps=cfg.serve_max_fused_steps,
            serve_async=cfg.serve_async,
            prefix_cache=cfg.serve_prefix_cache,
            prefix_evict=cfg.serve_prefix_evict,
            adapters=cfg.serve_adapters,
            adapter_rank=cfg.serve_adapter_rank,
            classes=cfg.serve_classes,
        )


def build_proposer(serve: ServeConfig, draft_model=None):
    """The DraftProposer a ServeConfig asks for (None when speculative
    decoding is off). A "model" draft needs a second compiled decoder LM
    sharing the target's vocabulary."""
    if not serve.spec_draft:
        return None
    if serve.spec_draft == "ngram":
        return NGramDraftProposer(n=serve.spec_ngram)
    if draft_model is None:
        raise ValueError(
            "spec_draft='model' needs a compiled draft_model (a small decoder LM with the target's vocabulary)"
        )
    return ModelDraftProposer(
        draft_model,
        max_seqs=serve.max_seqs,
        max_len=serve.max_seq_len,
        buckets=serve.prefill_buckets or None,
        decode_kernel=serve.decode_kernel,
    )


def build_scheduler(model, serve: ServeConfig, draft_model=None):
    """(scheduler, engine, cache) wired to a compiled model — the pieces
    generate() uses, exposed for callers that drive iterations
    themselves. A model compiled with allow_mixed_precision serves with
    bf16 activations and logits over the same fp32 or int8 pools.
    `draft_model` is the draft LM of spec_draft="model". With
    serve.adapters the engine carries an AdapterPool (`engine.adapters`,
    empty: load adapters into it before submitting requests that name
    them). Victims of a multiclass scheduler are priced by resident
    tokens: the reference's cost-model pricer waits for the cost model
    (ROADMAP, Port queue)."""
    if serve.kv_layout == "paged":
        cache = PagedKVCache.from_model(
            model,
            max_seqs=serve.max_seqs,
            max_len=serve.max_seq_len,
            buckets=serve.prefill_buckets or None,
            page_size=serve.kv_page_size,
            num_pages=serve.kv_pages,
            kv_dtype=serve.kv_dtype,
            prefix_cache=serve.prefix_cache,
            prefix_evict=serve.prefix_evict,
        )
    else:
        cache = KVCache.from_model(
            model,
            max_seqs=serve.max_seqs,
            max_len=serve.max_seq_len,
            buckets=serve.prefill_buckets or None,
        )
    adapters = None
    if serve.adapters:
        adapters = AdapterPool.from_model(
            model, max_seqs=serve.max_seqs, max_adapters=serve.adapters, max_rank=serve.adapter_rank
        )
    engine = GenerationEngine(
        model,
        cache,
        decode_kernel=serve.decode_kernel,
        max_fused_steps=serve.max_fused_steps,
        temperature=serve.temperature,
        seed=serve.seed,
        adapters=adapters,
    )
    # __post_init__ holds serve_async to the continuous scheduler
    cls = AsyncContinuousBatchingScheduler if serve.serve_async else _SCHEDULERS[serve.scheduler]
    sched = cls(
        engine,
        proposer=build_proposer(serve, draft_model),
        spec_k=serve.spec_k,
        spec_branch=serve.spec_branch,
        admission=serve.admission,
        max_preemptions=serve.max_preemptions,
        debug_invariants=serve.debug_invariants,
        token_budget=serve.token_budget,
        chunk_size=serve.chunk_size,
        decode_multistep=serve.decode_multistep,
        max_fused_steps=serve.max_fused_steps,
        classes=parse_classes(serve.classes) if serve.classes else None,
    )
    return sched, engine, cache


def generate(
    model,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int = 16,
    serve: Optional[ServeConfig] = None,
    eos_token: Optional[int] = None,
    draft_model=None,
) -> List[List[int]]:
    """Generate continuations for token-id prompts; returns the
    generated tokens (prompt excluded) in the prompts' order. An invalid
    request becomes a FAILED entry with an empty continuation instead of
    an exception that loses the whole batch. `draft_model` is the draft
    LM of spec_draft="model"."""
    serve = serve or ServeConfig()
    if eos_token is None:
        eos_token = serve.eos_token
    sched, _, _ = build_scheduler(model, serve, draft_model=draft_model)
    reqs = [
        Request(
            rid=i,
            prompt=list(map(int, p)),
            max_new_tokens=max_new_tokens,
            eos_token=eos_token,
        )
        for i, p in enumerate(prompts)
    ]
    for r in reqs:
        sched.submit(r, strict=False)
    done = sched.run()
    by_rid = {r.rid: r for r in done}
    return [by_rid[i].generated for i in range(len(reqs))]
