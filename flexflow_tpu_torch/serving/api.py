"""User-facing serving surface: ServeConfig, build_proposer,
build_scheduler and generate() (port of the single-device part of
flexflow_tpu/serving/api.py). `FFModel.generate` delegates here.
Speculative decoding (`spec_draft="ngram"`, linear or token-tree by
`spec_branch`) and int8 paged KV pools (`kv_dtype="int8"`) run through
the CUDA kernels #4-#9 on the card; `decode_multistep=True` fuses runs
of decode steps into CUDA-graph windows there."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from flexflow_tpu_torch.ops.attention import check_mode
from flexflow_tpu_torch.ops.cuda.decode_kernel import MAX_W
from flexflow_tpu_torch.serving.engine import GenerationEngine
from flexflow_tpu_torch.serving.kv_cache import KVCache, PagedKVCache
from flexflow_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    StaticBatchingScheduler,
)
from flexflow_tpu_torch.serving.spec import NGramDraftProposer

_SCHEDULERS = {
    "continuous": ContinuousBatchingScheduler,
    "static": StaticBatchingScheduler,
}

# options of the reference's ServeConfig this port does not take yet:
# field -> (the only value accepted, the ROADMAP item that brings the rest)
_NOT_PORTED = {
    "temperature": (0.0, "Port queue: sampling"),
    "admission": ("reserve", "Port queue: preemption and swap"),
    "prefix_cache": (False, "Port queue: prefix cache"),
    "token_budget": (0, "Port queue: chunked prefill"),
    "serve_async": (False, "Port queue: async engine"),
}


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs: the reference's defaults — paged KV layout with
    16-token pages, the continuous scheduler, greedy decoding, an fp32
    cache and no speculation. kv_dtype "int8" stores the paged pools as
    int8 with an fp32 scale per (page, head). spec_draft "ngram" turns
    on speculative decoding with prompt-lookup drafts of spec_k tokens
    (n-gram size spec_ngram); spec_branch > 1 verifies a token tree of
    up to spec_k * spec_branch nodes instead of one chain."""

    max_seqs: int = 8  # KV-cache slots = max in-flight requests
    max_seq_len: int = 256  # max tokens per sequence (prompt + generation)
    scheduler: str = "continuous"  # "continuous" | "static"
    eos_token: Optional[int] = None
    prefill_buckets: Tuple[int, ...] = ()  # () = powers of two
    kv_layout: str = "paged"  # "paged" | "slot"
    kv_page_size: int = 0  # 0 = auto (16, halved to divide max_len)
    kv_pages: int = 0  # 0 = max_seqs * max_seq_len / page_size
    decode_kernel: str = "auto"
    debug_invariants: bool = False
    temperature: float = 0.0
    admission: str = "reserve"
    kv_dtype: str = "fp32"  # "fp32" | "int8" (paged layout only)
    prefix_cache: bool = False
    spec_draft: str = ""  # "" (off) | "ngram"
    spec_k: int = 4
    spec_branch: int = 1
    spec_ngram: int = 2
    token_budget: int = 0
    serve_async: bool = False
    # device-resident multi-step decode: runs of decode iterations that no
    # host-visible event interrupts fuse into one window of up to
    # max_fused_steps steps (on the card, replays of a captured CUDA
    # graph), read by the host once; token- and logit-identical to
    # stepping one at a time
    decode_multistep: bool = False
    max_fused_steps: int = 8

    def __post_init__(self):
        for name, (only, item) in _NOT_PORTED.items():
            if getattr(self, name) != only:
                raise NotImplementedError(
                    f"ServeConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet (ROADMAP, {item}); this port takes {only!r}"
                )
        if self.scheduler not in _SCHEDULERS:
            raise ValueError(
                f"scheduler must be one of {sorted(_SCHEDULERS)}, got {self.scheduler!r}"
            )
        if self.max_seqs < 1 or self.max_seq_len < 2:
            raise ValueError("max_seqs >= 1 and max_seq_len >= 2 required")
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
        if self.spec_draft == "model":
            raise NotImplementedError(
                "ServeConfig.spec_draft='model' is not ported yet (ROADMAP, "
                "Port queue: the small-model draft); this port takes '' or 'ngram'"
            )
        if self.spec_draft not in ("", "ngram"):
            raise ValueError(f"spec_draft must be '' or 'ngram', got {self.spec_draft!r}")
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
            spec_draft=cfg.serve_spec_draft,
            spec_k=cfg.serve_spec_k,
            spec_branch=cfg.serve_spec_branch,
            decode_kernel=cfg.serve_decode_kernel,
            decode_multistep=cfg.serve_decode_multistep,
            max_fused_steps=cfg.serve_max_fused_steps,
        )


def build_proposer(serve: ServeConfig):
    """The DraftProposer a ServeConfig asks for (None when speculative
    decoding is off)."""
    if not serve.spec_draft:
        return None
    return NGramDraftProposer(n=serve.spec_ngram)


def build_scheduler(model, serve: ServeConfig):
    """(scheduler, engine, cache) wired to a compiled model — the pieces
    generate() uses, exposed for callers that drive iterations
    themselves. A model compiled with allow_mixed_precision serves with
    bf16 activations and logits over the same fp32 or int8 pools."""
    if serve.kv_layout == "paged":
        cache = PagedKVCache.from_model(
            model,
            max_seqs=serve.max_seqs,
            max_len=serve.max_seq_len,
            buckets=serve.prefill_buckets or None,
            page_size=serve.kv_page_size,
            num_pages=serve.kv_pages,
            kv_dtype=serve.kv_dtype,
        )
    else:
        cache = KVCache.from_model(
            model,
            max_seqs=serve.max_seqs,
            max_len=serve.max_seq_len,
            buckets=serve.prefill_buckets or None,
        )
    engine = GenerationEngine(
        model, cache, decode_kernel=serve.decode_kernel, max_fused_steps=serve.max_fused_steps
    )
    sched = _SCHEDULERS[serve.scheduler](
        engine,
        proposer=build_proposer(serve),
        spec_k=serve.spec_k,
        spec_branch=serve.spec_branch,
        debug_invariants=serve.debug_invariants,
        decode_multistep=serve.decode_multistep,
        max_fused_steps=serve.max_fused_steps,
    )
    return sched, engine, cache


def generate(
    model,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int = 16,
    serve: Optional[ServeConfig] = None,
    eos_token: Optional[int] = None,
) -> List[List[int]]:
    """Generate greedy continuations for token-id prompts; returns the
    generated tokens (prompt excluded) in the prompts' order. An invalid
    request becomes a FAILED entry with an empty continuation instead of
    an exception that loses the whole batch."""
    serve = serve or ServeConfig()
    if eos_token is None:
        eos_token = serve.eos_token
    sched, _, _ = build_scheduler(model, serve)
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
