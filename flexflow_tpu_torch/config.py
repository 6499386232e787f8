"""Runtime configuration (port of the FFConfig fields the serving and
training paths read, flexflow_tpu/config.py).

Field names and defaults are the reference package's, so a config built
for one reads the same in the other. Search, strategies and the serving
feature flags beyond the ported slices are not here yet (ROADMAP, Port
queue).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FFConfig:
    # training (reference flags -e/-b/--lr/--wd); print_freq: metric
    # print cadence in iterations (0 = per epoch only)
    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    iterations: Optional[int] = None
    print_freq: int = 0
    # sparse embedding-table updates: the reference updates only the
    # touched rows of an embedding table fed straight from an input; the
    # port takes the dense update, which agrees with it only for a
    # stateless optimizer without weight decay (compile() checks)
    sparse_embedding_update: bool = True
    seed: int = 0
    # bf16 matmul operands with f32 accumulation and bf16 activations
    # between ops (f32 master weights, f32 layer-norm statistics and
    # loss); ported for training, with bf16 bodies of the flash kernels
    # #1-#3. Serving such a model raises (ROADMAP, Port queue: serving
    # under mixed precision)
    allow_mixed_precision: bool = False
    # serving (reference: FlexFlow Serve's RequestManager flags):
    # KV-cache slots, cache length per slot, scheduler kind, EOS token
    # (-1 = none); ServeConfig.from_config lifts these into the engine
    serve_max_seqs: int = 8
    serve_max_seq_len: int = 256
    serve_scheduler: str = "continuous"
    serve_eos_token: int = -1
    # paged KV cache geometry: layout "paged" | "slot", page size in
    # tokens (0 = auto) and pool pages (0 = max_seqs * max_seq_len /
    # page_size, the slot layout's capacity)
    serve_kv_layout: str = "paged"
    serve_kv_page_size: int = 0
    serve_kv_pages: int = 0
    serve_decode_kernel: str = "auto"
    # K/V pool element type, "fp32" | "int8" (int8 keeps fp32 scales per
    # page per head; paged layout only)
    serve_kv_dtype: str = "fp32"
    # speculative decoding: draft source ("" = off, "ngram" = prompt
    # lookup), draft length per verify, and branches per tree level
    # (> 1 verifies a deduped token tree of up to k * branch nodes)
    serve_spec_draft: str = ""
    serve_spec_k: int = 4
    serve_spec_branch: int = 1
    # device-resident multi-step decode: fuse runs of decode iterations
    # into one window of up to serve_max_fused_steps steps, read by the
    # host once (CUDA graphs on the card)
    serve_decode_multistep: bool = False
    serve_max_fused_steps: int = 8
    # the double-buffered async serving loop (continuous scheduler only)
    serve_async: bool = False
    # the hashed prefix-page cache (paged layout) and its eviction of
    # released published pages under pool pressure: "none" | "lru"
    serve_prefix_cache: bool = False
    serve_prefix_evict: str = "none"
    # multi-tenant serving: resident LoRA adapters (0 = no pool), their
    # largest rank, and the priority classes ("name:weight[:ttft_ms[:itl_ms]]",
    # comma-separated; "" = none)
    serve_adapters: int = 0
    serve_adapter_rank: int = 8
    serve_classes: str = ""
