"""Runtime configuration (port of the FFConfig fields the serving path
reads, flexflow_tpu/config.py).

Field names and defaults are the reference package's, so a config built
for one reads the same in the other. Training, search and the serving
feature flags beyond this slice are not here yet (ROADMAP, Port queue).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    seed: int = 0
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
