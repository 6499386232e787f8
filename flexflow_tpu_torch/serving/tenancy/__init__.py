"""Multi-tenant serving (port of flexflow_tpu/serving/tenancy/): paged
multi-LoRA adapters and weighted-fair priority scheduling.

- :mod:`adapters` — a paged ``AdapterPool`` (the PagedKVCache's sibling
  allocator) holding rank-r LoRA deltas of the attention projections,
  gathered per batch row into the engine's projections.
- :mod:`fairness` — ``PriorityClass`` and the deficit round-robin that
  makes admission and the chunk planner's grants weighted-fair across
  classes.

The reference's per-class SLO monitors (its :mod:`slo`) need the
telemetry registry, which is not ported yet (ROADMAP, Port queue:
telemetry); the classes keep their SLO targets.
"""

from flexflow_tpu_torch.serving.tenancy.adapters import (  # noqa: F401
    AdapterPool,
    AdapterPoolExhausted,
    AdapterPoolSpec,
    adapter_rows,
    apply_adapter_out,
    apply_adapter_qkv,
    make_lora_weights,
)
from flexflow_tpu_torch.serving.tenancy.fairness import (  # noqa: F401
    DeficitRoundRobin,
    PriorityClass,
    parse_classes,
)
