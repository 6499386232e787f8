"""flexflow_tpu_torch: the PyTorch + CUDA port of flexflow_tpu.

Each module mirrors the path of its reference in `flexflow_tpu/` and
imports torch, never jax, and nothing of the JAX package. Two slices are
in: serving a decoder LM (the builder and PCG, single-device compile(),
the executor, the KV caches, the engine and the continuous-batching
scheduler, with the decode attention in hand-written CUDA kernels) and
training on one device (losses, metrics, SGD and Adam, the data loader,
the executor's autograd train step and fit(), with attention forward and
backward in hand-written CUDA flash kernels). Kernels are CUDA C++ for
Hopper (ops/cuda/, csrc/). Entry points run on CUDA unless the caller
passes device="cpu".
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
)
from flexflow_tpu_torch.runtime.model import FFModel, Tensor
from flexflow_tpu_torch.runtime.optimizer import AdamOptimizer, SGDOptimizer

__all__ = [
    "ActiMode",
    "AdamOptimizer",
    "AggrMode",
    "CompMode",
    "DataType",
    "FFConfig",
    "FFModel",
    "LossType",
    "MetricsType",
    "OperatorType",
    "SGDOptimizer",
    "Tensor",
]
