"""flexflow_tpu_torch: the PyTorch + CUDA port of flexflow_tpu.

Each module mirrors the path of its reference in `flexflow_tpu/` and
imports torch, never jax, and nothing of the JAX package. This slice
serves a decoder LM: the builder and PCG, single-device compile(), the
executor, the KV caches, the engine and the continuous-batching
scheduler, with the decode attention in hand-written CUDA kernels for
Hopper (ops/cuda/, csrc/). Entry points run on CUDA unless the caller
passes device="cpu".
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import ActiMode, AggrMode, DataType, OperatorType
from flexflow_tpu_torch.runtime.model import FFModel, Tensor

__all__ = [
    "ActiMode",
    "AggrMode",
    "DataType",
    "FFConfig",
    "FFModel",
    "OperatorType",
    "Tensor",
]
