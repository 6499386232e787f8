"""Core enums for flexflow_tpu_torch (port of flexflow_tpu/core/types.py).

The vocabulary (operator types, activation modes, data types, losses, metrics,
computation modes) is the reference's, so a PCG built by either package
names the same ops; the jnp dtype maps become torch.dtype maps.
"""

from __future__ import annotations

import enum

import torch


class DataType(enum.Enum):
    """Tensor element types (reference: ffconst.h DataType)."""

    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    def to_torch(self) -> torch.dtype:
        return _TO_TORCH[self]

    @staticmethod
    def from_torch(dt: torch.dtype) -> "DataType":
        return _FROM_TORCH[dt]


_TO_TORCH = {
    DataType.BOOL: torch.bool,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.HALF: torch.float16,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}


class OperatorType(enum.Enum):
    """Operator vocabulary (reference: ffconst.h:62-154 OperatorType).
    Members and order match flexflow_tpu.core.types.OperatorType, so
    `op_type.name` is the key the weight carry-over compares."""

    NOOP = enum.auto()
    INPUT = enum.auto()
    WEIGHT = enum.auto()
    LINEAR = enum.auto()
    CONV2D = enum.auto()
    POOL2D_MAX = enum.auto()
    POOL2D_AVG = enum.auto()
    BATCHNORM = enum.auto()
    LAYERNORM = enum.auto()
    EMBEDDING = enum.auto()
    DROPOUT = enum.auto()
    MULTIHEAD_ATTENTION = enum.auto()
    RELU = enum.auto()
    SIGMOID = enum.auto()
    TANH = enum.auto()
    ELU = enum.auto()
    GELU = enum.auto()
    IDENTITY = enum.auto()
    EXP = enum.auto()
    SIN = enum.auto()
    COS = enum.auto()
    POW = enum.auto()
    RSQRT = enum.auto()
    SCALAR_MULTIPLY = enum.auto()
    SCALAR_ADD = enum.auto()
    SCALAR_SUB = enum.auto()
    SCALAR_TRUE_DIV = enum.auto()
    EW_ADD = enum.auto()
    EW_SUB = enum.auto()
    EW_MUL = enum.auto()
    EW_DIV = enum.auto()
    EW_MAX = enum.auto()
    EW_MIN = enum.auto()
    BATCHMATMUL = enum.auto()
    REDUCE_SUM = enum.auto()
    MEAN = enum.auto()
    SOFTMAX = enum.auto()
    CONCAT = enum.auto()
    SPLIT = enum.auto()
    RESHAPE = enum.auto()
    TRANSPOSE = enum.auto()
    REVERSE = enum.auto()
    FLAT = enum.auto()
    CAST = enum.auto()
    TOPK = enum.auto()
    GROUP_BY = enum.auto()
    AGGREGATE = enum.auto()
    AGGREGATE_SPEC = enum.auto()
    EXPERT_FFN = enum.auto()
    CACHE = enum.auto()
    GATHER = enum.auto()
    FUSED = enum.auto()
    REPARTITION = enum.auto()
    COMBINE = enum.auto()
    REPLICATE = enum.auto()
    REDUCTION = enum.auto()
    FUSED_PARALLEL = enum.auto()
    PIPELINE = enum.auto()
    ALLTOALL = enum.auto()


class ActiMode(enum.Enum):
    """Fused-activation modes (reference: ffconst.h ActiMode)."""

    NONE = enum.auto()
    RELU = enum.auto()
    SIGMOID = enum.auto()
    TANH = enum.auto()
    GELU = enum.auto()


class AggrMode(enum.Enum):
    """Embedding aggregation (reference: ffconst.h AggrMode)."""

    NONE = enum.auto()
    SUM = enum.auto()
    AVG = enum.auto()


class LossType(enum.Enum):
    """reference: ffconst.h LossType"""

    CATEGORICAL_CROSSENTROPY = enum.auto()
    SPARSE_CATEGORICAL_CROSSENTROPY = enum.auto()
    MEAN_SQUARED_ERROR_AVG_REDUCE = enum.auto()
    MEAN_SQUARED_ERROR_SUM_REDUCE = enum.auto()
    IDENTITY = enum.auto()


class MetricsType(enum.Enum):
    """reference: metrics_functions.h:12-45"""

    ACCURACY = enum.auto()
    CATEGORICAL_CROSSENTROPY = enum.auto()
    SPARSE_CATEGORICAL_CROSSENTROPY = enum.auto()
    MEAN_SQUARED_ERROR = enum.auto()
    ROOT_MEAN_SQUARED_ERROR = enum.auto()
    MEAN_ABSOLUTE_ERROR = enum.auto()


class CompMode(enum.Enum):
    """reference: ffconst.h CompMode {COMP_MODE_TRAINING, COMP_MODE_INFERENCE}"""

    TRAINING = enum.auto()
    INFERENCE = enum.auto()
