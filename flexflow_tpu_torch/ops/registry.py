"""Operator registry (port of flexflow_tpu/ops/registry.py).

Each OperatorType registers `infer` (input shapes, params) -> (output
shapes, weight shapes) and `lower` params -> fn(inputs, weights, ctx) ->
outputs, a plain function over torch tensors. There is no device mesh in
this slice: the lowered functions run on whatever device their inputs
live on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.core.types import OperatorType


@dataclasses.dataclass(frozen=True)
class LowerCtx:
    """Execution context threaded through lowered ops. The serving slice
    always runs with train=False; the mesh and rng fields of the
    reference arrive with training and parallel strategies."""

    train: bool = False


@dataclasses.dataclass
class OpDef:
    op_type: OperatorType
    infer: Callable[
        [Sequence[ParallelTensorShape], dict],
        Tuple[Tuple[ParallelTensorShape, ...], Tuple[ParallelTensorShape, ...]],
    ]
    lower: Callable[[dict], Callable]


_REGISTRY: Dict[OperatorType, OpDef] = {}


def register_op(op_type: OperatorType, infer, lower):
    _REGISTRY[op_type] = OpDef(op_type, infer, lower)


def get_op_def(op_type: OperatorType) -> OpDef:
    if op_type not in _REGISTRY:
        raise NotImplementedError(
            f"{op_type.name} is not ported yet (ROADMAP, Port queue: "
            "training op breadth)"
        )
    return _REGISTRY[op_type]


def infer_shapes(op_type, input_shapes, params):
    return get_op_def(op_type).infer(input_shapes, params)


def lower_op(op_type, params) -> Callable:
    return get_op_def(op_type).lower(params)


def _ensure_registered():
    """Import op implementation modules for their registration side effects."""
    from flexflow_tpu_torch.ops import attention  # noqa: F401
    from flexflow_tpu_torch.ops import core_ops  # noqa: F401
