"""Operator registry (port of flexflow_tpu/ops/registry.py).

Each OperatorType registers `infer` (input shapes, params) -> (output
shapes, weight shapes) and `lower` params -> fn(inputs, weights, ctx) ->
outputs, a plain function over torch tensors. There is no device mesh in
this slice: the lowered functions run on whatever device their inputs
live on.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.core.types import OperatorType


@dataclasses.dataclass(frozen=True)
class LowerCtx:
    """Execution context threaded through lowered ops: whether this is a
    training forward, and the seed of the node's own random generator
    (None when the caller passed no seed; the counterpart of the
    reference's per-node fold_in(rng, guid) key). The reference's mesh
    fields arrive with parallel strategies."""

    train: bool = False
    seed: Optional[int] = None
    device: Optional[torch.device] = None

    @functools.cached_property
    def rng(self) -> Optional[torch.Generator]:
        """The node's torch.Generator on `device`, made on first read so
        that a step whose lowerings draw no random numbers makes none."""
        if self.seed is None:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        return gen


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
