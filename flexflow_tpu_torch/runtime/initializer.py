"""Weight initializers (port of flexflow_tpu/runtime/initializer.py).

Each initializer fills one weight from a `torch.Generator` on the target
device. The rules are the reference's (Glorot-uniform for rank >= 2,
zeros for vectors, explicit constants for scales); the numbers are not,
since torch and JAX draw different streams from one seed. Weights that
must agree with the JAX package are carried across instead
(runtime/interop.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape


@dataclasses.dataclass(frozen=True)
class Initializer:
    def create(self, gen: torch.Generator, shape: ParallelTensorShape, device):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GlorotUniform(Initializer):
    """Limit sqrt(6 / (fan_in + fan_out)), fans as in the reference."""

    def create(self, gen, shape, device):
        sizes = shape.logical_sizes
        if len(sizes) >= 2:
            fan_in = math.prod(sizes[:-1])
            fan_out = sizes[-1]
        else:
            fan_in = fan_out = sizes[0]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out = torch.empty(sizes, dtype=shape.dtype.to_torch(), device=device)
        return out.uniform_(-limit, limit, generator=gen)


@dataclasses.dataclass(frozen=True)
class ZeroInitializer(Initializer):
    def create(self, gen, shape, device):
        return torch.zeros(shape.logical_sizes, dtype=shape.dtype.to_torch(), device=device)


@dataclasses.dataclass(frozen=True)
class ConstantInitializer(Initializer):
    value: float = 0.0

    def create(self, gen, shape, device):
        return torch.full(
            shape.logical_sizes, self.value, dtype=shape.dtype.to_torch(), device=device
        )


def default_weight_initializer(shape: ParallelTensorShape) -> Initializer:
    """Rank >= 2 weights get Glorot, vectors zeros (the reference's
    per-op defaults); scales are requested as ConstantInitializer(1.0)
    by the builder."""
    return GlorotUniform() if len(shape.logical_sizes) >= 2 else ZeroInitializer()
