"""Parallel tensor shape model (port of flexflow_tpu/core/parallel_tensor.py).

`ParallelDim {size, degree, parallel_idx, is_replica_dim}` as in the
reference (include/flexflow/parallel_tensor.h:36-70). This slice runs on
one device, so every degree is 1; the annotations are kept so a node's
shapes read the same in both packages and the weight carry-over can
compare them. Lowering to a device mesh is not part of the slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from flexflow_tpu_torch.core.types import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One tensor dimension with its parallel annotation."""

    size: int
    degree: int = 1
    parallel_idx: int = -1
    is_replica_dim: bool = False

    def __post_init__(self):
        if self.size <= 0:
            raise ValueError(f"dim size must be positive, got {self.size}")
        if self.degree < 1:
            raise ValueError(f"degree must be >= 1, got {self.degree}")
        if self.size % self.degree != 0:
            raise ValueError(
                f"degree {self.degree} does not divide size {self.size}"
            )
        if self.is_replica_dim and self.size != self.degree:
            raise ValueError("replica dim must have size == degree")


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    """Shape + dtype + per-dim parallel annotations."""

    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.FLOAT

    @staticmethod
    def make(sizes: Sequence[int], dtype: DataType = DataType.FLOAT) -> "ParallelTensorShape":
        """An unpartitioned shape."""
        return ParallelTensorShape(tuple(ParallelDim(s) for s in sizes), dtype)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def logical_sizes(self) -> Tuple[int, ...]:
        """Global sizes with replica dims dropped — the tensor's shape."""
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    def __str__(self):
        parts = []
        for d in self.dims:
            tag = "r" if d.is_replica_dim else ""
            if d.degree > 1:
                parts.append(f"{d.size}/{d.degree}@{d.parallel_idx}{tag}")
            else:
                parts.append(f"{d.size}{tag}")
        return f"[{', '.join(parts)}]:{self.dtype.value}"
