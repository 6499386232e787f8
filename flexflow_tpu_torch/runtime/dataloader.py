"""Data loading (port of the numpy path of flexflow_tpu/runtime/
dataloader.py; reference: python/flexflow_dataloader.{h,cc,cu}).

The dataset stays in host memory as numpy arrays; `next_batch` slices
one global batch and the executor moves it to the device. Batch order
and the `shuffle` permutation are the reference's (numpy RandomState
from the seed), so both packages see the same batches. The reference's
native threaded prefetch library is not used: it is a part of the JAX
package, which the port does not import.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SingleDataLoader:
    """Full-dataset-resident loader with sequential batches
    (reference: flexflow_dataloader.h:34-107)."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
    ):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"dataset arrays disagree on length: {sizes}")
        self.arrays = arrays
        self.num_samples = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(self.num_samples)
        self._pos = 0

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def reset(self):
        self._pos = 0
        if self.shuffle:
            self._rng.shuffle(self._order)

    def next_batch(self) -> Dict[str, np.ndarray]:
        remaining = self.num_samples - self._pos
        if remaining < self.batch_size and (self.drop_last or remaining == 0):
            self.reset()
        take = self.batch_size
        if not self.drop_last:
            take = min(take, self.num_samples - self._pos)
        idx = self._order[self._pos : self._pos + take]
        self._pos += take
        return {k: v[idx] for k, v in self.arrays.items()}

    def __iter__(self):
        self.reset()
        for _ in range(self.num_batches):
            yield self.next_batch()


def synthetic_dataset(
    input_specs: Dict[str, tuple],
    num_samples: int,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Random data matching {name: (shape_without_batch, np.dtype, high)}.
    Integer dtypes draw uniform ints in [0, high); floats draw N(0, 1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, (shape, dtype, high) in input_specs.items():
        full = (num_samples,) + tuple(shape)
        if np.issubdtype(np.dtype(dtype), np.integer):
            out[name] = rng.randint(0, max(1, int(high)), size=full).astype(dtype)
        else:
            out[name] = rng.randn(*full).astype(dtype)
    return out
