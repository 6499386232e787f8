"""Machine views (port of the MachineView part of
flexflow_tpu/core/machine.py, the one piece core/pcg.py refers to).

A MachineView is the reference's strided grid of device ids
{start_device_id, dims, strides}; a PCG node may carry one as its
placement. The single-device compile() of this slice places every node
on one torch.device and leaves the views unset. Machine resources,
hardware specs and view enumeration arrive with the search (ROADMAP,
Port queue: search).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class MachineView:
    """A strided grid of device ids: the device of grid point p is
    start_device_id + sum_i p[i] * strides[i]."""

    start_device_id: int
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.strides):
            raise ValueError("dims and strides must have equal length")
        if any(d <= 0 for d in self.dims):
            raise ValueError("view dims must be positive")

    @property
    def num_devices(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def device_ids(self) -> List[int]:
        return [
            self.start_device_id + sum(p * s for p, s in zip(point, self.strides))
            for point in itertools.product(*(range(d) for d in self.dims))
        ]

    def hash(self) -> int:
        """Stable content hash, equal to the reference's for the same view."""
        h = 17
        h = h * 31 + self.start_device_id
        for d, s in zip(self.dims, self.strides):
            h = h * 31 + d
            h = h * 31 + s
        return h & 0x7FFFFFFFFFFFFFFF

    @staticmethod
    def dp_view(num_devices: int) -> "MachineView":
        """1-D view over all devices."""
        return MachineView(0, (num_devices,), (1,))
