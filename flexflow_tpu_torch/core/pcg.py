"""Parallel Computation Graph (port of flexflow_tpu/core/pcg.py).

Nodes are operators, edges are implicit in each node's `inputs`. Guids
start at 100 and are handed out in build order, exactly as in the
reference package: the same builder calls give the same guids in both,
which is what lets weights cross between them keyed by guid
(runtime/interop.py). The search and substitution helpers are not part
of this slice.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.core.types import OperatorType


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """A reference to output `out_idx` of node `guid`."""

    guid: int
    out_idx: int = 0


@dataclasses.dataclass
class PCGNode:
    """One operator node: static params, output shapes, the shapes of
    its weights (reference: Op::weights) and its placement, unset on one
    device."""

    guid: int
    op_type: OperatorType
    name: str
    inputs: Tuple[TensorRef, ...]
    params: Dict[str, object]
    output_shapes: Tuple[ParallelTensorShape, ...]
    weight_shapes: Tuple[ParallelTensorShape, ...] = ()
    machine_view: Optional[MachineView] = None


class PCGGraph:
    """Mutable DAG of PCGNodes with consumer maps for reverse traversal."""

    def __init__(self):
        self.nodes: Dict[int, PCGNode] = {}
        self._next_guid = 100  # reference starts op guids at a magic base
        self._consumers: Dict[int, Set[int]] = defaultdict(set)

    def fresh_guid(self) -> int:
        g = self._next_guid
        self._next_guid += 1
        return g

    def add_node(
        self,
        op_type: OperatorType,
        name: str,
        inputs: Sequence[TensorRef],
        params: Dict[str, object],
        output_shapes: Sequence[ParallelTensorShape],
        weight_shapes: Sequence[ParallelTensorShape] = (),
    ) -> PCGNode:
        node = PCGNode(
            guid=self.fresh_guid(),
            op_type=op_type,
            name=name,
            inputs=tuple(inputs),
            params=dict(params),
            output_shapes=tuple(output_shapes),
            weight_shapes=tuple(weight_shapes),
        )
        self.nodes[node.guid] = node
        for ref in node.inputs:
            self._consumers[ref.guid].add(node.guid)
        return node

    def producers(self, guid: int) -> List[int]:
        return [r.guid for r in self.nodes[guid].inputs]

    def sinks(self) -> List[int]:
        return [g for g in self.nodes if not self._consumers.get(g)]

    def shape_of(self, ref: TensorRef) -> ParallelTensorShape:
        return self.nodes[ref.guid].output_shapes[ref.out_idx]

    def topo_order(self) -> List[int]:
        """Kahn topological sort, deterministic (ready set sorted by
        guid) so the executor's program order matches the reference's
        (reference: dominators.h:156)."""
        indeg = {g: len(set(self.producers(g))) for g in self.nodes}
        ready = sorted(g for g, d in indeg.items() if d == 0)
        order = []
        while ready:
            g = ready.pop(0)
            order.append(g)
            for c in sorted(self._consumers.get(g, ())):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
            ready.sort()
        if len(order) != len(self.nodes):
            raise ValueError("PCG has a cycle")
        return order
