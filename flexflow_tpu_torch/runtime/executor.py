"""PCG executor on one device (port of the forward half of
flexflow_tpu/runtime/executor.py).

The reference lowers the annotated PCG to one jitted step over a device
mesh. Here the graph runs eagerly on one `torch.device`: each node's
registered lowering is a plain function over tensors, evaluated in topo
order. Parameters are `{guid: [tensor, ...]}`, the reference's layout,
so weights cross between the two packages by guid. The train step, the
mesh and sharding are not ported yet (ROADMAP, Port queue: slice 2,
training).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.core.pcg import PCGGraph, TensorRef
from flexflow_tpu_torch.core.types import OperatorType
from flexflow_tpu_torch.ops.registry import LowerCtx, lower_op
from flexflow_tpu_torch.runtime.initializer import default_weight_initializer


def weight_seed(seed: int, guid: int, idx: int) -> int:
    """Per-weight generator seed: a weight's values depend only on
    (seed, guid, index), not on the order weights are created in (the
    reference folds guid * 131 + i into its key the same way)."""
    return (seed * 1_000_003 + guid * 131 + idx) % (2**63 - 1)


class Executor:
    """Evaluates a PCG on one device."""

    def __init__(self, graph: PCGGraph, logits_ref: TensorRef, device: torch.device):
        self.graph = graph
        self.logits_ref = logits_ref
        self.device = torch.device(device)
        self.topo = graph.topo_order()
        self._lowered = {
            g: lower_op(graph.nodes[g].op_type, graph.nodes[g].params)
            for g in self.topo
        }

    def init_params(self, seed: int) -> Dict[int, List[torch.Tensor]]:
        """Fresh weights on the executor's device, each from its own
        generator seeded by weight_seed."""
        params: Dict[int, List[torch.Tensor]] = {}
        gen = torch.Generator(device=self.device)
        for guid in self.topo:
            node = self.graph.nodes[guid]
            if not node.weight_shapes:
                continue
            inits = node.params.get("initializers")
            ws = []
            for i, wshape in enumerate(node.weight_shapes):
                init = (
                    inits[i]
                    if inits is not None and inits[i] is not None
                    else default_weight_initializer(wshape)
                )
                gen.manual_seed(weight_seed(seed, guid, i))
                ws.append(init.create(gen, wshape, self.device))
            params[guid] = ws
        return params

    def export_host_params(self, params) -> Dict[int, List[np.ndarray]]:
        """Params in the reference's per-guid host layout (numpy copies)."""
        return {
            g: [w.detach().cpu().numpy().copy() for w in ws]
            for g, ws in params.items()
        }

    def forward_values(
        self,
        params,
        batch,
        train: bool = False,
        op_hooks=None,
    ) -> Dict[Tuple[int, int], torch.Tensor]:
        """Evaluate the PCG; returns {(guid, out_idx): tensor}.

        op_hooks: {OperatorType: fn(node, ins, ws, ctx) -> [outs]} —
        per-op-type overrides of the registered lowering. The serving
        engine swaps the attention core for the KV-cache paths this way
        and everything else runs the normal lowering."""
        if train:
            raise NotImplementedError(
                "training forward is not ported yet (ROADMAP, Port queue: "
                "slice 2, training)"
            )
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        ctx = LowerCtx(train=False)
        for guid in self.topo:
            node = self.graph.nodes[guid]
            if node.op_type == OperatorType.INPUT and not node.inputs:
                if node.name not in batch:
                    raise KeyError(f"batch missing input '{node.name}'")
                values[(guid, 0)] = torch.as_tensor(batch[node.name], device=self.device)
                continue
            ins = [values[(r.guid, r.out_idx)] for r in node.inputs]
            ws = params.get(guid, [])
            hook = op_hooks.get(node.op_type) if op_hooks else None
            outs = hook(node, ins, ws, ctx) if hook is not None else self._lowered[guid](ins, ws, ctx)
            for i, out in enumerate(outs):
                values[(guid, i)] = out
        return values

    def logits(self, params, batch, op_hooks=None) -> torch.Tensor:
        values = self.forward_values(params, batch, op_hooks=op_hooks)
        return values[(self.logits_ref.guid, self.logits_ref.out_idx)]

    def input_nodes(self) -> List[int]:
        return [
            g
            for g in self.topo
            if self.graph.nodes[g].op_type == OperatorType.INPUT
            and not self.graph.nodes[g].inputs
        ]

