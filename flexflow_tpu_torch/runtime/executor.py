"""PCG executor on one device (port of the single-device part of
flexflow_tpu/runtime/executor.py).

The reference lowers the annotated PCG to jitted step functions over a
device mesh. Here the graph runs eagerly on one `torch.device`: each
node's registered lowering is a plain function over tensors, evaluated
in topo order, and gradients come from torch.autograd over those
lowerings (the flash kernels enter through their autograd Function).
Parameters are `{guid: [tensor, ...]}`, the reference's layout, so
weights and optimizer state cross between the two packages by guid. The
mesh, sharding and the reference's touched-rows embedding update are
not ported yet (ROADMAP, Port queue).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.core.pcg import PCGGraph, TensorRef
from flexflow_tpu_torch.core.types import LossType, MetricsType, OperatorType
from flexflow_tpu_torch.ops.registry import LowerCtx, lower_op
from flexflow_tpu_torch.runtime.initializer import default_weight_initializer
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import compute_metrics

_SEED_MOD = 2**63 - 1


def weight_seed(seed: int, guid: int, idx: int) -> int:
    """Per-weight generator seed: a weight's values depend only on
    (seed, guid, index), not on the order weights are created in (the
    reference folds guid * 131 + i into its key the same way)."""
    return (seed * 1_000_003 + guid * 131 + idx) % _SEED_MOD


def node_seed(rng: int, guid: int) -> int:
    """Seed of node `guid`'s generator for a forward seeded `rng` (the
    counterpart of the reference's fold_in(rng, guid))."""
    return (rng * 1_000_003 + guid) % _SEED_MOD


class Executor:
    """Evaluates a PCG on one device and builds its step functions."""

    def __init__(
        self,
        graph: PCGGraph,
        logits_ref: TensorRef,
        device: torch.device,
        label_shape: Optional[ParallelTensorShape] = None,
        loss_type: Optional[LossType] = None,
        metrics: Sequence[MetricsType] = (),
        optimizer=None,
        logits_from_logits: bool = True,
        sparse_embedding_update: bool = False,
    ):
        self.graph = graph
        self.logits_ref = logits_ref
        self.device = torch.device(device)
        self.label_shape = label_shape
        self.loss_type = loss_type
        self.metric_types = tuple(metrics)
        self.optimizer = optimizer
        self.logits_from_logits = logits_from_logits
        self.sparse_embedding_update = sparse_embedding_update
        self.topo = graph.topo_order()
        self._lowered = {
            g: lower_op(graph.nodes[g].op_type, graph.nodes[g].params)
            for g in self.topo
        }

    # -- parameters ----------------------------------------------------------

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

    def export_host_opt_state(self, opt_state):
        """Optimizer state in the reference's host layout: subtrees that
        mirror the params (SGD velocity, Adam m/v) go through
        export_host_params, the step becomes an int32 scalar array."""
        return {
            k: self.export_host_params(v) if isinstance(v, dict) else np.asarray(v, np.int32)
            for k, v in opt_state.items()
        }

    # -- forward -------------------------------------------------------------

    def forward_values(
        self,
        params,
        batch,
        rng: Optional[int] = None,
        train: bool = False,
        op_hooks=None,
    ) -> Dict[Tuple[int, int], torch.Tensor]:
        """Evaluate the PCG; returns {(guid, out_idx): tensor}.

        rng: an int seed, or None. Each node's ctx.rng is its own
        torch.Generator on the device, seeded node_seed(rng, guid) and
        made only when the lowering reads it.

        op_hooks: {OperatorType: fn(node, ins, ws, ctx) -> [outs]} —
        per-op-type overrides of the registered lowering. The serving
        engine swaps the attention core for the KV-cache paths this way
        and everything else runs the normal lowering."""
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        ctx = LowerCtx(train=train)
        for guid in self.topo:
            node = self.graph.nodes[guid]
            if node.op_type == OperatorType.INPUT and not node.inputs:
                if node.name not in batch:
                    raise KeyError(f"batch missing input '{node.name}'")
                values[(guid, 0)] = torch.as_tensor(batch[node.name], device=self.device)
                continue
            ins = [values[(r.guid, r.out_idx)] for r in node.inputs]
            ws = params.get(guid, [])
            if rng is not None:
                ctx = LowerCtx(train=train, seed=node_seed(rng, guid), device=self.device)
            hook = op_hooks.get(node.op_type) if op_hooks else None
            outs = hook(node, ins, ws, ctx) if hook is not None else self._lowered[guid](ins, ws, ctx)
            for i, out in enumerate(outs):
                values[(guid, i)] = out
        return values

    def logits(self, params, batch, op_hooks=None) -> torch.Tensor:
        values = self.forward_values(params, batch, op_hooks=op_hooks)
        return values[(self.logits_ref.guid, self.logits_ref.out_idx)]

    def _loss_and_metrics(self, params, batch, rng, train):
        values = self.forward_values(params, batch, rng, train)
        logits = values[(self.logits_ref.guid, self.logits_ref.out_idx)]
        labels = batch["label"]
        loss = compute_loss(
            self.loss_type, logits, labels, from_logits=self.logits_from_logits
        )
        with torch.no_grad():
            mets = compute_metrics(
                self.metric_types, logits, labels, from_logits=self.logits_from_logits
            )
        return loss, mets

    # -- step functions ------------------------------------------------------

    def _loss_and_grads(self, params, batch, rng, train):
        """Loss, metrics and {guid: [grad]} through torch.autograd. The
        weights are made leaves that require grad first, whatever
        installed them (init_params, params_from_host)."""
        leaves = []
        for ws in params.values():
            for w in ws:
                if not w.requires_grad:
                    w.requires_grad_(True)
                leaves.append(w)
        with torch.enable_grad():
            loss, mets = self._loss_and_metrics(params, batch, rng, train)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(flat)
        grads = {}
        for g, ws in params.items():
            grads[g] = []
            for w in ws:
                gr = next(it)
                grads[g].append(torch.zeros_like(w) if gr is None else gr)
        return loss.detach(), mets, grads

    def sparse_embedding_guids(self) -> List[int]:
        """EMBEDDING nodes the reference updates touched-rows-only under
        sparse_embedding_update: tables whose ids come straight from a
        batch INPUT (flexflow_tpu/core/pcg.py trace_embedding_ids_input;
        the port has no layout-only parallel ops to look through)."""
        if not self.sparse_embedding_update or self.optimizer is None:
            return []
        out = []
        for g in self.topo:
            node = self.graph.nodes[g]
            if node.op_type != OperatorType.EMBEDDING or len(node.inputs) != 1:
                continue
            src = self.graph.nodes[node.inputs[0].guid]
            if src.op_type == OperatorType.INPUT and not src.inputs:
                out.append(g)
        return out

    def train_step(self):
        """(params, opt_state, batch, rng) -> (params, opt_state, loss,
        metrics): forward, backward and the optimizer's in-place update
        (the reference's train_step_fn and its jitted train_step; eager
        here, so one function).

        The reference updates the tables of sparse_embedding_guids() on
        the touched rows only, lazily: untouched rows neither decay nor
        move on momentum. The port's dense update gives the same numbers
        only for a stateless optimizer without weight decay, so any other
        optimizer raises here rather than differ silently."""
        tables = self.sparse_embedding_guids()
        if tables and self.optimizer.has_state():
            raise NotImplementedError(
                f"embedding tables {tables} take the reference's lazy "
                "touched-rows update under sparse_embedding_update=True; "
                f"with {self.optimizer} (momentum, moments or weight decay) "
                "that is not ported yet (ROADMAP, Port queue: lazy "
                "sparse-embedding update). Use plain SGD without weight "
                "decay, or FFConfig(sparse_embedding_update=False) for the "
                "dense update."
            )

        def step(params, opt_state, batch, rng=None):
            loss, mets, grads = self._loss_and_grads(params, batch, rng, train=True)
            new_params, new_state = self.optimizer.update(params, grads, opt_state)
            return new_params, new_state, loss, mets

        return step

    def eval_step(self):
        """(params, batch) -> (loss, metrics), no gradients."""

        def step(params, batch):
            with torch.no_grad():
                loss, mets = self._loss_and_metrics(params, batch, None, train=False)
            return loss, mets

        return step

    def grad_fn(self):
        """Loss gradients wrt params: (params, batch) -> {guid: [grad]}.
        rng-free (train=False), as the reference's."""

        def grads(params, batch):
            return self._loss_and_grads(params, batch, None, train=False)[2]

        return grads

    # -- data placement ------------------------------------------------------

    def shard_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the device (one device: no sharding)."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def input_nodes(self) -> List[int]:
        return [
            g
            for g in self.topo
            if self.graph.nodes[g].op_type == OperatorType.INPUT
            and not self.graph.nodes[g].inputs
        ]

    def input_shapes(self) -> Dict[str, ParallelTensorShape]:
        out = {self.graph.nodes[g].name: self.graph.nodes[g].output_shapes[0] for g in self.input_nodes()}
        if self.label_shape is not None:
            out["label"] = self.label_shape
        return out
