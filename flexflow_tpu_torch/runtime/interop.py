"""Weight carry-over from the JAX package's host layout.

`flexflow_tpu`'s `Executor.export_host_params` returns weights as
`{guid: [np.ndarray, ...]}`. Guids are handed out from 100 in build
order in both packages, and the port's builders record the same nodes
with the same weight shapes, so the same builder calls on both sides
give graphs whose weights line up guid for guid. `params_from_host`
checks that they do and places the arrays on the model's device, as
leaf tensors that train exactly like `init_params` ones;
`opt_state_from_host` does the same for optimizer state in the layout
of `Executor.export_host_opt_state` (either package's).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch


def params_from_host(
    model,
    host_params: Mapping[int, List[np.ndarray]],
    op_types: Optional[Mapping[int, str]] = None,
) -> Dict[int, List[torch.Tensor]]:
    """Install `host_params` as the compiled `model`'s weights and return
    them. Every weighted node of the port's graph must appear under its
    guid with one array per weight, each of the shape the port inferred;
    `op_types` ({guid: OperatorType name} of the source graph), when
    given, must agree with the port's op types too. Arrays are cast to
    each weight's dtype and copied to the model's device."""
    if model.executor is None:
        raise RuntimeError("compile() the model before loading weights")
    graph = model.graph
    params: Dict[int, List[torch.Tensor]] = {}
    for guid in model.executor.topo:
        node = graph.nodes[guid]
        if op_types is not None and op_types.get(guid) != node.op_type.name:
            raise ValueError(
                f"node {guid} ({node.name}) is {node.op_type.name}, the "
                f"source graph has {op_types.get(guid)}"
            )
        if not node.weight_shapes:
            if host_params.get(guid):
                raise ValueError(f"node {guid} ({node.name}) has no weights")
            continue
        if guid not in host_params:
            raise KeyError(f"missing weights for node {guid} ({node.name})")
        arrays = list(host_params[guid])
        if len(arrays) != len(node.weight_shapes):
            raise ValueError(
                f"node {guid} ({node.name}) has {len(node.weight_shapes)} "
                f"weights, got {len(arrays)}"
            )
        ws = []
        for i, (shape, arr) in enumerate(zip(node.weight_shapes, arrays)):
            arr = np.array(arr)  # a writable host copy
            if tuple(arr.shape) != shape.logical_sizes:
                raise ValueError(
                    f"node {guid} ({node.name}) weight {i}: shape "
                    f"{tuple(arr.shape)}, the port expects {shape.logical_sizes}"
                )
            ws.append(
                torch.as_tensor(arr, dtype=shape.dtype.to_torch()).to(model.device)
            )
        params[guid] = ws
    extra = sorted({g for g, ws in host_params.items() if len(ws)} - set(params))
    if extra:
        raise ValueError(f"weights for guids the port's graph lacks: {extra}")
    model.params = params
    return params


def opt_state_from_host(model, host_state) -> dict:
    """Install optimizer state saved by either package's
    `export_host_opt_state` ({"step": scalar, "velocity" / "m" / "v":
    {guid: [array]}}) as the compiled `model`'s opt_state and return it.
    Each mirror subtree must match the model's weights guid for guid and
    shape for shape; the keys must be the model optimizer's."""
    if model.executor is None:
        raise RuntimeError("compile() the model before loading optimizer state")
    want = model.optimizer.init_state(model.params)
    if set(host_state) != set(want):
        raise ValueError(
            f"optimizer state keys {sorted(host_state)} are not "
            f"{model.optimizer}'s {sorted(want)}"
        )
    state = {}
    for key, val in host_state.items():
        if not isinstance(val, Mapping):
            state[key] = int(np.asarray(val))
            continue
        tree = {}
        for guid, ws in want[key].items():
            arrays = list(val.get(guid, ()))
            if len(arrays) != len(ws) or any(
                tuple(np.shape(a)) != tuple(w.shape) for a, w in zip(arrays, ws)
            ):
                raise ValueError(f"optimizer state '{key}' for node {guid} does not match its weights")
            tree[guid] = [
                torch.as_tensor(np.array(a), dtype=w.dtype).to(model.device)
                for a, w in zip(arrays, ws)
            ]
        state[key] = tree
    model.opt_state = state
    return state
