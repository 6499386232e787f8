"""Core operators of the serving slice (port of the INPUT, LINEAR,
LAYERNORM, EMBEDDING and EW_ADD entries of flexflow_tpu/ops/core_ops.py).

Layouts follow the reference package: linear kernels are
[in_features, out_features], embedding tables [num_entries, out_dim].
The other operators of the reference file are not ported yet (ROADMAP,
Port queue: training op breadth); the registry raises for them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.parallel_tensor import ParallelDim, ParallelTensorShape
from flexflow_tpu_torch.core.types import ActiMode, AggrMode, DataType, OperatorType
from flexflow_tpu_torch.ops.registry import mm_operands, mm_out_dtype, register_op


def _split_replica(shape: ParallelTensorShape):
    """Split leading replica dims from logical dims."""
    rep = [d for d in shape.dims if d.is_replica_dim]
    logical = [d for d in shape.dims if not d.is_replica_dim]
    return rep, logical


_ACTIVATIONS = {
    ActiMode.RELU: torch.relu,
    ActiMode.SIGMOID: torch.sigmoid,
    ActiMode.TANH: torch.tanh,
    # exact (erf) form, as the reference lowers it (core_ops.py:54)
    ActiMode.GELU: lambda v: F.gelu(v, approximate="none"),
}


def _apply_activation(x, act: ActiMode):
    if act is None or act == ActiMode.NONE:
        return x
    return _ACTIVATIONS[act](x)


# -- graph sources ------------------------------------------------------------


def _infer_noop(input_shapes, params):
    if input_shapes:
        return tuple(input_shapes), ()
    return (params["shape"],), ()


register_op(OperatorType.INPUT, _infer_noop, lambda p: lambda ins, ws, ctx: list(ins))


# -- Linear (reference: src/ops/linear.cc) ------------------------------------


def _infer_linear(input_shapes, params):
    (x,) = input_shapes
    out_features = params["out_features"]
    dtype = params.get("dtype", x.dtype)
    rep, logical = _split_replica(x)
    if rep or any(d.degree > 1 for d in logical):
        raise NotImplementedError(
            "linear: partitioned inputs are not ported yet (ROADMAP, Port "
            "queue: parallel strategies)"
        )
    out = ParallelTensorShape(
        tuple(logical[:-1]) + (ParallelDim(out_features),), dtype
    )
    kernel = ParallelTensorShape(
        (ParallelDim(logical[-1].size), ParallelDim(out_features)), dtype
    )
    weights = [kernel]
    if params.get("use_bias", True):
        weights.append(ParallelTensorShape((ParallelDim(out_features),), dtype))
    return (out,), tuple(weights)


def _lower_linear(params):
    act = params.get("activation", ActiMode.NONE)
    use_bias = params.get("use_bias", True)

    def fn(ins, ws, ctx):
        (x,) = ins
        kernel = ws[0]
        # under mixed precision a bf16 matmul: f32 accumulation, one
        # rounding of the output to bf16 (the reference's
        # preferred_element_type=f32 then astype)
        xm, km = mm_operands(ctx, x, kernel)
        y = torch.matmul(xm, km).to(mm_out_dtype(ctx, kernel.dtype))
        if use_bias:
            y = y + ws[1].to(y.dtype)
        return [_apply_activation(y, act)]

    return fn


register_op(OperatorType.LINEAR, _infer_linear, _lower_linear)


# -- LayerNorm ------------------------------------------------------------------


def _infer_layernorm(input_shapes, params):
    (x,) = input_shapes
    axes = params.get("axes", (x.ndim - 1,))
    weights = ()
    if params.get("elementwise_affine", True):
        w = ParallelTensorShape(
            tuple(ParallelDim(x.dims[a].size) for a in axes), x.dtype
        )
        weights = (w, w)
    return (x,), weights


def _lower_layernorm(params):
    eps = params.get("eps", 1e-5)
    elementwise_affine = params.get("elementwise_affine", True)

    def fn(ins, ws, ctx):
        (x,) = ins
        axes = tuple(a % x.ndim for a in params.get("axes", (x.ndim - 1,)))
        if axes != tuple(range(x.ndim - len(axes), x.ndim)):
            raise NotImplementedError(
                f"layernorm over non-trailing axes {axes} is not ported yet "
                "(ROADMAP, Port queue: training op breadth)"
            )
        w, b = (ws[0], ws[1]) if elementwise_affine else (None, None)
        # f32 statistics and affine under a bf16 activation flow, rounded
        # back to the input's dtype (reference core_ops.py:399-413)
        y = F.layer_norm(x.float(), x.shape[-len(axes):], w, b, eps)
        return [y.to(x.dtype)]

    return fn


register_op(OperatorType.LAYERNORM, _infer_layernorm, _lower_layernorm)


# -- Embedding (reference: src/ops/embedding.cc) ------------------------------


def _infer_embedding(input_shapes, params):
    (x,) = input_shapes  # int ids [*batch] or [*batch, bag]
    aggr = params.get("aggr", AggrMode.NONE)
    dtype = params.get("dtype", DataType.FLOAT)
    _, logical = _split_replica(x)
    out_batch = list(logical)
    if aggr != AggrMode.NONE:
        out_batch = out_batch[:-1]  # bag dim folded
    out = ParallelTensorShape(
        tuple(out_batch) + (ParallelDim(params["out_dim"]),), dtype
    )
    weight = ParallelTensorShape(
        (ParallelDim(params["num_entries"]), ParallelDim(params["out_dim"])),
        dtype,
    )
    return (out,), (weight,)


def _lower_embedding(params):
    aggr = params.get("aggr", AggrMode.NONE)

    def fn(ins, ws, ctx):
        (ids,) = ins
        y = ws[0][ids.long()]
        if aggr == AggrMode.SUM:
            y = y.sum(dim=-2)
        elif aggr == AggrMode.AVG:
            y = y.mean(dim=-2)
        return [y]

    return fn


register_op(OperatorType.EMBEDDING, _infer_embedding, _lower_embedding)


# -- element-wise add ---------------------------------------------------------


def _infer_add(input_shapes, params):
    a, b = input_shapes
    if any(d.is_replica_dim or d.degree > 1 for d in a.dims + b.dims):
        raise NotImplementedError(
            "add: partitioned inputs are not ported yet (ROADMAP, Port "
            "queue: parallel strategies)"
        )
    sizes = torch.broadcast_shapes(a.logical_sizes, b.logical_sizes)
    return (ParallelTensorShape.make(tuple(sizes), a.dtype),), ()


# Under mixed precision no cast: bf16 + f32 promotes to f32 in torch as
# in JAX, so a residual stream that starts f32 (an embedding's output)
# stays f32 while the matmul outputs added to it are bf16.
register_op(
    OperatorType.EW_ADD,
    _infer_add,
    lambda p: lambda ins, ws, ctx: [ins[0] + ins[1]],
)
