"""Multi-head attention (port of the single-device part of
flexflow_tpu/ops/attention.py).

Layouts are the reference's: activations [b, s, e], per-head tensors
[b, s, h, d], projection kernels wq/wk/wv [e, h, d] and wo [h, d, e].
The MHA lowering runs its core through the flash kernels #1-#3
(`ops/cuda/flash_kernel.flash_attention`, an autograd Function whose
backward is kernels #2 and #3) or through the dense core
`scaled_dot_product_attention` (plain matmul and softmax with the
reference's -1e30 mask fill), by the node's `use_flash` param. The
serving prefill calls the dense core directly, as the reference does.
Decode runs through the CUDA kernel seam (`decode_attention` /
`paged_decode_attention` -> ops/cuda/decode_kernel.py). Every kernel
wrapper takes its plain PyTorch version for CPU tensors. Sequence
parallelism and attention-probability dropout are not ported yet
(ROADMAP, Port queue).
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.core.parallel_tensor import ParallelDim, ParallelTensorShape
from flexflow_tpu_torch.core.types import OperatorType
from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk
from flexflow_tpu_torch.ops.registry import register_op

# the decode-core modes this slice takes: the kernel on CUDA tensors,
# its plain version on CPU tensors (the reference's "pallas"/"dense"
# modes pick between those by name; the port picks by device)
MODES = ("auto",)


def check_mode(kernel: str) -> None:
    if kernel not in MODES:
        raise NotImplementedError(
            f"decode_kernel={kernel!r}: this port takes only 'auto' (the "
            "CUDA kernel on the card, its plain version on the CPU)"
        )


def _infer_mha(input_shapes, params):
    q, k, v = input_shapes
    embed_dim = params["embed_dim"]
    num_heads = params["num_heads"]
    kdim = params.get("kdim", embed_dim)
    vdim = params.get("vdim", embed_dim)
    dtype = params.get("dtype", q.dtype)
    head_dim = embed_dim // num_heads
    if any(d.is_replica_dim or d.degree > 1 for s in input_shapes for d in s.dims):
        raise NotImplementedError(
            "mha: partitioned inputs are not ported yet (ROADMAP, Port "
            "queue: parallel strategies)"
        )
    b, s, _ = q.dims
    out = ParallelTensorShape((b, s, ParallelDim(embed_dim)), dtype)
    head = ParallelDim(num_heads)
    wq = ParallelTensorShape((ParallelDim(embed_dim), head, ParallelDim(head_dim)), dtype)
    wk = ParallelTensorShape((ParallelDim(kdim), head, ParallelDim(head_dim)), dtype)
    wv = ParallelTensorShape((ParallelDim(vdim), head, ParallelDim(head_dim)), dtype)
    wo = ParallelTensorShape((head, ParallelDim(head_dim), ParallelDim(embed_dim)), dtype)
    weights = [wq, wk, wv, wo]
    if params.get("bias", True):
        bqkv = ParallelTensorShape((head, ParallelDim(head_dim)), dtype)
        bo = ParallelTensorShape((ParallelDim(embed_dim),), dtype)
        weights += [bqkv, bqkv, bqkv, bo]
    return (out,), tuple(weights)


def scaled_dot_product_attention(q, k, v, causal=False):
    """q, k, v: [b, s, h, d] — plain attention, fp32 softmax, masked
    logits filled with -1e30 as in the reference."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((qlen, klen), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mha_project_qkv(ins, ws, ctx=None, use_bias=True):
    """Input projections: (xq, xk, xv) [b, s, e] -> (q, k, v) [b, s, h, d].
    Shared by the dense lowering and the serving engine, so the cached
    K/V rows come from exactly the projections the full forward uses."""
    out = []
    for i, x in enumerate(ins[:3]):
        w = ws[i]  # [e, h, d]
        y = (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])
        if use_bias:
            y = y + ws[4 + i]
        out.append(y)
    return tuple(out)


def mha_project_out(attn, ws, ctx=None, use_bias=True):
    """Output projection: attn [b, s, h, d] -> [b, s, e]."""
    wo = ws[3]  # [h, d, e]
    y = attn.reshape(*attn.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])
    if use_bias:
        y = y + ws[7]
    return y


def decode_attention(q, k_cache, v_cache, lengths, kernel="auto"):
    """One-query attention against the contiguous cache. q: [b, 1, h, d];
    k_cache/v_cache: [b, max_len, h, d]; lengths: [b] int32, the position
    the current token was written at — positions > lengths[i] are
    masked. The kernel seam: flash_decode (kernel #4)."""
    check_mode(kernel)
    return dk.flash_decode(q, k_cache, v_cache, lengths)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, kernel="auto"):
    """One-query attention against the block-paged cache. q: [b, 1, h, d];
    k_pool/v_pool: [num_pages, page_size, h, d]; block_tables:
    [b, pages_per_seq] int32 (sentinel num_pages for unallocated
    entries); lengths: [b] int32. The kernel seam: paged_flash_decode
    (kernel #5). Rows whose visible pages are all sentinels return 0,
    where the reference's dense path softmaxes stale rows; both happen
    only for dead slots, whose outputs the scheduler discards."""
    check_mode(kernel)
    return dk.paged_flash_decode(q, k_pool, v_pool, block_tables, lengths)


# Flash-or-dense rule. use_flash "auto" and True both go through the
# flash wrapper, False runs the dense core. On a CUDA tensor the wrapper
# launches the kernels or raises: a shape that flash_kernel.supports()
# refuses (not fp32, or head_dim not a multiple of 8 up to 128) needs
# use_flash=False, and never falls back to the dense core unasked. On a
# CPU tensor the wrapper takes its plain version, whatever the shape.
# The reference's thresholds do not carry over: its "auto" took
# flash only past a 2 GiB score tensor (_FLASH_SCORE_BYTES) and scanned
# dense attention over batch chunks under _DENSE_MONO/CHUNK_SCORE_BYTES
# (_chunked_dense_attention, set_dense_caps), all v5e measurements of a
# chip with another memory system. On the H100 the dense core stores the
# [b, h, s, s] probabilities for its backward (134 MB per layer at the
# flagship shape) where the kernels keep O(s * d), and the card's rule is
# for its own measurements to set (chip_smoke.py times both cores).
FLASH_MODES = ("auto", True, False)


def _lower_mha(params):
    causal = params.get("causal", False)
    use_bias = params.get("bias", True)
    dropout = params.get("dropout", 0.0)
    use_flash = params.get("use_flash", "auto")
    if use_flash not in FLASH_MODES:
        raise ValueError(f"use_flash must be 'auto', True or False, got {use_flash!r}")

    def fn(ins, ws, ctx):
        if dropout > 0.0 and ctx is not None and ctx.train:
            raise NotImplementedError(
                "mha: attention-probability dropout is not ported yet "
                "(ROADMAP, Port queue: attention dropout)"
            )
        q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
        if use_flash is False:
            attn = scaled_dot_product_attention(q, k, v, causal=causal)
        elif q.is_cuda and not fk.supports(q.shape[1], k.shape[1], q.shape[-1], q.dtype):
            raise ValueError(
                f"mha: the flash kernels do not take head_dim {q.shape[-1]} "
                f"in {q.dtype} (use_flash={use_flash!r}); set the node's "
                "use_flash=False for the dense core"
            )
        else:
            attn = fk.flash_attention(q, k, v, causal=causal)
        return [mha_project_out(attn, ws, ctx, use_bias=use_bias)]

    return fn


register_op(OperatorType.MULTIHEAD_ATTENTION, _infer_mha, _lower_mha)
