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
Decode and speculative verify run through the CUDA kernel seam
(`decode_attention`, `paged_decode_attention`, `verify_attention`,
`paged_verify_attention` -> ops/cuda/decode_kernel.py, kernels #4-#9):
the staircase or the token-tree mask (`tree_allowed_mask`), over fp32
caches or int8 paged pools with per-(page, head) scales. Every kernel
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
from flexflow_tpu_torch.ops.registry import mm_operands, mm_out_dtype, register_op

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
    logits filled with -1e30 as in the reference. bf16 operands (mixed
    precision) form the logits in f32 (their products are exact in f32,
    as the reference's preferred_element_type=f32) and the probabilities
    are rounded to bf16 before P V, whose output is bf16."""
    d = q.shape[-1]
    if q.dtype == torch.bfloat16:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((qlen, klen), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mha_project_qkv(ins, ws, ctx=None, use_bias=True):
    """Input projections: (xq, xk, xv) [b, s, e] -> (q, k, v) [b, s, h, d].
    Shared by the dense lowering and the serving engine, so the cached
    K/V rows come from exactly the projections the full forward uses.
    Under mixed precision the operands are bf16 (mm_operands) and q, k, v
    and their biases take the compute dtype bf16."""
    out = []
    for i, x in enumerate(ins[:3]):
        xm, w = mm_operands(ctx, x, ws[i])  # w: [e, h, d]
        y = (xm @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])
        if use_bias:
            y = y + ws[4 + i].to(y.dtype)
        out.append(y)
    return tuple(out)


def mha_project_out(attn, ws, ctx=None, use_bias=True):
    """Output projection: attn [b, s, h, d] -> [b, s, e], bf16 under
    mixed precision."""
    am, wo = mm_operands(ctx, attn, ws[3])  # wo: [h, d, e]
    y = am.reshape(*attn.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])
    y = y.to(mm_out_dtype(ctx, ws[3].dtype))
    if use_bias:
        y = y + ws[7].to(y.dtype)
    return y


def decode_attention(q, k_cache, v_cache, lengths, kernel="auto"):
    """One-query attention against the contiguous cache. q: [b, 1, h, d]
    float32, or bfloat16 from a mixed-precision model's projections;
    k_cache/v_cache: [b, max_len, h, d] float32; lengths: [b] int32, the
    position the current token was written at — positions > lengths[i]
    are masked. Returns [b, 1, h, d] in q's dtype. The kernel seam:
    flash_decode (kernel #4)."""
    check_mode(kernel)
    return dk.flash_decode(q, k_cache, v_cache, lengths)


def tree_ancestor_matrix(parents):
    """Ancestor-or-self closure of a draft tree, threaded as data.

    parents: [b, w] int — parents[i, j] is the verify-row index of row
    j's parent within the same w-row window, -1 for the root (row 0;
    padding rows use j - 1, which degenerates to the linear chain), each
    parent index below its child's. Returns [b, w, w] bool with
    anc[i, j, a] True iff row a is an ancestor of row j or j itself.
    Pointer doubling: ceil(log2(w)) rounds cover any chain inside a
    w-row window."""
    b, w = parents.shape
    anc = torch.eye(w, dtype=torch.bool, device=parents.device).expand(b, w, w)
    if w == 1:
        return anc
    ptr = parents.long()
    for _ in range(max(1, math.ceil(math.log2(w)))):
        valid = ptr >= 0
        safe = ptr.clamp(0, w - 1)
        rows = torch.gather(anc, 1, safe[:, :, None].expand(b, w, w))
        anc = anc | (rows & valid[:, :, None])
        ptr = torch.where(valid, torch.gather(ptr, 1, safe), ptr)
    return anc


def tree_allowed_mask(tree_parents, lengths, w, klen):
    """[b, w, klen] bool verify visibility for a draft tree: query row j
    of sequence i sees cache position p iff p < lengths[i] (the committed
    prefix) or p falls inside the w-row verify window at the offset of
    one of row j's ancestors (or j itself). Chain parents
    (parents[j] = j - 1) reproduce the staircase p <= lengths[i] + j."""
    b = tree_parents.shape[0]
    anc = tree_ancestor_matrix(tree_parents)  # [b, w, w]
    kpos = torch.arange(klen, device=tree_parents.device)[None, None, :]
    base = lengths.long()[:, None, None]
    rel = kpos - base  # window offset of each key position
    window = (rel >= 0) & (rel < w)
    idx = rel.clamp(0, w - 1).expand(b, w, klen)
    in_tree = torch.gather(anc, 2, idx)
    return (kpos < base) | (window & in_tree)


def _verify_mask(tree_parents, allowed, lengths, w, klen):
    """The tree mask a verify call runs under: the precomputed `allowed`
    (the engine builds it once per step, not once per layer), else one
    built from `tree_parents`; None for the staircase."""
    if allowed is None and tree_parents is not None:
        allowed = tree_allowed_mask(tree_parents, lengths, w, klen)
    return allowed


def verify_attention(
    q, k_cache, v_cache, lengths, kernel="auto", tree_parents=None, allowed=None
):
    """Speculative-decoding verify: w query positions per sequence (the
    last emitted token plus the drafted continuation) attend against the
    contiguous cache in one call. q: [b, w, h, d]; k_cache/v_cache:
    [b, max_len, h, d], already holding the w fresh rows at positions
    lengths[i]..lengths[i] + w - 1; lengths: [b] int32, the position of
    the first of them. Query j sees positions <= lengths[i] + j (kernel
    #4), or, with tree_parents [b, w] or a precomputed `allowed`
    [b, w, max_len], the token-tree ancestor mask (kernel #7). q is
    float32 or bfloat16 (mixed precision), the cache float32; returns
    [b, w, h, d] in q's dtype."""
    check_mode(kernel)
    allowed = _verify_mask(tree_parents, allowed, lengths, q.shape[1], k_cache.shape[1])
    if allowed is not None:
        return dk.flash_verify_tree(q, k_cache, v_cache, lengths, allowed)
    return dk.flash_verify(q, k_cache, v_cache, lengths)


def paged_verify_attention(
    q, k_pool, v_pool, block_tables, lengths, kernel="auto",
    k_scale=None, v_scale=None, tree_parents=None, allowed=None,
):
    """Verify attention against the block-paged cache: verify_attention's
    function over pools walked through the block table (kernel #5), over
    int8 pools with k_scale/v_scale [num_pages, heads] fp32 (#6), and
    under the token-tree mask over logical positions (#8, and #9 on int8
    pools). q float32 or bfloat16 against fp32 or int8 pools; the output
    takes q's dtype."""
    check_mode(kernel)
    klen = block_tables.shape[1] * k_pool.shape[1]
    allowed = _verify_mask(tree_parents, allowed, lengths, q.shape[1], klen)
    quant = k_scale is not None
    if allowed is not None:
        if quant:
            return dk.paged_flash_verify_tree_quant(
                q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, allowed
            )
        return dk.paged_flash_verify_tree(q, k_pool, v_pool, block_tables, lengths, allowed)
    if quant:
        return dk.paged_flash_verify_quant(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths
        )
    return dk.paged_flash_verify(q, k_pool, v_pool, block_tables, lengths)


def paged_decode_attention(
    q, k_pool, v_pool, block_tables, lengths, kernel="auto", k_scale=None, v_scale=None
):
    """One-query attention against the block-paged cache. q: [b, 1, h, d];
    k_pool/v_pool: [num_pages, page_size, h, d]; block_tables:
    [b, pages_per_seq] int32 (sentinel num_pages for unallocated
    entries); lengths: [b] int32. q float32 or bfloat16 (mixed
    precision), the output in q's dtype. The kernel seam:
    paged_flash_decode (kernel #5), or paged_flash_decode_quant (#6) on
    int8 pools with
    k_scale/v_scale [num_pages, heads]. Rows whose visible pages are all
    sentinels return 0, where the reference's dense path softmaxes stale
    rows; both happen only for dead slots, whose outputs the scheduler
    discards."""
    check_mode(kernel)
    if k_scale is not None:
        return dk.paged_flash_decode_quant(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths
        )
    return dk.paged_flash_decode(q, k_pool, v_pool, block_tables, lengths)


# Flash-or-dense rule. use_flash "auto" and True both go through the
# flash wrapper, False runs the dense core. On a CUDA tensor the wrapper
# launches the kernels or raises: a shape that flash_kernel.supports()
# refuses (head_dim not a multiple of 8) needs use_flash=False, and never
# falls back to the dense core unasked. Under mixed precision q, k, v
# arrive bf16 and run the bf16 bodies (past head_dim 256 the bf16 wide
# kernels). On a
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
