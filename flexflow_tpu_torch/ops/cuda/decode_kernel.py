"""Flash-decode kernels against the serving KV cache (port of
flexflow_tpu/ops/pallas/decode_kernel.py, kernels #4-#9 of the family).

The device code is CUDA C++ for Hopper, built on first use by
ops/cuda/_build.py and called through ctypes on PyTorch's current
stream. Two device bodies, each templated on the layout, the pool type
and the mask, as the JAX family shares one body between decode and
verify; every wrapper picks between them by head_dim alone, before any
launch:

  * csrc/tree_kernel.cu, the split-KV body, at head_dim <= _TREE_MAX_D
    (256): one launch per call over (split, head, sequence) blocks; the
    blocks of a sequence's positions merge their partials in the last of
    them to finish. It serves all six: the staircase on the contiguous
    cache (#4), on fp32 pools (#5) and on int8 pools (#6), and the tree
    mask on the same three (#7, #8, #9). At w = 1, every decode step,
    the staircase runs a tile of one query row: fp32 rows (#4, #5) with
    half-warps across rows, int8 rows (#6) with one 16-byte load per lane
    (4 lanes per row at head_dim 64; two 8-byte loads where the rows are
    not 16-byte aligned, head_dim 24 or 40), over splits of
    _QUANT_SPAN_UNIT positions;
  * csrc/decode_kernel.cu past 256: one block per (64-column piece of the
    output, head, sequence), the scores contracted over head_dim in
    64-column pieces, so its shared memory does not grow with head_dim
    and every w up to MAX_W fits at every head_dim (pick_chunk).

q is float32, or bfloat16 from a mixed-precision model's projections;
the pools stay float32 or int8 either way, as the reference's cache
does. A bf16 q is widened to f32 as the kernel loads it, the scores, P
and the accumulators stay f32 (the reference's dots take
preferred_element_type f32 and cast P to the V pool's dtype), and the
output takes q's dtype, rounded once as it is written (the reference's
`.astype(o_ref.dtype)`). A bf16-q launch counts under name + "_bf16".

The entry points:

  * `flash_verify(q, k_cache, v_cache, lengths)` (#4) — w queries per
    sequence against the contiguous cache [b, max_len, h, d] under the
    staircase mask key_pos <= lengths[b] + j; `flash_decode` is its
    w == 1 case (ops/attention.decode_attention's semantics).
  * `paged_flash_verify(q, k_pool, v_pool, block_tables, lengths)` (#5)
    — the same over pools [num_pages, page_size, h, d] walked through
    the block table; `paged_flash_decode` is its w == 1 case. Positions
    on sentinel pages (table entries outside [0, num_pages)) contribute
    nothing, and a row that sees no allocated page returns zeros.
  * `paged_flash_verify_quant(q, k_pool, v_pool, k_scale, v_scale,
    block_tables, lengths)` (#6) — #5 over int8 pools with one fp32
    scale per (page, head), dequantized inside the page walk;
    `paged_flash_decode_quant` is its w == 1 case.
  * `flash_verify_tree(q, k_cache, v_cache, lengths, allowed)` (#7),
    `paged_flash_verify_tree(..., block_tables, lengths, allowed)` (#8)
    and `paged_flash_verify_tree_quant(...)` (#9) — #4, #5 and #6 with
    the token-tree visibility mask `allowed` [b, w, max_len] (> 0 or
    True = visible; ops/attention.tree_allowed_mask) in place of the
    staircase. On the paged layout the mask is over logical positions.

Every variant reads only positions < lengths[b] + w (the chunk gate).
The kernels take every shape the reference's supports() takes (any w up
to MAX_W at any head_dim that is a multiple of 8; fp32 also at multiples
of 4), and two TPU limits do not carry over: the int8 kernels take any
page size (the reference needed 32-row int8 pages, `_INT8_SUBLANES`),
and the tree kernels take w up to MAX_W (the reference fell back to
dense attention past `_MAX_TREE_W` = 32).

Beside each kernel sits its plain PyTorch version (`*_ref`) computing
the same function. A wrapper picks by the device of its input alone: a
CPU tensor goes to the plain version, a CUDA tensor launches the kernel
or raises. `LAUNCHES` counts kernel launches per entry point, so a run
can show that its steps went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from flexflow_tpu_torch.ops.cuda import _build

SOURCE = "decode_kernel.cu"
TREE_SOURCE = "tree_kernel.cu"

# query rows per sequence the kernels take (the reference's _MAX_W); the
# tree variants take the same, where the reference stopped at 32
MAX_W = 64

ENTRY_POINTS = (
    "flash_verify",
    "paged_flash_verify",
    "paged_flash_verify_quant",
    "flash_verify_tree",
    "paged_flash_verify_tree",
    "paged_flash_verify_tree_quant",
)

# kernel launches per entry point since the last reset_launches(): fp32 q
# under the entry point's name, bf16 q (a mixed-precision model) under
# name + "_bf16"
LAUNCHES: Dict[str, int] = {
    **dict.fromkeys(ENTRY_POINTS, 0),
    **dict.fromkeys((n + "_bf16" for n in ENTRY_POINTS), 0),
}

# decode_kernel.cu's body (head_dim past _TREE_MAX_D): key rows staged per
# loop iteration, a multiple of _CHUNK_STEP up to _MAX_CHUNK whose buffers
# fit the shared-memory budget; none of them grows with head_dim
_MAX_CHUNK = 128
_CHUNK_STEP = 32
_SMEM_BUDGET = 160 * 1024

_MASK = -1e30  # the reference's finite mask fill

# the split-KV body (tree_kernel.cu, whose kSpanUnit and kMaxSplits
# refuse a launch that breaks these): a split's span is a multiple of
# _TREE_SPAN_UNIT positions (a whole number of its 32- or 64-row chunks
# and of the one-row tiles' 16- to 64-row passes), a call takes at
# most _TREE_MAX_SPLITS, head_dim is at most _TREE_MAX_D, and the host
# aims for this many blocks per SM
_TREE_SPAN_UNIT = 64
_TREE_MAX_SPLITS = 64
_TREE_MAX_D = 256
_BLOCKS_PER_SM = 8
# the span unit of #6 at w = 1 (the int8 one-row tile, whose row reads
# are a quarter of the fp32 tile's bytes): 128 positions, 2 passes of its
# 64 rows at head_dim 64; on one H100 it beat 64 and 256 at the serving
# shape and at short contexts together (PERF.md, scripts/decode_split_body.py)
_QUANT_SPAN_UNIT = 128

_bound: Optional[ctypes.CDLL] = None
_tree_bound: Optional[ctypes.CDLL] = None
# (device index, stream) -> the tree body's per-(sequence, head) arrival
# counters, zero between calls (each launch leaves them zero)
_counters: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _bound
    if _bound is None:
        lib = _build.load(SOURCE)
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ff_decode_smem_bytes.argtypes = [I, I, I]
        lib.ff_decode_smem_bytes.restype = L
        lib.ff_decode_smem_limit.argtypes = []
        lib.ff_decode_smem_limit.restype = L
        lib.ff_cuda_error_string.argtypes = [I]
        lib.ff_cuda_error_string.restype = ctypes.c_char_p
        lib.ff_decode_attention.argtypes = [P] * 9 + [I] * 12 + [L] * 12 + [F, P]
        lib.ff_decode_attention.restype = I
        _bound = lib
    return _bound


def _tree_lib() -> ctypes.CDLL:
    """The built tree-verify library with its C signatures declared."""
    global _tree_bound
    if _tree_bound is None:
        lib = _build.load(TREE_SOURCE)
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ff_cuda_error_string.argtypes = [I]
        lib.ff_cuda_error_string.restype = ctypes.c_char_p
        lib.ff_tree_attention.argtypes = [P] * 12 + [I] * 14 + [L] * 12 + [F, P]
        lib.ff_tree_attention.restype = I
        _tree_bound = lib
    return _tree_bound


@functools.lru_cache(maxsize=None)
def pick_splits(b: int, h: int, max_len: int, unit: int, sms: int, span_unit: int = _TREE_SPAN_UNIT):
    """(splits, span) of the tree body's grid (splits, h, b): each block
    owns `span` positions, a multiple of `span_unit` (a multiple of
    _TREE_SPAN_UNIT: _QUANT_SPAN_UNIT for #6 at w = 1) and of `unit` (the
    page size on the paged layout), and splits x span covers max_len.
    From the shape alone, never from `lengths` (that would read a device
    tensor to the host on every layer): enough splits that the grid holds
    _BLOCKS_PER_SM blocks per SM, none shorter than a step of span unit
    and unit, and at most _TREE_MAX_SPLITS."""
    step = math.lcm(span_unit, unit)
    most = min(_TREE_MAX_SPLITS, -(-max_len // step))
    want = -(-_BLOCKS_PER_SM * sms // max(1, b * h))
    splits = max(1, min(want, most))
    span = -(-(-(-max_len // splits)) // step) * step
    return -(-max_len // span), span


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _arrival_counters(device, stream: int, n: int) -> torch.Tensor:
    """At least n int32 zeros for the tree body's arrival counts on
    `stream`; a launch leaves them zero, so they are made once per stream
    (and again only to grow), on that stream."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


@functools.lru_cache(maxsize=None)
def pick_chunk(w: int, tree: bool = False) -> int:
    """decode_kernel.cu's key rows per loop iteration: the largest
    multiple of _CHUNK_STEP up to _MAX_CHUNK whose buffers (and, for a
    tree, mask rows) fit the shared-memory budget. Its rows resolve their
    pages one by one, so a chunk need not hold whole pages, and no buffer
    grows with head_dim: every w up to MAX_W fits at every head_dim."""
    lib = _lib()
    budget = min(_SMEM_BUDGET, lib.ff_decode_smem_limit())
    fits = [c for c in range(_CHUNK_STEP, _MAX_CHUNK + 1, _CHUNK_STEP)
            if lib.ff_decode_smem_bytes(w, c, int(tree)) <= budget]
    return fits[-1]


# -- plain PyTorch versions ----------------------------------------------------


def _masked_attention(q, k, v, allowed, sm_scale):
    """q [b, w, h, d]; k/v [b, L, h, d]; allowed [b, w, L] bool. The
    kernels' function: masked entries weigh exactly 0 and a row with no
    allowed key returns 0 (acc / max(l, 1e-30)). As the reference's
    kernels cast: a bf16 q is widened to f32 (exact), the scores and P
    are f32 (P takes the V pool's dtype, fp32 or dequantized int8), and
    the output takes q's dtype, rounded once. A float64 q computes the
    exact function (for measuring errors against)."""
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), k.to(wide)) * sm_scale
    mask = allowed[:, None, :, :]
    m = s.masked_fill(~mask, _MASK).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), dtype=s.dtype))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p / l, v.to(wide)).to(q.dtype)


def _staircase(lengths, w, klen):
    """[b, w, klen]: query j of sequence i sees positions <= lengths[i] + j."""
    kpos = torch.arange(klen, device=lengths.device)
    qoff = torch.arange(w, device=lengths.device)
    return kpos[None, None, :] <= (lengths.long()[:, None, None] + qoff[None, :, None])


def _tree_visible(allowed, lengths, w):
    """[b, w, klen] bool: the tree mask (> 0 visible) under the chunk gate
    key_pos < lengths[i] + w that every kernel variant applies."""
    klen = allowed.shape[-1]
    kpos = torch.arange(klen, device=lengths.device)
    gate = kpos[None, :] < lengths.long()[:, None] + w
    return (allowed > 0) & gate[:, None, :]


def gather_pages(pool, block_tables, scale=None):
    """Each sequence's pages as a contiguous [b, pages * page_size, h, d]
    view (sentinel entries clamped to a real page), and the [b, L] mask of
    positions on real pages. With an int8 pool, `scale` [num_pages, h]
    dequantizes each page in fp32, as the reference's
    attention._dequant_pages does; a page never written has scale 0 and
    reads as zeros."""
    num_pages, page_size, h, d = pool.shape
    tbl = block_tables.long()
    safe = tbl.clamp(0, num_pages - 1)
    pages = pool[safe]  # [b, np, ps, h, d]
    if scale is not None:
        pages = pages.float() * scale[safe][:, :, None, :, None]
    on_page = ((tbl >= 0) & (tbl < num_pages)).repeat_interleave(page_size, dim=1)
    return pages.reshape(tbl.shape[0], -1, h, d), on_page


def _scale_of(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_verify_ref(q, k_cache, v_cache, lengths, sm_scale=None):
    """Plain version of flash_verify: staircase-masked attention of q
    [b, w, h, d] against k/v [b, max_len, h, d]. Returns [b, w, h, d]."""
    allowed = _staircase(lengths, q.shape[1], k_cache.shape[1])
    return _masked_attention(q, k_cache, v_cache, allowed, _scale_of(q, sm_scale))


def paged_flash_verify_ref(q, k_pool, v_pool, block_tables, lengths, sm_scale=None):
    """Plain version of paged_flash_verify: gathers each sequence's pages
    into a contiguous view and masks positions on sentinel pages as well
    as past the staircase."""
    k, on_page = gather_pages(k_pool, block_tables)
    v, _ = gather_pages(v_pool, block_tables)
    allowed = _staircase(lengths, q.shape[1], k.shape[1]) & on_page[:, None, :]
    return _masked_attention(q, k, v, allowed, _scale_of(q, sm_scale))


def paged_flash_verify_quant_ref(
    q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, sm_scale=None
):
    """Plain version of paged_flash_verify_quant: the int8 pages
    dequantized with their (page, head) scales, then #5's function."""
    k, on_page = gather_pages(k_pool, block_tables, k_scale)
    v, _ = gather_pages(v_pool, block_tables, v_scale)
    allowed = _staircase(lengths, q.shape[1], k.shape[1]) & on_page[:, None, :]
    return _masked_attention(q, k, v, allowed, _scale_of(q, sm_scale))


def flash_verify_tree_ref(q, k_cache, v_cache, lengths, allowed, sm_scale=None):
    """Plain version of flash_verify_tree: attention of q [b, w, h, d]
    against k/v [b, max_len, h, d] where query row j sees position p iff
    allowed[b, j, p] > 0 and p < lengths[b] + w."""
    vis = _tree_visible(allowed, lengths, q.shape[1])
    return _masked_attention(q, k_cache, v_cache, vis, _scale_of(q, sm_scale))


def paged_flash_verify_tree_ref(
    q, k_pool, v_pool, block_tables, lengths, allowed, sm_scale=None
):
    """Plain version of paged_flash_verify_tree: the tree mask over
    logical positions, and positions on sentinel pages dropped."""
    k, on_page = gather_pages(k_pool, block_tables)
    v, _ = gather_pages(v_pool, block_tables)
    vis = _tree_visible(allowed, lengths, q.shape[1]) & on_page[:, None, :]
    return _masked_attention(q, k, v, vis, _scale_of(q, sm_scale))


def paged_flash_verify_tree_quant_ref(
    q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, allowed, sm_scale=None
):
    """Plain version of paged_flash_verify_tree_quant: #6's dequant and
    #8's tree mask."""
    k, on_page = gather_pages(k_pool, block_tables, k_scale)
    v, _ = gather_pages(v_pool, block_tables, v_scale)
    vis = _tree_visible(allowed, lengths, q.shape[1]) & on_page[:, None, :]
    return _masked_attention(q, k, v, vis, _scale_of(q, sm_scale))


# -- kernel wrappers -------------------------------------------------------------


Q_DTYPES = (torch.float32, torch.bfloat16)


def _check_operands(q, caches, lengths, tables=None, quant=False):
    """Raise on anything the kernel does not take: q float32 or bfloat16
    read 4 elements at a time (16 or 8 bytes), fp32 caches in 16-byte
    loads, int8 pools in 8-byte loads at least (16-byte where
    _int8_vec16), all with head_dim contiguous and rows aligned to their
    loads; int32 lengths/tables."""
    dev = q.device
    b, w, h, d = q.shape
    if not 1 <= w <= MAX_W:
        raise ValueError(f"decode kernel: w={w} outside [1, {MAX_W}]")
    if d % 4:
        raise ValueError(f"decode kernel: head_dim {d} is not a multiple of 4")
    if quant and d % 8:
        raise ValueError(
            f"decode kernel: head_dim {d} is not a multiple of 8, which int8 rows need"
        )
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"decode kernel: q is {q.dtype}, needs float32 or bfloat16")
    for name, t in (("q", q),) + caches:
        if name == "q":
            vec = 4  # elements per load, whatever q's dtype
        else:
            want = torch.int8 if quant else torch.float32
            vec = 8 if quant else 4
            if t.dtype != want:
                raise TypeError(f"decode kernel: {name} is {t.dtype}, needs {want}")
        if t.device != dev:
            raise ValueError(f"decode kernel: {name} on {t.device}, q on {dev}")
        if t.dim() != 4 or t.shape[2:] != (h, d):
            raise ValueError(
                f"decode kernel: {name} shape {tuple(t.shape)} does not end "
                f"in (heads, head_dim) = ({h}, {d})"
            )
        nbytes = vec * t.element_size()
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(
                f"decode kernel: {name} strides {t.stride()} are not "
                f"{nbytes}-byte aligned with head_dim contiguous"
            )
        if t.data_ptr() % nbytes:
            raise ValueError(f"decode kernel: {name} is not {nbytes}-byte aligned")
    ints = (("lengths", lengths),) + ((("block_tables", tables),) if tables is not None else ())
    for name, t in ints:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"decode kernel: {name} must be a contiguous int32 tensor "
                f"on {dev}, got {t.dtype} on {t.device}"
            )
    if lengths.shape != (b,):
        raise ValueError(f"decode kernel: lengths shape {tuple(lengths.shape)} != ({b},)")


def _int8_vec16(k, v) -> bool:
    """Whether the int8 pools' rows take 16-byte loads: head_dim a
    multiple of 16 and every row 16-byte aligned (else 8-byte loads,
    head_dim 24 or 40 for one)."""
    return all(t.shape[-1] % 16 == 0 and t.data_ptr() % 16 == 0
               and all(s % 16 == 0 for s in t.stride()[:-1]) for t in (k, v))


def _check_scales(k_scale, v_scale, num_pages, h, dev):
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (
            t.device != dev or t.dtype != torch.float32
            or t.shape != (num_pages, h) or not t.is_contiguous()
        ):
            raise ValueError(
                f"decode kernel: {name} must be a contiguous float32 "
                f"[{num_pages}, {h}] tensor on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def _mask_operand(allowed, b, w, klen, dev):
    """The tree mask as the kernel reads it: uint8 [b, w, klen], last dim
    contiguous, nonzero = visible. A bool mask is reinterpreted in place;
    a float mask keeps the reference's "> 0 is visible" meaning."""
    if allowed.device != dev or allowed.shape != (b, w, klen):
        raise ValueError(
            f"decode kernel: allowed must be [{b}, {w}, {klen}] on {dev}, got "
            f"{tuple(allowed.shape)} on {allowed.device}"
        )
    if allowed.dtype == torch.float32:
        allowed = allowed > 0
    if allowed.dtype == torch.bool:
        allowed = allowed.view(torch.uint8)
    if allowed.dtype != torch.uint8:
        raise TypeError(f"decode kernel: allowed is {allowed.dtype}, needs bool, uint8 or float32")
    if not allowed.is_contiguous():
        raise ValueError(f"decode kernel: allowed strides {allowed.stride()} are not contiguous")
    return allowed


def _raise_on(code: int, name: str, lib: ctypes.CDLL) -> None:
    if code:
        msg = lib.ff_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {code})")


def _geometry(name, q, k, v, lengths, tables=None, scales=None, allowed=None):
    """Check the operands every body takes; returns (num_pages,
    page_size, max_len, the mask as the kernels read it or None). k/v are
    the contiguous caches (tables None) or the pools."""
    b, w, h, d = q.shape
    paged, quant = tables is not None, scales is not None
    _check_operands(q, (("k", k), ("v", v)), lengths, tables, quant=quant)
    if v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} shapes differ")
    if paged:
        num_pages, page_size = k.shape[0], k.shape[1]
        if tables.dim() != 2 or tables.shape[0] != b:
            raise ValueError(
                f"{name}: block_tables shape {tuple(tables.shape)} does not have {b} rows"
            )
        max_len = tables.shape[1] * page_size
        if quant:
            _check_scales(*scales, num_pages, h, q.device)
    else:
        num_pages, page_size, max_len = 0, 8, k.shape[1]
        if k.shape[0] != b:
            raise ValueError(f"{name}: caches {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if allowed is not None:
        allowed = _mask_operand(allowed, b, w, max_len, q.device)
    return num_pages, page_size, max_len, allowed


def _launch_tree(name, q, k, v, lengths, sm_scale, tables=None, scales=None, allowed=None):
    """Every decode kernel on the split-KV body of tree_kernel.cu: the
    staircase (allowed None) on the contiguous cache (tables None, #4),
    fp32 pools (#5) and int8 pools (scales given, #6), or the tree mask on
    the same three (#7, #8, #9): check the operands, launch it and count
    the launch. head_dim at most _TREE_MAX_D; the wrappers send wider
    heads to _launch."""
    b, w, h, d = q.shape
    paged, quant, stair = tables is not None, scales is not None, allowed is None
    num_pages, page_size, max_len, allowed = _geometry(name, q, k, v, lengths, tables, scales, allowed)
    if d > _TREE_MAX_D:
        raise ValueError(f"{name}: head_dim {d} > {_TREE_MAX_D}, which the tree kernel's tiles do not take")
    out = torch.empty((b, w, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    lib = _tree_lib()
    span_unit = _QUANT_SPAN_UNIT if quant and stair and w == 1 else _TREE_SPAN_UNIT
    splits, span = pick_splits(b, h, max_len, page_size if paged else 1, _sm_count(q.device.index), span_unit)
    ks, vs = scales if quant else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part_acc = part_ml = counters = None
        if splits > 1:  # the partials: accumulators [b, h, splits, w, d], then (m, l)
            rows = b * h * splits * w
            part = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
            part_acc = part.data_ptr()
            part_ml = part_acc + 4 * rows * d
            counters = _arrival_counters(q.device, stream, b * h).data_ptr()
        code = lib.ff_tree_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs), ptr(tables),
            lengths.data_ptr(), ptr(allowed), out.data_ptr(), part_acc, part_ml, counters,
            int(q.dtype == torch.bfloat16), int(paged), int(quant), int(quant and _int8_vec16(k, v)),
            int(stair), b, w, h, d, max_len, span, splits, page_size, num_pages,
            tables.stride(0) if paged else 0,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            0 if stair else allowed.stride(0), 0 if stair else allowed.stride(1),
            _scale_of(q, sm_scale), stream,
        )
    _raise_on(code, name, lib)
    LAUNCHES[_key(name, q)] += 1
    return out


def _key(name, q):
    """The LAUNCHES key of a launch: bf16 q counts under name + "_bf16"."""
    return name + "_bf16" if q.dtype == torch.bfloat16 else name


def _launch(name, q, k, v, lengths, sm_scale, tables=None, scales=None, allowed=None):
    """Every decode kernel at head_dim > _TREE_MAX_D, on decode_kernel.cu's
    body: check the operands, launch the variant the operands select
    (as _launch_tree) and count it. Every w up to MAX_W at every head_dim
    fits its shared memory (pick_chunk)."""
    b, w, h, d = q.shape
    paged, quant, tree = tables is not None, scales is not None, allowed is not None
    num_pages, page_size, max_len, allowed = _geometry(name, q, k, v, lengths, tables, scales, allowed)
    out = torch.empty((b, w, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    lib = _lib()
    chunk = pick_chunk(w, tree)
    ks, vs = scales if quant else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ff_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
            ptr(tables), lengths.data_ptr(), ptr(allowed), out.data_ptr(),
            int(q.dtype == torch.bfloat16), int(paged), int(quant), int(tree),
            b, w, h, d, max_len, chunk, page_size, num_pages,
            tables.stride(0) if paged else 0,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            allowed.stride(0) if tree else 0, allowed.stride(1) if tree else 0,
            _scale_of(q, sm_scale), stream,
        )
    _raise_on(code, name, lib)
    LAUNCHES[_key(name, q)] += 1
    return out


def _no_kernel(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")


def _body(q):
    """The device body for q's head_dim, by head_dim alone: the split-KV
    body up to _TREE_MAX_D, decode_kernel.cu's past it."""
    return _launch if q.shape[-1] > _TREE_MAX_D else _launch_tree


def flash_verify(q, k_cache, v_cache, lengths, sm_scale=None):
    """w-query flash attention against the contiguous cache with the
    staircase mask. q: [b, w, h, d]; k_cache/v_cache: [b, max_len, h, d];
    lengths: [b] int32. Returns [b, w, h, d] in q's dtype (float32 or
    bfloat16). On the card: the
    split-KV body of tree_kernel.cu at head_dim <= 256 (at w = 1 its
    one-row tile), decode_kernel.cu's body past it, by head_dim alone."""
    if q.device.type == "cpu":
        return flash_verify_ref(q, k_cache, v_cache, lengths, sm_scale)
    _no_kernel("flash_verify", q)
    return _body(q)("flash_verify", q, k_cache, v_cache, lengths, sm_scale)


def flash_decode(q, k_cache, v_cache, lengths, **kw):
    """Single-query flash decode — the w == 1 case of flash_verify."""
    return flash_verify(q, k_cache, v_cache, lengths, **kw)


def paged_flash_verify(q, k_pool, v_pool, block_tables, lengths, sm_scale=None):
    """w-query flash attention that walks the block table. q:
    [b, w, h, d]; k_pool/v_pool: [num_pages, page_size, h, d];
    block_tables: [b, pages_per_seq] int32 (entries outside
    [0, num_pages) are unallocated); lengths: [b] int32. Returns
    [b, w, h, d] in q's dtype. On the card: the split-KV body of
    tree_kernel.cu at head_dim <= 256 (at w = 1 its one-row tile),
    decode_kernel.cu's body past it, by head_dim alone."""
    if q.device.type == "cpu":
        return paged_flash_verify_ref(q, k_pool, v_pool, block_tables, lengths, sm_scale)
    _no_kernel("paged_flash_verify", q)
    return _body(q)("paged_flash_verify", q, k_pool, v_pool, lengths, sm_scale, tables=block_tables)


def paged_flash_decode(q, k_pool, v_pool, block_tables, lengths, **kw):
    """Single-query paged flash decode — the w == 1 case of
    paged_flash_verify."""
    return paged_flash_verify(q, k_pool, v_pool, block_tables, lengths, **kw)


def paged_flash_verify_quant(
    q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, sm_scale=None
):
    """paged_flash_verify over int8 pools [num_pages, page_size, h, d]
    with fp32 per-(page, head) scale side pools k_scale/v_scale
    [num_pages, h]: each page's rows are dequantized inside the page
    walk. head_dim must be a multiple of 8. Returns [b, w, h, d] in q's
    dtype. On the card: the split-KV body of tree_kernel.cu at head_dim
    <= 256 (at w = 1 its int8 one-row tile), decode_kernel.cu's body past
    it, by head_dim alone."""
    if q.device.type == "cpu":
        return paged_flash_verify_quant_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, sm_scale
        )
    _no_kernel("paged_flash_verify_quant", q)
    return _body(q)(
        "paged_flash_verify_quant", q, k_pool, v_pool, lengths, sm_scale,
        tables=block_tables, scales=(k_scale, v_scale),
    )


def paged_flash_decode_quant(q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, **kw):
    """Single-query int8 paged flash decode — the w == 1 case of
    paged_flash_verify_quant."""
    return paged_flash_verify_quant(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, **kw
    )


def flash_verify_tree(q, k_cache, v_cache, lengths, allowed, sm_scale=None):
    """w-query flash attention against the contiguous cache under a
    token-tree mask: allowed [b, w, max_len] (bool, uint8 or float32;
    > 0 = query row j may see the position). Other shapes as
    flash_verify, and the same two bodies on the card."""
    if q.device.type == "cpu":
        return flash_verify_tree_ref(q, k_cache, v_cache, lengths, allowed, sm_scale)
    _no_kernel("flash_verify_tree", q)
    return _body(q)("flash_verify_tree", q, k_cache, v_cache, lengths, sm_scale, allowed=allowed)


def paged_flash_verify_tree(q, k_pool, v_pool, block_tables, lengths, allowed, sm_scale=None):
    """Tree-masked w-query flash attention walking the block table:
    allowed [b, w, pages_per_seq * page_size] over LOGICAL positions.
    Other shapes as paged_flash_verify, and the same two bodies on the
    card."""
    if q.device.type == "cpu":
        return paged_flash_verify_tree_ref(
            q, k_pool, v_pool, block_tables, lengths, allowed, sm_scale
        )
    _no_kernel("paged_flash_verify_tree", q)
    return _body(q)(
        "paged_flash_verify_tree", q, k_pool, v_pool, lengths, sm_scale, tables=block_tables, allowed=allowed
    )


def paged_flash_verify_tree_quant(
    q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, allowed, sm_scale=None
):
    """paged_flash_verify_tree over int8 pools with fp32 per-(page,
    head) scales — #6's dequant and #8's tree mask; head_dim a multiple
    of 8. On the card: the split-KV body of tree_kernel.cu at head_dim
    <= 256, decode_kernel.cu's body past it, by head_dim alone."""
    if q.device.type == "cpu":
        return paged_flash_verify_tree_quant_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, allowed, sm_scale
        )
    _no_kernel("paged_flash_verify_tree_quant", q)
    return _body(q)(
        "paged_flash_verify_tree_quant", q, k_pool, v_pool, lengths, sm_scale,
        tables=block_tables, scales=(k_scale, v_scale), allowed=allowed,
    )
