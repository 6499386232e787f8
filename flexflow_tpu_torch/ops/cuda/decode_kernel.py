"""Flash-decode kernels against the serving KV cache (port of
flexflow_tpu/ops/pallas/decode_kernel.py, kernels #4 and #5 of the
family: `_decode_kernel` and `_paged_kernel`).

The device code is CUDA C++ for Hopper in flexflow_tpu_torch/csrc/
decode_kernel.cu, built on first use by ops/cuda/_build.py and called
through ctypes on PyTorch's current stream. Two entry points share one
device body, as the JAX family does:

  * `flash_verify(q, k_cache, v_cache, lengths)` — w queries per
    sequence against the contiguous cache [b, max_len, h, d] under the
    staircase mask key_pos <= lengths[b] + j; `flash_decode` is its
    w == 1 case (ops/attention.decode_attention's semantics).
  * `paged_flash_verify(q, k_pool, v_pool, block_tables, lengths)` —
    the same over pools [num_pages, page_size, h, d] walked through the
    block table; `paged_flash_decode` is its w == 1 case. Positions on
    sentinel pages (table entries outside [0, num_pages)) contribute
    nothing, and a row that sees no allocated page returns zeros.

Beside each kernel sits its plain PyTorch version (`flash_verify_ref`,
`paged_flash_verify_ref`) computing the same function. A wrapper picks
by the device of its input alone: a CPU tensor goes to the plain
version, a CUDA tensor launches the kernel or raises. `LAUNCHES` counts
kernel launches per entry point, so a run can show that its decode
steps went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from flexflow_tpu_torch.ops.cuda import _build

SOURCE = "decode_kernel.cu"

# query rows per sequence the kernels take (the reference's _MAX_W)
MAX_W = 64

# kernel launches per entry point since the last reset_launches()
LAUNCHES: Dict[str, int] = {"flash_verify": 0, "paged_flash_verify": 0}

# chunk rows staged per loop iteration are capped here and by the
# shared-memory budget below; one block runs per SM at the serving grid
# (b * h blocks), so a block may take most of the SM's shared memory
_MAX_CHUNK = 256
_SMEM_BUDGET = 160 * 1024

_MASK = -1e30  # the reference's finite mask fill

_bound: Optional[ctypes.CDLL] = None


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
        lib.ff_flash_verify_f32.argtypes = (
            [P] * 5 + [I] * 6 + [L] * 9 + [F, P]
        )
        lib.ff_flash_verify_f32.restype = I
        lib.ff_paged_flash_verify_f32.argtypes = (
            [P] * 6 + [I] * 8 + [L] * 10 + [F, P]
        )
        lib.ff_paged_flash_verify_f32.restype = I
        _bound = lib
    return _bound


@functools.lru_cache(maxsize=None)
def pick_chunk(w: int, d: int, unit: int) -> int:
    """Rows staged per loop iteration: the largest multiple of `unit`
    (the page size on the paged layout) up to _MAX_CHUNK whose staging
    buffers fit the shared-memory budget."""
    lib = _lib()
    budget = min(_SMEM_BUDGET, lib.ff_decode_smem_limit())
    best = 0
    chunk = unit
    while chunk <= max(unit, _MAX_CHUNK):
        if lib.ff_decode_smem_bytes(w, d, chunk) > budget:
            break
        best = chunk
        chunk += unit
    if not best:
        raise ValueError(
            f"decode kernel: w={w}, head_dim={d}, unit {unit} rows does not "
            f"fit {budget} bytes of shared memory"
        )
    return best


# -- plain PyTorch versions ----------------------------------------------------


def _masked_attention(q, k, v, allowed, sm_scale):
    """q [b, w, h, d]; k/v [b, L, h, d]; allowed [b, w, L] bool. The
    kernels' function: masked entries weigh exactly 0 and a row with no
    allowed key returns 0 (acc / max(l, 1e-30))."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    mask = allowed[:, None, :, :]
    m = s.masked_fill(~mask, _MASK).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), dtype=s.dtype))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p / l, v)


def _staircase(lengths, w, klen):
    """[b, w, klen]: query j of sequence i sees positions <= lengths[i] + j."""
    kpos = torch.arange(klen, device=lengths.device)
    qoff = torch.arange(w, device=lengths.device)
    return kpos[None, None, :] <= (lengths.long()[:, None, None] + qoff[None, :, None])


def flash_verify_ref(q, k_cache, v_cache, lengths, sm_scale=None):
    """Plain version of flash_verify: staircase-masked attention of q
    [b, w, h, d] against k/v [b, max_len, h, d]. Returns [b, w, h, d]."""
    b, w, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    allowed = _staircase(lengths, w, k_cache.shape[1])
    return _masked_attention(q, k_cache, v_cache, allowed, scale)


def paged_flash_verify_ref(q, k_pool, v_pool, block_tables, lengths, sm_scale=None):
    """Plain version of paged_flash_verify: gathers each sequence's pages
    into a contiguous view and masks positions on sentinel pages as well
    as past the staircase."""
    b, w, h, d = q.shape
    num_pages, page_size = k_pool.shape[0], k_pool.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    tbl = block_tables.long()
    real = (tbl >= 0) & (tbl < num_pages)
    safe = tbl.clamp(0, num_pages - 1)
    k = k_pool[safe].reshape(b, -1, h, d)
    v = v_pool[safe].reshape(b, -1, h, d)
    on_page = real.repeat_interleave(page_size, dim=1)  # [b, L]
    allowed = _staircase(lengths, w, k.shape[1]) & on_page[:, None, :]
    return _masked_attention(q, k, v, allowed, scale)


# -- kernel wrappers -------------------------------------------------------------


def _check_operands(q, caches, lengths, tables=None):
    """Raise on anything the kernel does not take: it reads fp32 through
    16-byte loads with head_dim contiguous, int32 lengths/tables."""
    dev = q.device
    b, w, h, d = q.shape
    if not 1 <= w <= MAX_W:
        raise ValueError(f"decode kernel: w={w} outside [1, {MAX_W}]")
    if d % 4:
        raise ValueError(f"decode kernel: head_dim {d} is not a multiple of 4")
    for name, t in (("q", q),) + caches:
        if t.device != dev:
            raise ValueError(f"decode kernel: {name} on {t.device}, q on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"decode kernel: {name} is {t.dtype}, needs float32")
        if t.dim() != 4 or t.shape[2:] != (h, d):
            raise ValueError(
                f"decode kernel: {name} shape {tuple(t.shape)} does not end "
                f"in (heads, head_dim) = ({h}, {d})"
            )
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]):
            raise ValueError(
                f"decode kernel: {name} strides {t.stride()} are not "
                "16-byte aligned with head_dim contiguous"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"decode kernel: {name} is not 16-byte aligned")
    ints = (("lengths", lengths),) + ((("block_tables", tables),) if tables is not None else ())
    for name, t in ints:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"decode kernel: {name} must be a contiguous int32 tensor "
                f"on {dev}, got {t.dtype} on {t.device}"
            )
    if lengths.shape != (b,):
        raise ValueError(f"decode kernel: lengths shape {tuple(lengths.shape)} != ({b},)")


def _raise_on(code: int, name: str) -> None:
    if code:
        msg = _lib().ff_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {code})")


def flash_verify(q, k_cache, v_cache, lengths, sm_scale=None):
    """w-query flash attention against the contiguous cache with the
    staircase mask. q: [b, w, h, d]; k_cache/v_cache: [b, max_len, h, d];
    lengths: [b] int32. Returns [b, w, h, d] float32."""
    if q.device.type == "cpu":
        return flash_verify_ref(q, k_cache, v_cache, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_verify: no kernel for device {q.device}")
    _check_operands(q, (("k_cache", k_cache), ("v_cache", v_cache)), lengths)
    b, w, h, d = q.shape
    max_len = k_cache.shape[1]
    if k_cache.shape[0] != b or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"flash_verify: caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, w, h, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lib = _lib()
    chunk = pick_chunk(w, d, 8)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ff_flash_verify_f32(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            b, w, h, d, max_len, chunk,
            q.stride(0), q.stride(1), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            scale, stream,
        )
    _raise_on(code, "flash_verify")
    LAUNCHES["flash_verify"] += 1
    return out


def flash_decode(q, k_cache, v_cache, lengths, **kw):
    """Single-query flash decode — the w == 1 case of flash_verify."""
    return flash_verify(q, k_cache, v_cache, lengths, **kw)


def paged_flash_verify(q, k_pool, v_pool, block_tables, lengths, sm_scale=None):
    """w-query flash attention that walks the block table. q:
    [b, w, h, d]; k_pool/v_pool: [num_pages, page_size, h, d];
    block_tables: [b, pages_per_seq] int32 (entries outside
    [0, num_pages) are unallocated); lengths: [b] int32. Returns
    [b, w, h, d] float32."""
    if q.device.type == "cpu":
        return paged_flash_verify_ref(
            q, k_pool, v_pool, block_tables, lengths, sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_verify: no kernel for device {q.device}")
    _check_operands(
        q, (("k_pool", k_pool), ("v_pool", v_pool)), lengths, block_tables
    )
    b, w, h, d = q.shape
    num_pages, page_size = k_pool.shape[0], k_pool.shape[1]
    if v_pool.shape != k_pool.shape:
        raise ValueError("paged_flash_verify: k_pool and v_pool shapes differ")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"paged_flash_verify: block_tables shape {tuple(block_tables.shape)} "
            f"does not have {b} rows"
        )
    pages_per_seq = block_tables.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, w, h, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lib = _lib()
    chunk = pick_chunk(w, d, page_size)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ff_paged_flash_verify_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, w, h, d, num_pages, page_size, pages_per_seq, chunk,
            block_tables.stride(0),
            q.stride(0), q.stride(1), q.stride(2),
            k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
            v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
            scale, stream,
        )
    _raise_on(code, "paged_flash_verify")
    LAUNCHES["paged_flash_verify"] += 1
    return out


def paged_flash_decode(q, k_pool, v_pool, block_tables, lengths, **kw):
    """Single-query paged flash decode — the w == 1 case of
    paged_flash_verify."""
    return paged_flash_verify(q, k_pool, v_pool, block_tables, lengths, **kw)
