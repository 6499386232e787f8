"""Flash attention forward and backward (port of
flexflow_tpu/ops/pallas/flash_kernel.py, kernels #1-#3 of the family:
`_fwd_kernel`, `_dq_kernel` and `_dkv_kernel`).

The device code is CUDA C++ for Hopper, built on first use by
ops/cuda/_build.py and called through ctypes on PyTorch's current
stream. float32 operands run the forward in
flexflow_tpu_torch/csrc/flash_kernel.cu and the backward in
csrc/flash_bwd_kernel.cu, both with fp32-accurate 3xTF32 products on the
tensor cores (helpers shared in csrc/flash_common.cuh): the backward up
to head_dim 128 on .tf32 wgmma over tiles that TMA loads, each staged
tile split once (dK/dV at head_dim 72-128 on mma.sync); bfloat16
operands (mixed precision) run in csrc/flash_bf16_kernel.cu, one bf16
pass per product with f32 accumulation, the reference's bodies at bf16
inputs: #1, #2 and #3 up to head_dim 256 on wgmma over tiles that TMA
loads (csrc/hopper.cuh; the C entry point encodes the tensor maps per
call), and #1 past it (a resident Q tile, K and V streamed over head_dim
through a ring of cp.async slots). fp32 #1 past head_dim 128 runs
flash_kernel.cu's wide body: the scores once per tile pair over a
resident Q tile, K and V streamed through a TMA ring. #2 and
#3 run csrc/flash_bwd_kernel.cu's wide kernels past head_dim 128 in fp32
and past 256 in bf16: they compute the scores once per tile pair over a
resident fixed tile, the fp32 body streaming the loop operand through a
TMA ring that a producer warpgroup keeps full, the bf16 body through a
ring of 2 slots that all its threads fill (rows widened to fp32 as they
are staged, one exact TF32 pass per product, P and dS rounded to bf16
where the reference casts them):

  * `flash_fwd(q, k, v, causal, sm_scale)` -> (O [b, sq, h, d],
    LSE [b, h, sq] fp32) — kernel #1;
  * `flash_dq(q, k, v, do, lse, delta, ...)` -> dQ — kernel #2;
  * `flash_dkv(q, k, v, do, lse, delta, ...)` -> (dK, dV) — kernel #3.

q, k, v and dO share one dtype, float32 or bfloat16; O, dQ, dK and dV
take it, LSE and delta are float32 either way.

`flash_attention(q, k, v, causal, sm_scale, return_lse)` is the
counterpart of `flash_attention_tpu`: a `torch.autograd.Function` whose
forward runs #1 and saves only (q, k, v, O, LSE), and whose backward
runs #2 and #3 from delta = rowsum(dO * O) - g_lse (the LSE cotangent
shifts delta, as `_flash_with_lse_bwd` does).

Beside each kernel sits its plain PyTorch version (`flash_fwd_ref`,
`flash_dq_ref`, `flash_dkv_ref`) computing the same function from the
same inputs with the same formulas. A wrapper picks by the device of its
input alone: a CPU tensor goes to the plain version, so the CPU runs the
same custom backward as the card; a CUDA tensor launches the kernel or
raises. `LAUNCHES` counts kernel launches per kernel.

Operand layout: the kernels read [b, s, h, d] through its strides with
16-byte loads (and bf16 #1 with TMA, whose tensor maps take the same
strides). An operand whose head_dim is not contiguous, whose other
strides are not multiples of 16 bytes (4 float32 or 8 bfloat16
elements), that repeats itself along a dimension (stride 0 over more
than one element) or whose data is not 16-byte aligned is copied with
`.contiguous()` first; autograd's dO can be such a tensor (an expanded
gradient has stride 0). Outputs are contiguous.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
from torch.autograd.function import once_differentiable

from flexflow_tpu_torch.ops.cuda import _build

SOURCE = "flash_kernel.cu"
BWD_SOURCE = "flash_bwd_kernel.cu"
BF16_SOURCE = "flash_bf16_kernel.cu"

# grid y is batch * heads
_MAX_BATCH_HEADS = 65535

# head_dims past these run each kernel's wide body: fp32 #1-#3 past 128
# (flash_kernel.cu's flash_fwd_wide_kernel, flash_bwd_kernel.cu's wide
# kernels), bf16 past 256 (past flash_bf16_kernel.cu's wgmma bodies)
_MMA_MAX_D = 128
_STAGED_MAX_D = 256

# kernel launches per kernel since the last reset_launches(): the fp32
# bodies under the kernels' names (their wide bodies, past head_dim 128,
# under name + "_wide"), the bf16 bodies under name + "_bf16" and the bf16
# bodies past head_dim 256 under name + "_wide_bf16"
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
    "flash_fwd_wide": 0, "flash_dq_wide": 0, "flash_dkv_wide": 0,
    "flash_fwd_bf16": 0, "flash_dq_bf16": 0, "flash_dkv_bf16": 0,
    "flash_fwd_wide_bf16": 0, "flash_dq_wide_bf16": 0, "flash_dkv_wide_bf16": 0,
}

_MASK = -1e30  # the reference's finite mask fill
_DTYPES = (torch.float32, torch.bfloat16)

_bound: Optional[ctypes.CDLL] = None
_bwd_bound: Optional[ctypes.CDLL] = None
_bf16_bound: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports(sq: int, sk: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this shape: float32 or bfloat16 with
    head_dim any positive multiple of 8, as the reference's supports()
    (past 128 in fp32 the score contraction streams the loop operand over
    head_dim in 128-column pieces, and past 256 in bf16 #2 and #3 do; the
    fixed tile stays resident up to head_dim 512 in #2 and #3 and 1216 in
    fp32 #1, and is streamed beside it past that; bf16 #1 past 256 reads
    every operand in 64-column boxes through one ring, its Q tile resident
    up to head_dim 640 and streamed past it); non-empty sequences. Any
    sequence length works (the ragged tail of a tile is masked)."""
    return dtype in _DTYPES and d > 0 and d % 8 == 0 and sq > 0 and sk > 0


def _lib() -> ctypes.CDLL:
    """The built forward library (#1) with its C signatures declared."""
    global _bound
    if _bound is None:
        lib = _build.load(SOURCE)
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ff_flash_cuda_error_string.argtypes = [I]
        lib.ff_flash_cuda_error_string.restype = ctypes.c_char_p
        lib.ff_flash_occupancy.argtypes = [I, P]
        lib.ff_flash_occupancy.restype = I
        lib.ff_flash_fwd_f32.argtypes = [P] * 5 + [I] * 5 + [L] * 9 + [F, I, P]
        lib.ff_flash_fwd_f32.restype = I
        _bound = lib
    return _bound


def _bwd_lib() -> ctypes.CDLL:
    """The built backward library (#2, #3) with its C signatures declared."""
    global _bwd_bound
    if _bwd_bound is None:
        lib = _build.load(BWD_SOURCE)
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ff_flash_bwd_cuda_error_string.argtypes = [I]
        lib.ff_flash_bwd_cuda_error_string.restype = ctypes.c_char_p
        lib.ff_flash_bwd_occupancy.argtypes = [I, I, P]
        lib.ff_flash_bwd_occupancy.restype = I
        for fn in (lib.ff_flash_dq_f32, lib.ff_flash_dq_wide_bf16):
            fn.argtypes = [P] * 7 + [I] * 5 + [L] * 12 + [F, I, P]
            fn.restype = I
        for fn in (lib.ff_flash_dkv_f32, lib.ff_flash_dkv_wide_bf16):
            fn.argtypes = [P] * 8 + [I] * 5 + [L] * 12 + [F, I, P]
            fn.restype = I
        _bwd_bound = lib
    return _bwd_bound


def _bf16_lib() -> ctypes.CDLL:
    """The built bf16 library (#1, #2, #3) with its C signatures declared."""
    global _bf16_bound
    if _bf16_bound is None:
        lib = _build.load(BF16_SOURCE)
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ff_flash_bf16_cuda_error_string.argtypes = [I]
        lib.ff_flash_bf16_cuda_error_string.restype = ctypes.c_char_p
        lib.ff_flash_bf16_occupancy.argtypes = [I, I, I, P]
        lib.ff_flash_bf16_occupancy.restype = I
        lib.ff_flash_bf16_wide_boxes.argtypes = [I] * 4
        lib.ff_flash_bf16_wide_boxes.restype = I
        lib.ff_flash_fwd_bf16.argtypes = [P] * 5 + [I] * 5 + [L] * 9 + [F, I, P]
        lib.ff_flash_fwd_bf16.restype = I
        lib.ff_flash_dq_bf16.argtypes = [P] * 7 + [I] * 5 + [L] * 12 + [F, I, P]
        lib.ff_flash_dq_bf16.restype = I
        lib.ff_flash_dkv_bf16.argtypes = [P] * 8 + [I] * 5 + [L] * 12 + [F, I, P]
        lib.ff_flash_dkv_bf16.restype = I
        _bf16_bound = lib
    return _bf16_bound


# LAUNCHES names of the bf16 library's kernels -> its kind (0 forward, 1
# dQ, 2 dK/dV)
_BF16_KINDS = {"flash_fwd_bf16": 0, "flash_dq_bf16": 1, "flash_dkv_bf16": 2, "flash_fwd_wide_bf16": 0}


def occupancy(name: str, d: int, boxes: int = 0) -> Dict[str, int]:
    """What one block of kernel `name` (a LAUNCHES key) takes at head_dim
    d on the current card, and how many blocks fit an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor). For
    flash_fwd_wide_bf16, `boxes` picks the instantiation (see
    wide_boxes); 0 takes the one a grid of many waves runs."""
    out = (ctypes.c_int * 5)()
    if name in _BF16_KINDS:
        code = _bf16_lib().ff_flash_bf16_occupancy(_BF16_KINDS[name], d, boxes, out)
    elif name.startswith("flash_fwd"):
        code = _lib().ff_flash_occupancy(d, out)
    else:
        # kinds 0 dQ, 1 dK/dV; 2, 3 the same for bf16 past head_dim 256
        kind = (0 if name.startswith("flash_dq") else 1) + (2 if name.endswith("_bf16") else 0)
        code = _bwd_lib().ff_flash_bwd_occupancy(kind, d, out)
    _raise_on(code, name)
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads", "blocks_per_sm"), out))


def wide_boxes(b: int, h: int, sq: int, d: int) -> int:
    """The 64-column boxes of O that a work tile of bf16 #1's wide body
    (head_dim past 256) takes for q [b, sq, h, d] on the current card:
    the instantiation flash_fwd launches at that shape (0 at head_dims the
    body does not take)."""
    return _bf16_lib().ff_flash_bf16_wide_boxes(b, h, sq, d)


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


# -- plain PyTorch versions ----------------------------------------------------


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or itself when it is float32 or float64 (a float64
    call of a plain version is the exact function, for measuring both
    versions' errors against)."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _scores(q, k, causal, scale):
    """Scaled scores [b, h, sq, sk] in float32 (from bf16 operands, whose
    products f32 holds exactly; float64 for float64) and the visible mask
    (None when every pair is visible). Causal: qpos >= kpos from a shared
    origin."""
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) * scale
    if not causal:
        return s, None
    sq, sk = s.shape[-2:]
    return s, torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 intermediate as the second product's operand: rounded to
    bfloat16 (nearest even, as the reference's astype) and read back in
    float32 when the operands are bfloat16; else itself."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def flash_fwd_ref(q, k, v, causal=False, sm_scale=None):
    """Plain version of kernel #1: (O [b, sq, h, d] in q's dtype, LSE
    [b, h, sq] float32) with masked entries weighing exactly 0,
    O = acc / max(l, 1e-30) and LSE = m + log(max(l, 1e-30)). For bf16,
    P = exp(S - m) is rounded to bf16 before P V (l sums the f32 P), the
    product accumulates in f32 and O is rounded to bf16 after / l."""
    s, valid = _scores(q, k, causal, _scale(q.shape[-1], sm_scale))
    if valid is not None:
        m = s.masked_fill(~valid, _MASK).amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), torch.zeros((), dtype=s.dtype))
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    lse = (m + torch.log(l))[..., 0]
    if q.dtype != torch.bfloat16:
        return torch.einsum("bhqk,bkhd->bqhd", p / l, v), lse
    acc = torch.einsum("bhqk,bkhd->bqhd", _operand(p, q.dtype), v.float())
    return (acc / l.transpose(1, 2)).to(q.dtype), lse


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """p = exp(s - lse) and ds = p * (dO V^T - delta) * scale, [b, h, sq, sk]
    float32, both 0 where masked."""
    s, valid = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    if valid is not None:
        p = torch.where(valid, p, torch.zeros((), dtype=p.dtype))
    dp = torch.einsum("bqhd,bkhd->bhqk", _wide(do), _wide(v))
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_ref(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Plain version of kernel #2: dQ = dS K (for bf16, dS rounded to bf16
    before the product and dQ after it)."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q.shape[-1], sm_scale))
    dq = torch.einsum("bhqk,bkhd->bqhd", _operand(ds, q.dtype), _wide(k))
    return dq.to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Plain version of kernel #3: (dK = dS^T Q, dV = P^T dO); for bf16, P
    and dS rounded to bf16 before the products and dK, dV after them."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q.shape[-1], sm_scale))
    dk = torch.einsum("bhqk,bqhd->bkhd", _operand(ds, q.dtype), _wide(q))
    dv = torch.einsum("bhqk,bqhd->bkhd", _operand(p, q.dtype), _wide(do))
    return dk.to(q.dtype), dv.to(q.dtype)


# -- kernel wrappers -------------------------------------------------------------


def _readable(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernels can read it with 16-byte loads (or a
    TMA tensor map) through its strides, else a contiguous copy."""
    per16 = 16 // t.element_size()
    if (
        t.stride(-1) == 1
        and all(s % per16 == 0 and (s > 0 or n == 1) for s, n in zip(t.stride()[:-1], t.shape[:-1]))
        and t.data_ptr() % 16 == 0
    ):
        return t
    return t.contiguous()


def _check(name, q, k, v, extra=(), rows=()):
    """Raise on what the kernels do not take; returns (b, h, sq, sk, d).
    q, k, v and the `extra` operands share q's dtype, float32 or
    bfloat16; the `rows` operands (LSE, delta) are float32."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [b, s, h, d]")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(
            f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q is {q.dtype}, the kernels take float32 or bfloat16")
    for tname, t in (("k", k), ("v", v)) + tuple(extra) + tuple(rows):
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} on {t.device}, q on {q.device}")
    for tname, t in (("k", k), ("v", v)) + tuple(extra):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}, q is {q.dtype}")
    for tname, t in rows:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} is {t.dtype}, the kernels take float32")
    if not supports(sq, sk, d, q.dtype):
        raise ValueError(f"{name}: head_dim {d} (sq {sq}, sk {sk}) is not taken: it must be a positive multiple of 8")
    if b * h > _MAX_BATCH_HEADS:
        raise ValueError(f"{name}: batch * heads = {b * h} > {_MAX_BATCH_HEADS}")
    return b, h, sq, sk, d


def _strides(*ts):
    out = []
    for t in ts:
        out += [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _raise_on(code: int, name: str) -> None:
    if code:
        if name in _BF16_KINDS:
            msg = _bf16_lib().ff_flash_bf16_cuda_error_string(code).decode()
        elif name.startswith("flash_fwd"):
            msg = _lib().ff_flash_cuda_error_string(code).decode()
        else:
            msg = _bwd_lib().ff_flash_bwd_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {code})")


def _device_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _body(name: str, dtype: torch.dtype, d: int):
    """(LAUNCHES key, C entry point) of kernel `name` for `dtype` at
    head_dim d: bf16 on flash_bf16_kernel.cu's bodies, but #2 and #3 past
    256 on flash_bwd_kernel.cu's wide kernels instantiated for bf16,
    counted under name + "_wide_bf16" past 256; fp32 on flash_kernel.cu
    (#1) and flash_bwd_kernel.cu (#2, #3), whose wide bodies past 128 are
    counted under name + "_wide"."""
    if dtype == torch.bfloat16:
        wide = d > _STAGED_MAX_D
        key = name + ("_wide_bf16" if wide else "_bf16")
        if name == "flash_fwd" or not wide:
            return key, getattr(_bf16_lib(), f"ff_{name}_bf16")
        return key, getattr(_bwd_lib(), f"ff_{name}_wide_bf16")
    lib = _lib() if name == "flash_fwd" else _bwd_lib()
    return name + ("_wide" if d > _MMA_MAX_D else ""), getattr(lib, f"ff_{name}_f32")


def flash_fwd(q, k, v, causal=False, sm_scale=None):
    """Kernel #1. q [b, sq, h, d], k/v [b, sk, h, d] float32 or bfloat16
    -> (O [b, sq, h, d] in q's dtype, LSE [b, h, sq] float32)."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, sm_scale)
    _device_only("flash_fwd", q)
    b, h, sq, sk, d = _check("flash_fwd", q, k, v)
    q, k, v = _readable(q), _readable(k), _readable(v)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0:
        return o, lse
    key, fn = _body("flash_fwd", q.dtype, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, sq, sk, d, *_strides(q, k, v),
            _scale(d, sm_scale), int(causal), stream,
        )
    _raise_on(code, key)
    LAUNCHES[key] += 1
    return o, lse


def _bwd_operands(name, q, k, v, do, lse, delta):
    b, h, sq, sk, d = _check(name, q, k, v, (("do", do),), (("lse", lse), ("delta", delta)))
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} != q {tuple(q.shape)}")
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq):
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} != ({b}, {h}, {sq})")
    ops = [_readable(t) for t in (q, k, v, do)] + [lse.contiguous(), delta.contiguous()]
    return (b, h, sq, sk, d), ops


def flash_dq(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Kernel #2: dQ [b, sq, h, d] in q's dtype from (q, k, v, dO, LSE,
    delta); lse and delta are [b, h, sq] float32."""
    if q.device.type == "cpu":
        return flash_dq_ref(q, k, v, do, lse, delta, causal, sm_scale)
    _device_only("flash_dq", q)
    (b, h, sq, sk, d), (q, k, v, do, lse, delta) = _bwd_operands(
        "flash_dq", q, k, v, do, lse, delta
    )
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or h == 0:
        return dq
    key, fn = _body("flash_dq", q.dtype, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, sk, d, *_strides(q, k, v, do),
            _scale(d, sm_scale), int(causal), stream,
        )
    _raise_on(code, key)
    LAUNCHES[key] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Kernel #3: (dK, dV) [b, sk, h, d] in q's dtype from (q, k, v, dO,
    LSE, delta)."""
    if q.device.type == "cpu":
        return flash_dkv_ref(q, k, v, do, lse, delta, causal, sm_scale)
    _device_only("flash_dkv", q)
    (b, h, sq, sk, d), (q, k, v, do, lse, delta) = _bwd_operands(
        "flash_dkv", q, k, v, do, lse, delta
    )
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if b == 0 or h == 0:
        return dk, dv
    key, fn = _body("flash_dkv", q.dtype, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk, d, *_strides(q, k, v, do),
            _scale(d, sm_scale), int(causal), stream,
        )
    _raise_on(code, key)
    LAUNCHES[key] += 1
    return dk, dv


# -- autograd ------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (O, LSE) through kernel #1; the backward runs #2 and #3
    from the saved (q, k, v, O, LSE) only — no [b, h, s, s] tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        # delta_i = rowsum(dO * O) - g_lse, [b, h, sq], summed in float32
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse
        delta = delta.contiguous()
        dq = flash_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, return_lse=False):
    """Flash attention over q [b, sq, h, d], k/v [b, sk, h, d] (the
    counterpart of flash_attention_tpu). Returns O [b, sq, h, d] and, with
    return_lse, the row log-sum-exp [b, h, sq] float32; both are
    differentiable."""
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), _scale(q.shape[-1], sm_scale))
    return (o, lse) if return_lse else o
