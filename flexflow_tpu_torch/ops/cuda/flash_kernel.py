"""Flash attention forward and backward (port of
flexflow_tpu/ops/pallas/flash_kernel.py, kernels #1-#3 of the family:
`_fwd_kernel`, `_dq_kernel` and `_dkv_kernel`).

The device code is CUDA C++ for Hopper, built on first use by
ops/cuda/_build.py and called through ctypes on PyTorch's current
stream: the forward in flexflow_tpu_torch/csrc/flash_kernel.cu (fp32
FMAs), the backward in csrc/flash_bwd_kernel.cu (fp32-accurate 3xTF32
products on the tensor cores):

  * `flash_fwd(q, k, v, causal, sm_scale)` -> (O [b, sq, h, d],
    LSE [b, h, sq] fp32) — kernel #1;
  * `flash_dq(q, k, v, do, lse, delta, ...)` -> dQ — kernel #2;
  * `flash_dkv(q, k, v, do, lse, delta, ...)` -> (dK, dV) — kernel #3.

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
16-byte loads. An operand whose head_dim is not contiguous, whose other
strides are not multiples of 4 elements or whose data is not 16-byte
aligned is copied with `.contiguous()` first; autograd's dO can be such
a tensor (an expanded gradient has stride 0). Outputs are contiguous.
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

MAX_HEAD_DIM = 128
# grid y is batch * heads
_MAX_BATCH_HEADS = 65535

# kernel launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

_MASK = -1e30  # the reference's finite mask fill

_bound: Optional[ctypes.CDLL] = None
_bwd_bound: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports(sq: int, sk: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this shape: fp32, head_dim a multiple of 8
    up to 128, non-empty sequences. Any sequence length works (the ragged
    tail of a tile is masked)."""
    return (
        dtype == torch.float32
        and d % 8 == 0
        and 0 < d <= MAX_HEAD_DIM
        and sq > 0
        and sk > 0
    )


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
        lib.ff_flash_dq_f32.argtypes = [P] * 7 + [I] * 5 + [L] * 12 + [F, I, P]
        lib.ff_flash_dq_f32.restype = I
        lib.ff_flash_dkv_f32.argtypes = [P] * 8 + [I] * 5 + [L] * 12 + [F, I, P]
        lib.ff_flash_dkv_f32.restype = I
        _bwd_bound = lib
    return _bwd_bound


def occupancy(name: str, d: int) -> Dict[str, int]:
    """What one block of kernel `name` ("flash_fwd", "flash_dq" or
    "flash_dkv") takes at head_dim d on the current card, and how many
    blocks fit an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * 5)()
    if name == "flash_fwd":
        code = _lib().ff_flash_occupancy(d, out)
    else:
        code = _bwd_lib().ff_flash_bwd_occupancy(0 if name == "flash_dq" else 1, d, out)
    _raise_on(code, name)
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads", "blocks_per_sm"), out))


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


# -- plain PyTorch versions ----------------------------------------------------


def _scores(q, k, causal, scale):
    """Scaled scores [b, h, sq, sk] and the visible mask (None when every
    pair is visible). Causal: qpos >= kpos from a shared origin."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if not causal:
        return s, None
    sq, sk = s.shape[-2:]
    return s, torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()


def flash_fwd_ref(q, k, v, causal=False, sm_scale=None):
    """Plain version of kernel #1: (O [b, sq, h, d], LSE [b, h, sq] fp32)
    with masked entries weighing exactly 0, O = acc / max(l, 1e-30) and
    LSE = m + log(max(l, 1e-30))."""
    s, valid = _scores(q, k, causal, _scale(q.shape[-1], sm_scale))
    if valid is not None:
        m = s.masked_fill(~valid, _MASK).amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), torch.zeros((), dtype=s.dtype))
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v)
    return o, (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """p = exp(s - lse) and ds = p * (dO V^T - delta) * scale, [b, h, sq, sk],
    both 0 where masked."""
    s, valid = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    if valid is not None:
        p = torch.where(valid, p, torch.zeros((), dtype=p.dtype))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_ref(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Plain version of kernel #2: dQ = dS K."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q.shape[-1], sm_scale))
    return torch.einsum("bhqk,bkhd->bqhd", ds, k)


def flash_dkv_ref(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Plain version of kernel #3: (dK = dS^T Q, dV = P^T dO)."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q.shape[-1], sm_scale))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dk, dv


# -- kernel wrappers -------------------------------------------------------------


def _readable(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernels can read it with 16-byte loads through
    its strides, else a contiguous copy."""
    if (
        t.stride(-1) == 1
        and all(s % 4 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    ):
        return t
    return t.contiguous()


def _check(name, q, k, v, extra=()):
    """Raise on what the kernels do not take; returns (b, h, sq, sk, d)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [b, s, h, d]")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(
            f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    for tname, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} is {t.dtype}, the kernels take float32")
    if not supports(sq, sk, d, q.dtype):
        raise ValueError(
            f"{name}: head_dim {d} (sq {sq}, sk {sk}) is not taken: it must be "
            f"a multiple of 8 up to {MAX_HEAD_DIM}"
        )
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
        if name == "flash_fwd":
            msg = _lib().ff_flash_cuda_error_string(code).decode()
        else:
            msg = _bwd_lib().ff_flash_bwd_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {code})")


def _device_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def flash_fwd(q, k, v, causal=False, sm_scale=None):
    """Kernel #1. q [b, sq, h, d], k/v [b, sk, h, d] float32 -> (O
    [b, sq, h, d], LSE [b, h, sq] float32)."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, sm_scale)
    _device_only("flash_fwd", q)
    b, h, sq, sk, d = _check("flash_fwd", q, k, v)
    q, k, v = _readable(q), _readable(k), _readable(v)
    o = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0:
        return o, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _lib().ff_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, sq, sk, d, *_strides(q, k, v),
            _scale(d, sm_scale), int(causal), stream,
        )
    _raise_on(code, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_operands(name, q, k, v, do, lse, delta):
    b, h, sq, sk, d = _check(name, q, k, v, (("do", do), ("lse", lse), ("delta", delta)))
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} != q {tuple(q.shape)}")
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq):
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} != ({b}, {h}, {sq})")
    ops = [_readable(t) for t in (q, k, v, do)] + [lse.contiguous(), delta.contiguous()]
    return (b, h, sq, sk, d), ops


def flash_dq(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Kernel #2: dQ [b, sq, h, d] from (q, k, v, dO, LSE, delta); lse and
    delta are [b, h, sq] float32."""
    if q.device.type == "cpu":
        return flash_dq_ref(q, k, v, do, lse, delta, causal, sm_scale)
    _device_only("flash_dq", q)
    (b, h, sq, sk, d), (q, k, v, do, lse, delta) = _bwd_operands(
        "flash_dq", q, k, v, do, lse, delta
    )
    dq = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0:
        return dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _bwd_lib().ff_flash_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, sk, d, *_strides(q, k, v, do),
            _scale(d, sm_scale), int(causal), stream,
        )
    _raise_on(code, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """Kernel #3: (dK, dV) [b, sk, h, d] from (q, k, v, dO, LSE, delta)."""
    if q.device.type == "cpu":
        return flash_dkv_ref(q, k, v, do, lse, delta, causal, sm_scale)
    _device_only("flash_dkv", q)
    (b, h, sq, sk, d), (q, k, v, do, lse, delta) = _bwd_operands(
        "flash_dkv", q, k, v, do, lse, delta
    )
    dk = torch.empty((b, sk, h, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if b == 0 or h == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _bwd_lib().ff_flash_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk, d, *_strides(q, k, v, do),
            _scale(d, sm_scale), int(causal), stream,
        )
    _raise_on(code, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
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
        # delta_i = rowsum(dO * O) - g_lse, [b, h, sq]
        delta = (do * o).sum(dim=-1).transpose(1, 2)
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
