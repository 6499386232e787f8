"""flexflow_tpu_torch's flash attention (ops/cuda/flash_kernel.py, kernels
#1-#3) against the JAX package's Pallas kernels run in the interpreter,
as tests/test_flash_kernel.py runs them: forward O and LSE, and the
gradients through the custom backward (`jax.grad` runs Pallas kernels #2
and #3), causal and not, sq != sk, and the LSE cotangent. On the CPU the
port's wrappers take their plain versions, so this holds the plain
versions and the autograd Function the card runs against the reference.
Tolerances are the reference's own: forward and LSE 2e-5; gradients atol
5e-5, rtol 5e-4."""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu.ops.pallas.flash_kernel import flash_attention_tpu
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

B, H, D = 2, 2, 32
BLOCK = 128
FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4


def _inputs(sq, sk=None, seed=0):
    rng = np.random.RandomState(seed)
    sk = sk or sq
    return tuple(rng.randn(B, s, H, D).astype(np.float32) for s in (sq, sk, sk))


def _jax_flash(q, k, v, causal, return_lse=False):
    return flash_attention_tpu(
        q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
        return_lse=return_lse, interpret=True,
    )


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_lse_match_jax(causal):
    q, k, v = _inputs(256)
    jo, jlse = _jax_flash(*map(jnp.asarray, (q, k, v)), causal, return_lse=True)
    fk.reset_launches()
    o, lse = fk.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, return_lse=True)
    assert fk.LAUNCHES == dict.fromkeys(fk.LAUNCHES, 0)
    assert o.shape == (B, 256, H, D) and lse.shape == (B, H, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize(
    "sq,sk,causal", [(256, 256, False), (256, 256, True), (128, 384, False), (128, 384, True)]
)
def test_grads_match_jax(sq, sk, causal):
    """Gradients of sum(o * cos(o)) through the port's custom backward vs
    jax.grad through the Pallas kernels; sq != sk keeps the shared-origin
    causal mask (qpos >= kpos)."""
    q, k, v = _inputs(sq, sk, seed=1)

    def jloss(q, k, v):
        o = _jax_flash(q, k, v, causal)
        return jnp.sum(o * jnp.cos(o))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _leaves(q, k, v)
    o = fk.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(_jax_flash(q, k, v, causal)), atol=FWD_TOL, rtol=FWD_TOL)
    (o * torch.cos(o)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_lse_cotangent_matches_jax():
    """The LSE cotangent enters through the delta shift, as in the
    reference's with-lse VJP."""
    q, k, v = _inputs(128, seed=2)

    def jloss(q, k, v):
        o, lse = _jax_flash(q, k, v, False, return_lse=True)
        return jnp.sum(o) + jnp.sum(jnp.sin(lse))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _leaves(q, k, v)
    o, lse = fk.flash_attention(tq, tk, tv, return_lse=True)
    (o.sum() + torch.sin(lse).sum()).backward()
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 256, 320, 512])
def test_wide_heads_match_jax(d, causal):
    """head_dim 160 and 256 (on the card #1 in two output-column chunks,
    #2 and #3 on the wide kernels), 320 and 512 (all three on the wide
    kernels: the score contraction streamed in 128-column pieces, #2 and
    #3 with all of a block's output columns, 512 their widest resident
    fixed tile): forward, LSE and the gradients through the port's custom
    backward against the Pallas kernels in the interpreter."""
    rng = np.random.RandomState(d + int(causal))
    q, k, v = (rng.randn(1, 128, H, d).astype(np.float32) for _ in range(3))
    jo, jlse = _jax_flash(*map(jnp.asarray, (q, k, v)), causal, return_lse=True)

    def jloss(q, k, v):
        o = _jax_flash(q, k, v, causal)
        return jnp.sum(o * jnp.cos(o))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _leaves(q, k, v)
    o, lse = fk.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=FWD_TOL)
    (o * torch.cos(o)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_ATOL, rtol=GRAD_RTOL)


# -- bf16 (mixed precision) ---------------------------------------------------------
# The same checks at bf16 q, k, v against flash_attention_tpu at bf16 in
# the interpreter, whose bodies keep f32 accumulators and LSE and round P
# and dS to bf16 before the second product. The plain versions round P
# under the row's final max, the Pallas body under its running max, so
# with two key blocks a share of O's entries differ by up to 2 bf16 ulps:
# O within atol 5e-3 and rtol 1e-2, LSE (f32 from exact bf16 products)
# within 2e-5. The gradients (dO the bf16 cotangent of an f32 loss) were
# measured on the CPU to differ by at most one bf16 ulp of each gradient's largest
# entry (dV, s = 256, causal: 0.03125 at entries up to 7.2; most cases a
# half or a quarter of it), so they are held within that ulp.
BF16_FWD_ATOL, BF16_FWD_RTOL = 5e-3, 1e-2


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _bf16(*arrays):
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]


def _bf16_leaves(*arrays):
    return [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in arrays]


def _f32(x):
    return np.asarray(x.astype(jnp.float32)) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


def _assert_bf16_grads(ours, ref):
    for t, j in zip(ours, ref):
        assert t.grad.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        want = _f32(j)
        np.testing.assert_allclose(_f32(t.grad), want, atol=_bf16_ulp(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize(
    "sq,sk,causal",
    [(128, 128, False), (128, 128, True), (256, 256, False), (256, 256, True), (128, 384, True), (256, 128, False)],
)
def test_bf16_forward_and_lse_match_jax(sq, sk, causal):
    """One and two key blocks, sq != sk both ways: O in bf16 and LSE in
    f32, through the autograd Function, no kernel launched on the CPU."""
    q, k, v = _inputs(sq, sk, seed=3)
    jo, jlse = _jax_flash(*_bf16(q, k, v), causal, return_lse=True)
    fk.reset_launches()
    o, lse = fk.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal, return_lse=True)
    assert fk.LAUNCHES == dict.fromkeys(fk.LAUNCHES, 0)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32 and jo.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(o), _f32(jo), atol=BF16_FWD_ATOL, rtol=BF16_FWD_RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("d", [24, 136, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_matches_jax_at_any_head_dim(d, causal):
    """The bf16 forward at head_dims the card's wgmma body pads (24 and 136
    to 64-column boxes) or fills (256), at two key blocks: O in bf16 and
    LSE in f32 against the Pallas kernel at bf16, by the bf16 tolerances
    above; the plain version here is what the card's gate holds the
    kernel against."""
    rng = np.random.RandomState(d + 7 * int(causal))
    q = rng.randn(1, 128, H, d).astype(np.float32)
    k, v = (rng.randn(1, 256, H, d).astype(np.float32) for _ in range(2))
    jo, jlse = _jax_flash(*_bf16(q, k, v), causal, return_lse=True)
    fk.reset_launches()
    o, lse = fk.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal, return_lse=True)
    assert fk.LAUNCHES == dict.fromkeys(fk.LAUNCHES, 0)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32 and o.shape == (1, 128, H, d)
    np.testing.assert_allclose(_f32(o), _f32(jo), atol=BF16_FWD_ATOL, rtol=BF16_FWD_RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize(
    "sq,sk,causal", [(128, 128, False), (256, 256, True), (128, 384, True), (256, 128, False)]
)
def test_bf16_grads_match_jax(sq, sk, causal):
    """Gradients of an f32 loss of the bf16 O through the port's custom
    backward (the bf16 plain #2 and #3) vs jax.grad through the Pallas
    kernels at bf16; the gradients come back bf16."""
    q, k, v = _inputs(sq, sk, seed=4)

    def jloss(q, k, v):
        o = _jax_flash(q, k, v, causal).astype(jnp.float32)
        return jnp.sum(o * jnp.cos(o))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*_bf16(q, k, v))
    leaves = _bf16_leaves(q, k, v)
    o = fk.flash_attention(*leaves, causal=causal).float()
    (o * torch.cos(o)).sum().backward()
    _assert_bf16_grads(leaves, jg)


@pytest.mark.parametrize("d", [264, 320, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_wide_heads_match_jax(d, causal):
    """bf16 past head_dim 256 (the bf16 wide bodies on the card):
    the plain versions' O, LSE and gradients against the Pallas kernels
    at bf16 in the interpreter, by the bf16 tolerances above; no kernel
    launched on the CPU."""
    rng = np.random.RandomState(d + int(causal))
    q, k, v = (rng.randn(1, 128, H, d).astype(np.float32) for _ in range(3))
    jo, jlse = _jax_flash(*_bf16(q, k, v), causal, return_lse=True)

    def jloss(q, k, v):
        o = _jax_flash(q, k, v, causal).astype(jnp.float32)
        return jnp.sum(o * jnp.cos(o))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*_bf16(q, k, v))
    fk.reset_launches()
    leaves = _bf16_leaves(q, k, v)
    o, lse = fk.flash_attention(*leaves, causal=causal, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(o), _f32(jo), atol=BF16_FWD_ATOL, rtol=BF16_FWD_RTOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=0)
    of = o.float()
    (of * torch.cos(of)).sum().backward()
    _assert_bf16_grads(leaves, jg)
    assert fk.LAUNCHES == dict.fromkeys(fk.LAUNCHES, 0)


class _Lib:
    """A stand-in for a loaded kernel library: any attribute is its name."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, attr):
        return f"{self.name}.{attr}"


@pytest.mark.parametrize("d", [24, 64, 128, 136, 192, 200, 256, 264, 320, 1032])
@pytest.mark.parametrize("name", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_bf16_bodies_resolve_to_their_libraries(monkeypatch, name, d):
    """bf16 #1-#3 at any head_dim up to 256 (each of the wgmma bodies'
    buckets 64, 128, 192 and 256) are entry points of flash_bf16_kernel.cu,
    and #1 past 256 too (counted as flash_fwd_wide_bf16); #2 and #3 past 256 are
    flash_bwd_kernel.cu's wide kernels for bf16; float32 stays on the
    fp32 files, counted under name + "_wide" past head_dim 128. No
    library is built: the loaders are stand-ins."""
    for loader in ("_lib", "_bwd_lib", "_bf16_lib"):
        monkeypatch.setattr(fk, loader, lambda loader=loader: _Lib(loader))
    wide = d > 256
    key, fn = fk._body(name, torch.bfloat16, d)
    assert key == name + ("_wide_bf16" if wide else "_bf16") and key in fk.LAUNCHES
    if name == "flash_fwd" or not wide:
        assert fn == f"_bf16_lib.ff_{name}_bf16"
    else:
        assert fn == f"_bwd_lib.ff_{name}_wide_bf16"
    fp32_lib = "_lib" if name == "flash_fwd" else "_bwd_lib"
    fp32_key = name + ("_wide" if d > 128 else "")  # fp32: the wide bodies past 128
    assert fk._body(name, torch.float32, d) == (fp32_key, f"{fp32_lib}.ff_{name}_f32") and fp32_key in fk.LAUNCHES


def test_bf16_lse_cotangent_matches_jax():
    """The LSE cotangent shifts the f32 delta at bf16 too."""
    q, k, v = _inputs(256, seed=5)

    def jloss(q, k, v):
        o, lse = _jax_flash(q, k, v, True, return_lse=True)
        return jnp.sum(o.astype(jnp.float32)) + jnp.sum(jnp.sin(lse))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*_bf16(q, k, v))
    leaves = _bf16_leaves(q, k, v)
    o, lse = fk.flash_attention(*leaves, causal=True, return_lse=True)
    (o.float().sum() + torch.sin(lse).sum()).backward()
    _assert_bf16_grads(leaves, jg)


def test_bf16_plain_versions_round_where_the_reference_does():
    """The bf16 plain versions equal the float32 formulas with P and dS
    rounded to bf16 before the second product and the outputs after it;
    delta is summed in f32 from the bf16 dO and O."""
    rng = np.random.RandomState(6)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 40, 2, 16).astype(np.float32)).bfloat16() for _ in range(4))
    scale = 0.25
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float()) / l.transpose(1, 2)).bfloat16()
    got_o, lse = fk.flash_fwd_ref(q, k, v)
    assert torch.equal(got_o, o)
    torch.testing.assert_close(lse, (m + torch.log(l))[..., 0], atol=0, rtol=0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    pn = torch.exp(s - lse[..., None])
    ds = pn * (torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float()) - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), k.float()).bfloat16()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.bfloat16().float(), q.float()).bfloat16()
    dv = torch.einsum("bhqk,bqhd->bkhd", pn.bfloat16().float(), do.float()).bfloat16()
    assert torch.equal(fk.flash_dq_ref(q, k, v, do, lse, delta), dq)
    for a, b in zip(fk.flash_dkv_ref(q, k, v, do, lse, delta), (dk, dv)):
        assert torch.equal(a, b)
    # a float64 call is the exact function the card gate measures against
    o64, _ = fk.flash_fwd_ref(q.double(), k.double(), v.double())
    assert o64.dtype == torch.float64
    torch.testing.assert_close(o64.float(), o.float(), atol=1e-2, rtol=1e-2)


_LOG2E = 1.4426950408889634


def _bf16_rne(x):
    """float32 values rounded to the nearest bf16 (ties to even), as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _wgmma_backward_model(q, k, v, do, lse, delta, causal, scale):
    """float32 numpy model of the rounding points of bf16 #2 and #3's wgmma
    bodies (csrc/flash_bf16_kernel.cu) on bf16 values q, k, v, dO [b, s,
    h, d] (as float32) and LSE, delta [b, h, sq]: S the exact products
    summed in f32; dP the same, from head_dim 128 on per 64-column box,
    the boxes' f32 sums added in f32; P = 2^(c S - L) with the scale
    folded in (c = scale log2(e) and L = LSE log2(e), each rounded to f32,
    and c S - L one fused multiply-add), 0 where masked; dS = P (dP -
    delta) scale in f32; P and dS rounded to bf16 before dQ = dS K, dK =
    dS^T Q and dV = P^T dO, each summed in f32 and rounded to bf16 once."""
    f32, f64 = np.float32, np.float64
    c = f32(f32(scale) * f32(_LOG2E))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(f64), k.astype(f64)).astype(f32)
    dp = np.zeros_like(s)
    for x in range(0, q.shape[-1], 64):
        box = slice(x, x + 64)
        dp = dp + np.einsum("bqhd,bkhd->bhqk", do[..., box].astype(f64), v[..., box].astype(f64)).astype(f32)
    L = (lse.astype(f32) * f32(_LOG2E)).astype(f32)
    p = np.exp2((s.astype(f64) * f64(c) - L[..., None].astype(f64)).astype(f32)).astype(f32)
    if causal:
        p = np.where(np.tril(np.ones(s.shape[-2:], dtype=bool)), p, f32(0))
    ds = ((p * (dp - delta[..., None].astype(f32))).astype(f32) * f32(scale)).astype(f32)
    ds16, p16 = _bf16_rne(ds).astype(f64), _bf16_rne(p).astype(f64)
    dq = np.einsum("bhqk,bkhd->bqhd", ds16, k.astype(f64)).astype(f32)
    dk = np.einsum("bhqk,bqhd->bkhd", ds16, q.astype(f64)).astype(f32)
    dv = np.einsum("bhqk,bqhd->bkhd", p16, do.astype(f64)).astype(f32)
    return _bf16_rne(dq), _bf16_rne(dk), _bf16_rne(dv)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_backward_rounding_model_matches_jax(causal, d):
    """The card's bf16 #2 and #3 round where _wgmma_backward_model says;
    that model, on the inputs and the LSE the JAX package's bf16 forward
    gives, matches the gradients of _dq_kernel and _dkv_kernel (the
    Pallas interpreter at bf16, two 65-row blocks each way) within the
    bf16 gradient gate above: one bf16 ulp of each gradient's largest
    entry. 2 heads of 64 (one box) and of 128 (dP's two box sums added),
    sq = sk = 130."""
    rng = np.random.RandomState(21 + int(causal) + d)
    q, k, v, do = (rng.randn(1, 130, 2, d).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = _bf16(q, k, v, do)
    flash = lambda q, k, v: _jax_flash_blocks(q, k, v, causal, 65)
    jo, pullback = jax.vjp(flash, jq, jk, jv)
    jg = pullback(jdo)
    _, jlse = _jax_flash_blocks(jq, jk, jv, causal, 65, return_lse=True)
    delta = np.einsum("bqhd,bqhd->bhq", _f32(jdo), _f32(jo))
    model = _wgmma_backward_model(*(_f32(a) for a in (jq, jk, jv, jdo)), np.asarray(jlse), delta, causal,
                                  1.0 / math.sqrt(d))
    for got, want in zip(model, jg):
        want = _f32(want)
        np.testing.assert_allclose(got, want, atol=_bf16_ulp(np.abs(want).max()), rtol=0)


def _jax_flash_blocks(q, k, v, causal, block, return_lse=False):
    return flash_attention_tpu(q, k, v, causal=causal, block_q=block, block_k=block, return_lse=return_lse,
                               interpret=True)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/ header the
    source includes, at any depth, so an edited header never loads a
    stale build; system headers (<...>) are not followed."""
    from flexflow_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "kernel.cu").write_text('#include <cuda_runtime.h>\n#include "common.cuh"\nint f();\n')
    (tmp_path / "common.cuh").write_text('#pragma once\n  #  include "inner.cuh"\nint g();\n')
    (tmp_path / "inner.cuh").write_text("int h();\n")
    assert _build.sources_of("kernel.cu") == ["kernel.cu", "common.cuh", "inner.cuh"]
    paths = [_build.library_path("kernel.cu")]
    (tmp_path / "common.cuh").write_text('#pragma once\n  #  include "inner.cuh"\nint g(int);\n')
    paths.append(_build.library_path("kernel.cu"))
    (tmp_path / "inner.cuh").write_text("int h(int);\n")
    paths.append(_build.library_path("kernel.cu"))
    assert len(set(paths)) == 3
    assert all(os.path.basename(p).startswith("libkernel-") for p in paths)
    assert _build.library_path("kernel.cu") == paths[-1]


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_lengths_match_the_dense_core(causal):
    """Lengths no TPU tile divides (sq 100, sk 100 and 37): the port masks
    the ragged tail, so it holds against the dense core there."""
    for sq, sk in ((100, 100), (37, 37)):
        q, k, v = _inputs(sq, sk, seed=3)
        tq, tk, tv = _leaves(q, k, v)
        o = fk.flash_attention(tq, tk, tv, causal=causal)
        (o * torch.cos(o)).sum().backward()
        dq, dk, dv = tq.grad, tk.grad, tv.grad
        rq, rk, rv = _leaves(q, k, v)
        ref = tattn.scaled_dot_product_attention(rq, rk, rv, causal=causal)
        (ref * torch.cos(ref)).sum().backward()
        torch.testing.assert_close(o, ref, atol=FWD_TOL, rtol=FWD_TOL)
        for a, b in ((dq, rq.grad), (dk, rk.grad), (dv, rv.grad)):
            torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_backward_saves_no_score_tensor():
    """The autograd Function keeps (q, k, v, O, LSE) for its backward:
    O(s * d), never a [b, h, sq, sk] tensor."""
    q, k, v = _leaves(*_inputs(64, 96, seed=4))
    o = fk.flash_attention(q, k, v, causal=True)
    shapes = sorted(tuple(t.shape) for t in o.grad_fn.saved_tensors)
    assert shapes == sorted([(B, 64, H, D), (B, 96, H, D), (B, 96, H, D), (B, 64, H, D), (B, H, 64)])


def test_plain_versions_compose_to_the_gradient():
    """flash_dq_ref / flash_dkv_ref from (lse, delta) give autograd's
    gradient of the plain forward, for an arbitrary dO."""
    q, k, v = _leaves(*_inputs(48, 80, seed=5))
    do = torch.from_numpy(np.random.RandomState(6).randn(B, 48, H, D).astype(np.float32))
    o, lse = fk.flash_fwd_ref(q, k, v, causal=True)
    g = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        delta = (do * o).sum(-1).transpose(1, 2)
        dq = fk.flash_dq_ref(q, k, v, do, lse, delta, causal=True)
        dk, dv = fk.flash_dkv_ref(q, k, v, do, lse, delta, causal=True)
    for a, b in zip((dq, dk, dv), g):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert math.isclose(fk._scale(64, None), 0.125)


@pytest.mark.parametrize("use_flash", ["auto", True, False])
@pytest.mark.parametrize("embed,heads", [(64, 4), (320, 2)])
def test_mha_lowering_picks_its_core_by_use_flash_alone(monkeypatch, use_flash, embed, heads):
    """"auto" and True send a CPU tensor through the flash wrapper (its
    plain version) whatever the shape, head_dim 160 included; only False
    runs the dense core. Both agree on the output."""
    from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
    from flexflow_tpu_torch.core.types import DataType, OperatorType
    from flexflow_tpu_torch.ops.registry import LowerCtx, infer_shapes, lower_op

    calls = []
    real = fk.flash_attention
    monkeypatch.setattr(fk, "flash_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    p = {"embed_dim": embed, "num_heads": heads, "bias": False, "causal": True}
    shape = ParallelTensorShape.make((2, 24, embed), DataType.FLOAT)
    _, wshapes = infer_shapes(OperatorType.MULTIHEAD_ATTENTION, [shape] * 3, p)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 24, embed).astype(np.float32))
    ws = [torch.from_numpy(rng.randn(*s.logical_sizes).astype(np.float32) * 0.1) for s in wshapes]
    (out,) = lower_op(OperatorType.MULTIHEAD_ATTENTION, dict(p, use_flash=use_flash))([x] * 3, ws, LowerCtx())
    (dense,) = lower_op(OperatorType.MULTIHEAD_ATTENTION, dict(p, use_flash=False))([x] * 3, ws, LowerCtx())
    assert len(calls) == (0 if use_flash is False else 1)
    torch.testing.assert_close(out, dense, atol=FWD_TOL, rtol=FWD_TOL)


def test_supports():
    assert fk.supports(512, 512, 64, torch.float32)
    assert fk.supports(500, 37, 128, torch.float32)  # ragged lengths are fine
    # past 128 the wide bodies stream the score contraction over head_dim,
    # so any multiple of 8 is taken, as by the reference's supports()
    assert fk.supports(512, 512, 160, torch.float32)
    assert fk.supports(512, 512, 256, torch.float32)
    assert fk.supports(512, 512, 264, torch.float32)
    assert fk.supports(512, 512, 320, torch.float32)
    assert fk.supports(256, 256, 1032, torch.float32)
    assert not fk.supports(512, 512, 60, torch.float32)
    assert not fk.supports(512, 512, 260, torch.float32)
    # bfloat16 (mixed precision) on its own bodies up to head_dim 256 and
    # past it on the wide kernels for bf16: any multiple of 8, as fp32
    assert fk.supports(512, 512, 64, torch.bfloat16)
    assert fk.supports(500, 37, 24, torch.bfloat16)
    assert fk.supports(512, 512, 256, torch.bfloat16)
    assert fk.supports(512, 512, 264, torch.bfloat16)
    assert fk.supports(512, 512, 320, torch.bfloat16)
    assert fk.supports(256, 256, 512, torch.bfloat16)
    assert not fk.supports(512, 512, 260, torch.bfloat16)
    assert not fk.supports(512, 512, 60, torch.bfloat16)
    assert not fk.supports(512, 512, 64, torch.float16)
    assert not fk.supports(0, 512, 64, torch.float32)


def _tf32_rna(x):
    """A plain model of PTX cvt.rna.tf32.f32: round a float32 to a 10-bit
    mantissa, to nearest with ties away from zero. Float32 bits are sign
    and magnitude, so adding half of the 13 dropped bits' range to the
    magnitude and clearing them does exactly that."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split(x):
    """The kernel's split (flash_bwd_kernel.cu split()): big = x toward
    zero in TF32, small = tf32_rna(x - big), so x = big + small to ~2^-21."""
    big = (x.view(torch.int32) & -0x2000).view(torch.float32)
    return big, _tf32_rna(x - big)


def test_tf32_model_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-11 - 2**-20, 1 + 2**-11 + 2**-20])
    want = [1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 1 + 2**-10]
    assert _tf32_rna(x).tolist() == want
    big, small = _tf32_split(x)
    assert big.tolist() == [1.0, 1 + 2**-10, -1.0, 1.0, 1.0]
    assert torch.equal(_tf32_rna(big), big) and torch.equal(_tf32_rna(small), small)


def test_three_tf32_passes_keep_fp32_accuracy_where_one_does_not():
    """Why flash_bwd_kernel.cu takes three TF32 passes per product: with
    its split x = big + small, small_a big_b + big_a small_b + big_a big_b
    (the small terms first, fp32 accumulation, 8-deep k-steps as
    mma.sync's m16n8k8) stays within 1e-6 of a float64 product of
    64 x 64 tiles at the flagship's value scale (unit-normal operands, as
    the training run's q, k, v and dO); one TF32 pass of the operands
    rounded to nearest is off by ~4e-4."""
    rng = np.random.RandomState(11)
    a, b = (torch.from_numpy(rng.randn(64, 64).astype(np.float32)) for _ in range(2))
    exact = a.double() @ b.double()
    (a_big, a_small), (b_big, b_small) = _tf32_split(a), _tf32_split(b)
    a_one, b_one = _tf32_rna(a), _tf32_rna(b)
    three, one = torch.zeros(64, 64), torch.zeros(64, 64)
    for k in range(0, 64, 8):
        ks = slice(k, k + 8)
        three = three + a_small[:, ks] @ b_big[ks]
        three = three + a_big[:, ks] @ b_small[ks]
        three = three + a_big[:, ks] @ b_big[ks]
        one = one + a_one[:, ks] @ b_one[ks]
    rel = lambda c: float((c.double() - exact).abs().max() / exact.abs().max())
    assert rel(three) < 1e-6
    assert rel(one) > 1e-4


def _round_toward_zero(x):
    """float64 -> the float32 next to it toward zero: how the tensor cores
    round an mma's fp32 sum."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def test_fresh_accumulators_stop_the_drift_of_truncating_mma_chains():
    """Why the kernels' long products take fresh accumulators (product_nt's
    kFresh past head_dim 128, #1's accumulate_pv): in a model of
    mma.sync's 3xTF32 passes whose fp32 sums round toward zero, a 64 x 64
    product of depth 256 taken as one chain of 96 mma's drifts to 2.6e-6
    of its largest entry; each 8-deep k-step into a fresh accumulator,
    added in fp32, stays at 2.9e-7."""
    rng = np.random.RandomState(12)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((64, 256), (256, 64)))
    exact = a.double() @ b.double()
    (a_big, a_small), (b_big, b_small) = _tf32_split(a), _tf32_split(b)
    chain, fresh = torch.zeros(64, 64), torch.zeros(64, 64)
    for k in range(0, 256, 8):
        ks = slice(k, k + 8)
        step = torch.zeros(64, 64)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            part = x[:, ks].double() @ y[ks].double()  # exact: 8 products of TF32 values
            chain = _round_toward_zero(chain.double() + part)
            step = _round_toward_zero(step.double() + part)
        fresh = fresh + step
    rel = lambda c: float((c.double() - exact).abs().max() / exact.abs().max())
    assert rel(fresh) < 1e-6
    assert rel(chain) > 5 * rel(fresh)


def _mma_chains(a, b, groups):
    """a b in the model of mma.sync's 3xTF32 passes above: each group of
    8-deep k-steps is one chain into a fresh accumulator whose fp32 sums
    round toward zero, and the groups' results are added in fp32."""
    (a_big, a_small), (b_big, b_small) = _tf32_split(a), _tf32_split(b)
    total = torch.zeros(a.shape[0], b.shape[1])
    for steps in groups:
        acc = torch.zeros_like(total)
        for k in steps:
            ks = slice(8 * k, 8 * k + 8)
            for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                acc = _round_toward_zero(acc.double() + x[:, ks].double() @ y[ks].double())
        total = total + acc
    return total


def test_piece_accumulators_keep_the_wide_score_products_accurate():
    """fp32 #2 and #3's wide body (past head_dim 128) splits each
    128-column piece's k-steps among four warps, each a fresh chain of
    at most 4 k-steps (12 mma's) added in fp32 to its partial, and adds
    the four partials: at head_dim 1032 that stays at 3.5e-7 of the
    largest entry, where one chain of 387 mma's drifts to 8.6e-6."""
    rng = np.random.RandomState(13)
    d = 1032
    dt = d // 8
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((64, d), (d, 64)))
    exact = a.double() @ b.double()
    pieces = _wide_score_chains(a, b.T.contiguous())
    chain = _mma_chains(a, b, [list(range(dt))])
    rel = lambda c: float((c.double() - exact).abs().max() / exact.abs().max())
    assert rel(pieces) < 1e-6
    assert rel(chain) > 5 * rel(pieces)


@pytest.mark.parametrize("d", [8, 64, 128, 136, 248, 256, 264, 320, 512, 1032, 1216, 1224])
def test_fp32_forward_resolves_to_its_wide_body_past_128(monkeypatch, d):
    """fp32 #1 runs flash_kernel.cu at every head_dim, counted as
    flash_fwd up to 128 (the mma bodies) and flash_fwd_wide past it (the
    one wide body, Q resident up to 1216 and streamed past it: the C
    entry point picks between the two). No library is built: the loaders
    are stand-ins."""
    for loader in ("_lib", "_bwd_lib", "_bf16_lib"):
        monkeypatch.setattr(fk, loader, lambda loader=loader: _Lib(loader))
    key, fn = fk._body("flash_fwd", torch.float32, d)
    assert key == ("flash_fwd_wide" if d > 128 else "flash_fwd") and key in fk.LAUNCHES
    assert fn == "_lib.ff_flash_fwd_f32"


_WIDE_ROWS = 32  # flash_kernel.cu's kWRows: query rows of a block, keys of a tile
_WIDE_WARPS = 8  # its consumer warps
_PIECE_STEPS = 16  # 8-column k-steps of a ring piece (128 columns)


def _wide_forward_model(q, k, v, causal, scale):
    """fp32 #1's wide body (flash_kernel.cu flash_fwd_wide_kernel) on one
    head, q [sq, d], k and v [sk, d] float32, in the model of mma.sync's
    3xTF32 passes above: per 32-row query tile and 32-key tile, warp w
    takes k-steps [w ks / 8, (w + 1) ks / 8) of each 128-column piece of
    ks k-steps as one chain into a fresh accumulator, added in fp32 to its
    partial scores; the partials are summed in warp order, the online
    softmax runs in base 2 on the f32 sums, and O = O corr + P V with each
    16 keys' part a fresh chain added in fp32. Returns (O, LSE)."""
    sq, d = q.shape
    sk = k.shape[0]
    dt = d // 8
    log2e = 1.4426950408889634
    o_all, lse_all = torch.zeros(sq, d), torch.zeros(sq)
    for q0 in range(0, sq, _WIDE_ROWS):
        qt = torch.zeros(_WIDE_ROWS, d)
        rows = min(_WIDE_ROWS, sq - q0)
        qt[:rows] = q[q0 : q0 + rows]
        m = torch.full((_WIDE_ROWS,), -1e30)
        l = torch.zeros(_WIDE_ROWS)
        o = torch.zeros(_WIDE_ROWS, d)
        k_end = min(sk, q0 + _WIDE_ROWS) if causal else sk
        for k0 in range(0, k_end, _WIDE_ROWS):
            kt, vt = torch.zeros(_WIDE_ROWS, d), torch.zeros(_WIDE_ROWS, d)
            keys = min(_WIDE_ROWS, sk - k0)
            kt[:keys], vt[:keys] = k[k0 : k0 + keys], v[k0 : k0 + keys]
            s = torch.zeros(_WIDE_ROWS, _WIDE_ROWS)
            for w in range(_WIDE_WARPS):
                groups = []
                for p0 in range(0, dt, _PIECE_STEPS):
                    ks = min(_PIECE_STEPS, dt - p0)
                    groups.append([p0 + i for i in range(w * ks // _WIDE_WARPS, (w + 1) * ks // _WIDE_WARPS)])
                s = s + _mma_chains(qt, kt.T.contiguous(), groups)
            s = s * torch.tensor(scale * log2e, dtype=torch.float32)
            qi = torch.arange(q0, q0 + _WIDE_ROWS)[:, None]
            kj = torch.arange(k0, k0 + _WIDE_ROWS)[None, :]
            ok = (qi < sq) & (kj < sk) & ((qi >= kj) if causal else True)
            mx = torch.where(ok, s, torch.tensor(-1e30)).amax(dim=1)
            m_new = torch.maximum(m, mx)
            corr = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(s - m_new[:, None]), torch.zeros(()))
            m, l = m_new, l * corr + p.sum(dim=1)
            o = o * corr[:, None]
            for half in (0, 1):
                o = o + _mma_chains(p, vt, [[2 * half, 2 * half + 1]])
        lnz = l.clamp_min(1e-30)
        o_all[q0 : q0 + rows] = (o / lnz[:, None])[:rows]
        lse_all[q0 : q0 + rows] = ((m + torch.log2(lnz)) * 0.6931471805599453)[:rows]
    return o_all, lse_all


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [320, 1032])
def test_wide_forward_accumulation_order_matches_float64_and_jax(d, causal):
    """fp32 #1's wide body (past head_dim 128) in its order of
    accumulation: the score product split over 8 warps' pieces of at most
    2 k-steps, each a fresh truncating chain, the partials added in fp32,
    and P V in fresh 16-key chains. Its O and LSE stay within the
    reference's 2e-5 of the float64 function and of the JAX reference's
    _fwd_kernel in the Pallas interpreter, at head_dim 320 (Q resident in
    the kernel) and 1032 (Q streamed, the output in 3 column chunks)."""
    rng = np.random.RandomState(21)
    sq, sk = 128, 256
    q, k, v = (rng.randn(1, s, 1, d).astype(np.float32) for s in (sq, sk, sk))
    scale = 1.0 / math.sqrt(d)
    o, lse = _wide_forward_model(*(torch.from_numpy(x[0, :, 0]) for x in (q, k, v)), causal, scale)
    exact_o, exact_lse = fk.flash_fwd_ref(*(torch.from_numpy(x).double() for x in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), exact_o[0, :, 0].numpy(), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), exact_lse[0, 0].numpy(), atol=FWD_TOL, rtol=0)
    jo, jlse = _jax_flash(*map(jnp.asarray, (q, k, v)), causal, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo)[0, :, 0], atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[0, 0], atol=FWD_TOL, rtol=0)


def _wide_score_chains(a, b):
    """a b^T (a [m, d], b [n, d] float32) as fp32 #2 and #3's wide body
    (flash_bwd_kernel.cu wide_body) sums a score product: warp q of a
    product takes k-steps [q ks / 4, (q + 1) ks / 4) of each 128-column
    ring piece of ks k-steps as a fresh truncating chain added in fp32 to
    its partial, piece by piece, and the pass adds the four warps'
    partials in warp order."""
    steps = a.shape[1] // 8
    quarters = ([], [], [], [])
    for p0 in range(0, steps, _PIECE_STEPS):
        ks = min(_PIECE_STEPS, steps - p0)
        for q in range(4):
            quarters[q].append([p0 + i for i in range(q * ks // 4, (q + 1) * ks // 4)])
    bt = b.T.contiguous()
    total = torch.zeros(a.shape[0], b.shape[0])
    for q in range(4):
        total = total + _mma_chains(a, bt, quarters[q])
    return total


def _wide_backward_model(q, k, v, do, lse, delta, causal, scale):
    """fp32 #2 and #3's wide body on one head (q, dO [sq, d], k, v [sk, d],
    LSE and delta [sq]) in the model of mma.sync's 3xTF32 passes above:
    dQ's block takes S = Q K^T and dP = dO V^T, dK/dV's the transposed
    S^T = K Q^T and dP^T = V dO^T, each by _wide_score_chains; P and dS
    in fp32 (masked entries exactly 0); each output one truncating chain
    over the loop operand's 8-row k-steps, loop tile after loop tile
    (dQ += dS K, dK += dS^T Q, dV += P^T dO). Tiles before a causal
    diagonal add exact zeros, so the chains run over every loop tile.
    Returns (dQ, dK, dV)."""
    sq, sk = q.shape[0], k.shape[0]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]

    def probs(s, dp, ok, ls, de):
        p = torch.where(ok, torch.exp(s * scale - ls), torch.zeros(()))
        return p, p * (dp - de) * scale

    p, ds = probs(_wide_score_chains(q, k), _wide_score_chains(do, v), ok, lse[:, None], delta[:, None])
    dq = _mma_chains(ds, k, [list(range(sk // 8))])
    pt, dst = probs(_wide_score_chains(k, q), _wide_score_chains(v, do), ok.T, lse[None, :], delta[None, :])
    dk = _mma_chains(dst, q, [list(range(sq // 8))])
    dv = _mma_chains(pt, do, [list(range(sq // 8))])
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [320, 1032])
def test_wide_backward_accumulation_order_matches_float64_and_jax(d, causal):
    """fp32 #2 and #3's wide body (past head_dim 128) in its order of
    accumulation: the score products in fresh truncating chains of a
    quarter of a 128-column piece, added in fp32, and dQ, dK and dV each one
    truncating chain over the loop tiles. Its gradients stay within the
    reference's scale (atol 5e-5, rtol 5e-4) of the float64 function on
    the same LSE and delta and of the JAX reference's _dq_kernel and
    _dkv_kernel in the Pallas interpreter, at head_dim 320 (the fixed tile
    resident in the kernel, 3 pieces) and 1032 (streamed, 9 pieces, the
    output in 3 column chunks)."""
    rng = np.random.RandomState(24)
    sq, sk = 128, 256
    q, do = (rng.randn(1, sq, 1, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, sk, 1, d).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fk.flash_fwd_ref(tq, tk, tv, causal)
    delta = (tdo * o).sum(-1).transpose(1, 2).contiguous()
    scale = 1.0 / math.sqrt(d)
    got = _wide_backward_model(tq[0, :, 0], tk[0, :, 0], tv[0, :, 0], tdo[0, :, 0], lse[0, 0], delta[0, 0],
                               causal, scale)
    exact_args = (tq.double(), tk.double(), tv.double(), tdo.double(), lse.double(), delta.double(), causal)
    exact = (fk.flash_dq_ref(*exact_args), *fk.flash_dkv_ref(*exact_args))
    for a, e in zip(got, exact):
        np.testing.assert_allclose(a.numpy(), e[0, :, 0].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    _, vjp = jax.vjp(lambda q, k, v: _jax_flash(q, k, v, causal), *map(jnp.asarray, (q, k, v)))
    for a, j in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(j)[0, :, 0], atol=GRAD_ATOL, rtol=GRAD_RTOL)


_WGMMA_KEYS = 64  # flash_bf16_kernel.cu's Wide::kN: keys of a loop tile
_WGMMA_CHAIN_STEPS = 16  # k16 steps of one fresh score chain (Wide::kChain boxes of 64 columns)


def _wgmma_chains(a, b, chain_steps):
    """a b^T (a [m, d], b [n, d] bf16) in a model of wgmma's bf16 products:
    each k16 step's exact sum is added to an f32 accumulator that rounds
    toward zero; every chain_steps steps (None: never) the chain starts
    afresh in a zeroed accumulator, and the chains are added in f32."""
    total = torch.zeros(a.shape[0], b.shape[0])
    steps = (a.shape[1] + 15) // 16
    per = chain_steps or steps
    for c0 in range(0, steps, per):
        acc = torch.zeros_like(total)
        for st in range(c0, min(c0 + per, steps)):
            ks = slice(16 * st, 16 * st + 16)
            acc = _round_toward_zero(acc.double() + a[:, ks].double() @ b[:, ks].double().T)
        total = total + acc
    return total


def _wide_bf16_forward_model(q, k, v, causal, scale, chain_steps=_WGMMA_CHAIN_STEPS):
    """bf16 #1's wide body (flash_bf16_kernel.cu
    flash_fwd_wide_bf16_wgmma_kernel) on one head, q [sq, d], k and v
    [sk, d] bf16: S of each 64-key tile in fresh chains of 16 k16 steps
    added in f32 (_wgmma_chains), the online softmax in base 2 with the
    scale folded in, P rounded to bf16 for O = O corr + P V, whose k16
    steps add to O rounding toward zero, while l sums the f32 P; O times
    the f32 reciprocal of max(l, 1e-30), rounded to bf16, and LSE in f32.
    Row and column tiling leave each entry's arithmetic alone, so the model
    takes all rows and columns at once. Returns (O bf16, LSE f32)."""
    sq, d = q.shape
    sk = k.shape[0]
    c = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    m = torch.full((sq,), -1e30)
    l, o = torch.zeros(sq), torch.zeros(sq, d)
    for k0 in range(0, sk, _WGMMA_KEYS):
        kt, vt = k[k0 : k0 + _WGMMA_KEYS], v[k0 : k0 + _WGMMA_KEYS]
        s = _wgmma_chains(q, kt, chain_steps)
        qi = torch.arange(sq)[:, None]
        kj = torch.arange(k0, k0 + kt.shape[0])[None, :]
        ok = (qi >= kj) if causal else torch.ones_like(s, dtype=torch.bool)
        m_new = torch.maximum(m, torch.where(ok, s, torch.tensor(-1e30)).amax(dim=1))
        corr = torch.exp2(((m.double() - m_new.double()) * c.double()).float())
        mc = m_new * c
        p = torch.where(ok, torch.exp2((s.double() * c.double() - mc.double()[:, None]).float()), torch.zeros(()))
        m, l = m_new, l * corr + p.sum(dim=1)
        o = o * corr[:, None]
        pb = p.bfloat16().double()
        for st in range(0, kt.shape[0], 16):
            o = _round_toward_zero(o.double() + pb[:, st : st + 16] @ vt[st : st + 16].double())
    lnz = l.clamp_min(1e-30)
    out = (o * (1.0 / lnz)[:, None]).bfloat16()
    lse = (m * c + torch.log2(lnz)) * 0.6931471805599453
    return out, lse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [320, 1032])
def test_wide_bf16_forward_score_chains_match_float64_and_jax(d, causal):
    """bf16 #1's wide body (past head_dim 256) in its order of
    accumulation: S in fresh truncating chains of 16 k16 steps (4 boxes of
    64 columns) added in f32, bf16 P into truncating P V steps. O stays
    within the bf16 tolerances and LSE within the reference's 2e-5 of the
    float64 function of the same bf16 inputs and of the JAX reference's
    _fwd_kernel at bf16 in the Pallas interpreter, at head_dim 320 (20
    k16 steps: chains of 16 and 4) and 1032 (65 steps, 5 chains)."""
    rng = np.random.RandomState(22)
    sq, sk = 128, 256
    q, k, v = (rng.randn(1, s, 1, d).astype(np.float32) for s in (sq, sk, sk))
    bq, bk, bv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    o, lse = _wide_bf16_forward_model(bq[0, :, 0], bk[0, :, 0], bv[0, :, 0], causal, scale)
    exact_o, exact_lse = fk.flash_fwd_ref(bq.double(), bk.double(), bv.double(), causal)
    np.testing.assert_allclose(o.float().numpy(), exact_o[0, :, 0].numpy(), atol=BF16_FWD_ATOL, rtol=BF16_FWD_RTOL)
    np.testing.assert_allclose(lse.numpy(), exact_lse[0, 0].numpy(), atol=FWD_TOL, rtol=0)
    jo, jlse = _jax_flash(*_bf16(q, k, v), causal, return_lse=True)
    np.testing.assert_allclose(o.float().numpy(), _f32(jo)[0, :, 0], atol=BF16_FWD_ATOL, rtol=BF16_FWD_RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[0, 0], atol=FWD_TOL, rtol=0)


def test_fresh_score_chains_drift_less_than_one_chain_at_one_key():
    """Where one key is visible LSE is the scaled score itself, so its
    error is the score chain's truncation alone: at head_dim 1032 (65 k16
    steps) one chain over all of head_dim drifts to 5.1e-6 of the float64
    LSE, the wide body's fresh chains of 16 steps added in f32 stay at
    9.7e-7 (3.4x to 5.6x apart over four seeds)."""
    rng = np.random.RandomState(23)
    d = 1032
    q, k, v = (torch.from_numpy(rng.randn(s, d).astype(np.float32)).bfloat16() for s in (300, 1, 1))
    scale = 1.0 / math.sqrt(d)
    exact = (q.double() @ k.double().T)[:, 0] * scale
    err = {}
    for name, steps in (("fresh", _WGMMA_CHAIN_STEPS), ("one", None)):
        _, lse = _wide_bf16_forward_model(q, k, v, False, scale, chain_steps=steps)
        err[name] = float((lse.double() - exact).abs().max())
    assert err["fresh"] < FWD_TOL
    assert err["one"] > 3 * err["fresh"], err


def test_one_output_chain_over_512_keys_stays_far_inside_the_gradient_gate():
    """The wide kernels' dQ = dS K runs one chain over the keys (no longer
    split into even and odd 8-key steps), as dK and dV always did: over
    512 keys (192 mma's) it drifts to 4.7e-6 of the largest entry, twice
    the even/odd split's and two orders below the gate's rtol of 5e-4."""
    rng = np.random.RandomState(13)
    keys = 512
    ds = torch.from_numpy((0.01 * rng.randn(64, keys)).astype(np.float32))
    k = torch.from_numpy(rng.randn(keys, 64).astype(np.float32))
    exact = ds.double() @ k.double()
    steps = list(range(keys // 8))
    one = _mma_chains(ds, k, [steps])
    even_odd = _mma_chains(ds, k, [steps[0::2]]) + _mma_chains(ds, k, [steps[1::2]])
    rel = lambda c: float((c.double() - exact).abs().max() / exact.abs().max())
    assert rel(one) < 1e-5
    assert rel(one) < 3 * rel(even_odd)


# -- fp32 #2 and #3 up to head_dim 128: the score products on .tf32 wgmma ----------------


def _tf32_wgmma_scores(a, b, small="apart"):
    """a b^T (a [m, d], b [n, d] float32) in 3xTF32 passes as the backward's
    score products take them: the tensor cores read a staged raw operand
    truncated to TF32 (big) and its small copy, (x - big) plus half a
    TF32 ulp, as tf32_rna(x - big) (_tf32_split), and round each k8 step's
    sum into a chain toward zero. small "apart" (the tf32 bodies' .tf32
    wgmma, flash_bwd_kernel.cu issue_tf32_scores): at each k8 step
    small·big and big·small into one chain and big·big into another, both
    fresh at the loop tile's start, added in fp32 once done; "first" (the
    3xTF32 mma.sync body's product_nt): one chain, the small terms of
    every k8 step before the big ones; "chain": one chain, the three
    passes of each k8 step in turn (that body's order before)."""
    (a_big, a_small), (b_big, b_small) = _tf32_split(a), _tf32_split(b)
    big, sm = torch.zeros(a.shape[0], b.shape[0]), torch.zeros(a.shape[0], b.shape[0])
    steps = [slice(k, k + 8) for k in range(0, a.shape[1], 8)]
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big))
    if small == "first":
        order = [(ks, i) for i in (0, 1) for ks in steps] + [(ks, 2) for ks in steps]
    else:
        order = [(ks, i) for ks in steps for i in range(3)]
    for ks, i in order:
        x, y = terms[i]
        part = x[:, ks].double() @ y[:, ks].double().T  # exact: 8 products of TF32 values
        if small == "apart" and i < 2:
            sm = _round_toward_zero(sm.double() + part)
        else:
            big = _round_toward_zero(big.double() + part)
    return big + sm


def _zero_rows(x, rows):
    """x with zero rows appended up to `rows`: the kernels' tiles past a
    length are zero-filled."""
    return torch.cat([x, x.new_zeros(rows - x.shape[0], *x.shape[1:])])


def _tf32_backward_model(q, k, v, do, lse, delta, causal, scale, small="apart", dq_chains=1):
    """fp32 #2 and #3 up to head_dim 64 (flash_bwd_kernel.cu tf32_body) on
    one head, q and dO [sq, d], k and v [sk, d], LSE and delta [sq]: S and
    dP (dQ's block) and S^T and dP^T (dK/dV's) by _tf32_wgmma_scores; P
    and dS in fp32, masked entries exactly 0; the output products in
    3xTF32 passes at each k8 step (_mma_chains: .tf32 wgmma with dS or P
    from registers sums a k8 step as mma.sync does), dQ += dS K, dK +=
    dS^T Q and dV += P^T dO one truncating chain each over the loop tiles'
    8-row steps. dq_chains 2: dQ in two chains, the even and the odd
    8-key steps, added in fp32 at the end (the mma.sync body's). With
    small "chain" and dq_chains 2 this is the order of the 3xTF32 mma.sync
    bodies they replaced. Causal tiles the kernels skip would add exact
    zeros, so the chains run over every step. Returns (dQ, dK, dV)."""
    sq, sk = q.shape[0], k.shape[0]
    sq8, sk8 = 8 * -(-sq // 8), 8 * -(-sk // 8)
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]

    def probs(s, dp, ok, ls, de):
        p = torch.where(ok, torch.exp(s * scale - ls), torch.zeros(()))
        return p, p * (dp - de) * scale

    p, ds = probs(_tf32_wgmma_scores(q, k, small), _tf32_wgmma_scores(do, v, small), ok,
                  lse[:, None], delta[:, None])
    key_steps = list(range(sk8 // 8))
    dq_groups = [key_steps] if dq_chains == 1 else [key_steps[0::2], key_steps[1::2]]
    dq = _mma_chains(_zero_rows(ds.T, sk8).T, _zero_rows(k, sk8), dq_groups)
    pt, dst = probs(_tf32_wgmma_scores(k, q, small), _tf32_wgmma_scores(v, do, small), ok.T,
                    lse[None, :], delta[None, :])
    query_steps = [list(range(sq8 // 8))]
    dk = _mma_chains(_zero_rows(dst.T, sq8).T, _zero_rows(q, sq8), query_steps)
    dv = _mma_chains(_zero_rows(pt.T, sq8).T, _zero_rows(do, sq8), query_steps)
    return dq, dk, dv


def _tf32_case(sq, sk, d, causal, seed):
    """One head's q, k, v, dO (float32 numpy [1, s, 1, d]), the plain
    forward's LSE and delta, the model's gradients and the float64
    function's on the same LSE and delta."""
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(1, sq, 1, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, sk, 1, d).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fk.flash_fwd_ref(tq, tk, tv, causal)
    delta = (tdo * o).sum(-1).transpose(1, 2).contiguous()
    exact_args = (tq.double(), tk.double(), tv.double(), tdo.double(), lse.double(), delta.double(), causal)
    exact = tuple(e[0, :, 0] for e in (fk.flash_dq_ref(*exact_args), *fk.flash_dkv_ref(*exact_args)))
    heads = (tq[0, :, 0], tk[0, :, 0], tv[0, :, 0], tdo[0, :, 0], lse[0, 0], delta[0, 0])
    model = lambda order: _tf32_backward_model(*heads, causal, 1.0 / math.sqrt(d), *order)
    return (q, k, v, do), model, exact


_TF32_DIMS = [8, 24, 64, 72, 128]
# (small, dq_chains) of _tf32_backward_model: the tf32 bodies' order; the
# 3xTF32 mma.sync body's, on which dK/dV runs at head_dim 72-128; and the
# order of the mma.sync bodies before them
_TF32_ORDER, _MMA_ORDER, _OLD_ORDER = ("apart", 1), ("first", 2), ("chain", 2)


def _gradients(model, d):
    """(dQ, dK, dV) in the order of the bodies head_dim d runs on the card:
    dQ on its tf32 body up to 128, dK/dV on theirs up to 64 and on the
    3xTF32 mma.sync body past it."""
    dq = model(_TF32_ORDER)[0]
    dk, dv = model(_TF32_ORDER if d <= 64 else _MMA_ORDER)[1:]
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", _TF32_DIMS)
def test_tf32_backward_order_matches_float64_and_jax(d, causal):
    """fp32 #2 and #3 up to head_dim 128 in the order of accumulation of
    the body each runs (_gradients: the tf32 bodies' score products on
    .tf32 wgmma with the small terms in a chain of their own and their
    output products on wgmma too; dK/dV at 72 and 128 the 3xTF32 mma.sync
    body's, the small terms of every k-step first) stay within the reference's gradient scale (atol 5e-5, rtol
    5e-4) of the float64 function on the same LSE and delta and of the JAX
    reference's _dq_kernel and _dkv_kernel in the Pallas interpreter, at
    each bucket (8, 24: one 32-column box; 64: two; 72, 128: four, 72 with
    a ragged last box), sq != sk both ways."""
    sq, sk = (256, 128) if causal else (128, 256)
    arrays, model, exact = _tf32_case(sq, sk, d, causal, seed=40 + d)
    got = _gradients(model, d)
    for a, e in zip(got, exact):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    q, k, v, do = arrays
    _, vjp = jax.vjp(lambda q, k, v: _jax_flash(q, k, v, causal), *map(jnp.asarray, (q, k, v)))
    for a, j in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(j)[0, :, 0], atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("d", [8, 40, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(77, 100), (100, 77), (1, 65), (65, 1)])
def test_tf32_backward_order_matches_float64_at_ragged_lengths(sq, sk, causal, d):
    """The same order at lengths that are no multiple of a tile or of 8
    (the kernels' rows past sq or sk zero-filled), one query or one key
    included: within the gradient gate of the float64 function."""
    _, model, exact = _tf32_case(sq, sk, d, causal, seed=sq * 1000 + sk + d)
    for a, e in zip(_gradients(model, d), exact):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("d", [24, 32, 40, 64, 72, 128])
def test_new_orders_drift_no_more_than_the_mma_bodies_did(d):
    """The orders the backward runs now (_gradients: the tf32 bodies' score
    products with their small terms in a chain apart from big·big, added
    in fp32, and dQ in one output chain; at 72-128 dK/dV on the mma.sync
    body with the small terms of every k-step first) against the order of
    the 3xTF32 mma.sync bodies before them (the three passes of each
    k-step in turn, one chain; dQ in even and odd chains), on the same
    inputs: over a causal 256 x 256 head, a key seen by 300 queries (where
    dP - delta is the products' error alone) and a query that sees 300
    keys, four seeds each, the worst error of dQ, dK and dV against
    float64, in units of the gradient gate (atol 5e-5 + rtol 5e-4 of the
    entry), is no larger. Measured: 0.21 against 0.21 at 24 (dV's output
    chain, the same in both), 0.27 against 0.51 at 32, 0.33 against 0.72
    at 64, 0.34 against 0.76 at 72 and 0.52 against 1.36 at 128, where the
    old order is over the gate. At head_dim 8 (one k8 step) the orders
    differ by a rounding either way (0.2188 against 0.2164), so the cases
    start at 24."""
    worst = {}
    for name, gradients in (("new", lambda model: _gradients(model, d)), ("old", lambda model: model(_OLD_ORDER))):
        ratios = []
        for sq, sk in ((256, 256), (300, 1), (1, 300)):
            for seed in range(4):
                _, model, exact = _tf32_case(sq, sk, d, True, seed=seed * 7 + d)
                ratios += [float(((a.double() - e).abs() / (GRAD_ATOL + GRAD_RTOL * e.abs())).max())
                           for a, e in zip(gradients(model), exact)]
        worst[name] = max(ratios)
    assert worst["new"] <= worst["old"], worst
    assert worst["new"] < 1.0, worst
