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
    assert fk.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
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
    assert not fk.supports(512, 512, 160, torch.float32)
    assert not fk.supports(512, 512, 60, torch.float32)
    assert not fk.supports(512, 512, 64, torch.bfloat16)
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
