"""flexflow_tpu_torch decode kernels (ops/cuda/decode_kernel.py): the
plain PyTorch versions the wrappers take for CPU tensors against the JAX
package's Pallas kernels (interpret mode) and its dense attention paths,
and the wrappers' device dispatch and operand checks. The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: atol 1e-5 for fp32 attention at these sizes; the two sides
differ only in summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.ops.attention import (
    decode_attention as jax_decode_attention,
    paged_decode_attention as jax_paged_decode_attention,
    paged_verify_attention as jax_paged_verify_attention,
    verify_attention as jax_verify_attention,
)
from flexflow_tpu.ops.pallas import decode_kernel as jdk
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

ATOL = 1e-5


def _contig(rng, b, w, h, d, max_len, lengths):
    q = rng.standard_normal((b, w, h, d)).astype(np.float32)
    k = rng.standard_normal((b, max_len, h, d)).astype(np.float32)
    v = rng.standard_normal((b, max_len, h, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, dtype=np.int32)


def _paged(rng, b, w, h, d, page, num_pages, lengths, hole=False):
    """Pools + shuffled block tables: each row's visible prefix is
    allocated (the engine invariant), sentinels past it; `hole` puts a
    sentinel inside row 1's visible range."""
    max_pages = 64 // page
    q = rng.standard_normal((b, w, h, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page, h, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, h, d)).astype(np.float32)
    tbl = np.full((b, max_pages), num_pages, dtype=np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, ln in enumerate(lengths):
        need = -(-(int(ln) + w) // page)
        tbl[i, :need] = perm[used:used + need]
        used += need
    if hole:
        tbl[1, 0] = num_pages
    return q, kp, vp, tbl, np.asarray(lengths, dtype=np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("w", [1, 5])
def test_flash_verify_plain_matches_jax(w):
    """Contiguous cache: the plain version against the Pallas kernel
    (interpret mode) and the dense verify path, lengths 0 / mid /
    max_len - w."""
    rng = np.random.default_rng(0)
    q, k, v, lens = _contig(rng, 3, w, 2, 16, 64, [0, 17, 64 - w])
    ours = dk.flash_verify(*_t(q, k, v, lens)).numpy()
    kern = np.asarray(jdk.flash_verify(*map(jnp.asarray, (q, k, v, lens)), interpret=True))
    dense = np.asarray(jax_verify_attention(*map(jnp.asarray, (q, k, v, lens))))
    np.testing.assert_allclose(ours, kern, atol=ATOL)
    np.testing.assert_allclose(ours, dense, atol=ATOL)
    if w == 1:
        dec = tattn.decode_attention(*_t(q, k, v, lens)).numpy()
        ref = np.asarray(jax_decode_attention(*map(jnp.asarray, (q, k, v, lens))))
        np.testing.assert_allclose(dec, ref, atol=ATOL)


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_flash_verify_plain_matches_jax(w, page):
    """Paged cache with sentinel-padded tables: the plain version equals
    the Pallas kernel on every row (dead rows give 0 in both) and the
    dense gather path on live rows."""
    rng = np.random.default_rng(1)
    lengths = [0, page, 64 - w, 9]
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, page, 32, lengths)
    tbl[3, :] = 32  # a dead row: every page a sentinel
    ours = dk.paged_flash_verify(*_t(q, kp, vp, tbl, lens)).numpy()
    args = list(map(jnp.asarray, (q, kp, vp, tbl, lens)))
    kern = np.asarray(jdk.paged_flash_verify(*args, interpret=True))
    dense = np.asarray(jax_paged_verify_attention(*args))
    np.testing.assert_allclose(ours, kern, atol=ATOL)
    np.testing.assert_allclose(ours[3], 0.0)
    np.testing.assert_allclose(ours[:3], dense[:3], atol=ATOL)
    if w == 1:
        dec = tattn.paged_decode_attention(*_t(q, kp, vp, tbl, lens)).numpy()
        ref = np.asarray(jax_paged_decode_attention(*args))
        np.testing.assert_allclose(dec[:3], ref[:3], atol=ATOL)


def test_paged_plain_skips_sentinel_holes():
    """A sentinel inside the visible range removes exactly that page's
    positions, as the Pallas kernel's table check does."""
    rng = np.random.default_rng(2)
    q, kp, vp, tbl, lens = _paged(rng, 2, 5, 2, 16, 8, 16, [3, 20], hole=True)
    ours = dk.paged_flash_verify(*_t(q, kp, vp, tbl, lens)).numpy()
    kern = np.asarray(
        jdk.paged_flash_verify(*map(jnp.asarray, (q, kp, vp, tbl, lens)), interpret=True)
    )
    np.testing.assert_allclose(ours, kern, atol=ATOL)


def test_paged_plain_ignores_pages_outside_tables():
    """Scribbling over every pool page no table maps leaves the output
    unchanged."""
    rng = np.random.default_rng(3)
    q, kp, vp, tbl, lens = _paged(rng, 2, 4, 2, 16, 8, 16, [3, 11])
    base = dk.paged_flash_verify(*_t(q, kp, vp, tbl, lens))
    dead = [p for p in range(16) if p not in set(tbl.ravel().tolist())]
    kp[dead], vp[dead] = 1e6, -1e6
    again = dk.paged_flash_verify(*_t(q, kp, vp, tbl, lens))
    torch.testing.assert_close(again, base, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(4)
    q, k, v, lens = _contig(rng, 2, 1, 2, 16, 32, [3, 9])
    dk.reset_launches()
    out = dk.flash_decode(*_t(q, k, v, lens))
    torch.testing.assert_close(out, dk.flash_verify_ref(*_t(q, k, v, lens)))
    assert dk.LAUNCHES == {"flash_verify": 0, "paged_flash_verify": 0}


def test_kernel_operand_checks():
    """What the CUDA path rejects before any launch: the checks run on
    shapes, dtypes and strides, so they are exercised on CPU tensors."""
    rng = np.random.default_rng(5)
    q, k, v, lens = _t(*_contig(rng, 2, 1, 2, 16, 32, [3, 9]))
    caches = (("k", k), ("v", v))
    dk._check_operands(q, caches, lens)  # accepted
    with pytest.raises(TypeError):
        dk._check_operands(q.double(), caches, lens)
    with pytest.raises(ValueError, match="w="):
        dk._check_operands(torch.zeros(2, dk.MAX_W + 1, 2, 16), caches, lens)
    with pytest.raises(ValueError, match="multiple of 4"):
        dk._check_operands(q[..., :14], (("k", k[..., :14]), ("v", v[..., :14])), lens)
    with pytest.raises(ValueError, match="strides"):
        dk._check_operands(q, (("k", k.transpose(2, 3).contiguous().transpose(2, 3)), ("v", v)), lens)
    with pytest.raises(ValueError, match="int32"):
        dk._check_operands(q, caches, lens.long())
    with pytest.raises(ValueError, match="heads"):
        dk._check_operands(q, (("k", k[:, :, :1]), ("v", v)), lens)


def test_unknown_device_raises():
    q = torch.zeros(1, 1, 1, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dk.flash_verify(q, q, q, torch.zeros(1, dtype=torch.int32, device="meta"))

