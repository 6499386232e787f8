"""flexflow_tpu_torch decode kernels (ops/cuda/decode_kernel.py, #4-#9):
the plain PyTorch versions the wrappers take for CPU tensors against the
JAX package's Pallas kernels (interpret mode; its int8 kernels only at
32-row pages) and its dense attention paths (int8 at 8- and 16-row
pages, token trees), and the wrappers' device dispatch and operand
checks. The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: atol 1e-5 for fp32 attention at these sizes; the two sides
differ only in summation order. At bf16 q (a mixed-precision model's
projections) both sides round that f32 result to bf16 once: one bf16 ulp
of each entry (BF16_NOISE below it)."""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.ops.attention import (
    decode_attention as jax_decode_attention,
    paged_decode_attention as jax_paged_decode_attention,
    paged_verify_attention as jax_paged_verify_attention,
    tree_allowed_mask as jax_tree_allowed_mask,
    verify_attention as jax_verify_attention,
)
from flexflow_tpu.ops.pallas import decode_kernel as jdk
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
from test_torch_flash_kernel import _round_toward_zero, _tf32_split

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU models of the kernels' arithmetic below run thousands of
    small torch ops; where test processes share the cores, intra-op
    threads wait at each op's barrier for threads that are not running,
    so this module's ops run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    assert dk.LAUNCHES == dict.fromkeys(dk.LAUNCHES, 0) and "flash_verify" in dk.LAUNCHES


def test_kernel_operand_checks():
    """What the CUDA path rejects before any launch: the checks run on
    shapes, dtypes and strides, so they are exercised on CPU tensors."""
    rng = np.random.default_rng(5)
    q, k, v, lens = _t(*_contig(rng, 2, 1, 2, 16, 32, [3, 9]))
    caches = (("k", k), ("v", v))
    dk._check_operands(q, caches, lens)  # accepted
    dk._check_operands(q.bfloat16(), caches, lens)  # bf16 q (mixed precision) too
    with pytest.raises(TypeError):
        dk._check_operands(q.double(), caches, lens)
    with pytest.raises(TypeError):
        dk._check_operands(q, (("k", k.bfloat16()), ("v", v.bfloat16())), lens)  # the pools stay fp32
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


# -- kernels #6-#9: int8 pools and the token-tree mask -------------------------------


def _quant(rng, kp, vp, tbl, zero_page=True):
    """int8 pools with one fp32 scale per (page, head) from fp32 pools of
    the same shape; the first page row 0 maps gets scale 0 (a page never
    written reads as zeros)."""
    num_pages, h = kp.shape[0], kp.shape[2]
    k8 = rng.integers(-127, 128, size=kp.shape).astype(np.int8)
    v8 = rng.integers(-127, 128, size=vp.shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, size=(num_pages, h)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, size=(num_pages, h)).astype(np.float32)
    if zero_page:
        ks[tbl[0, 0]] = vs[tbl[0, 0]] = 0.0
    return k8, v8, ks, vs


def _parents(rng, b, w):
    """A seeded random tree per row: row 0 is the root, row j's parent
    is any earlier row."""
    par = np.full((b, w), -1, dtype=np.int32)
    for j in range(1, w):
        par[:, j] = rng.integers(0, j, size=b)
    return par


def _masks(par, lens, w, klen):
    """The tree mask from both packages' tree_allowed_mask."""
    jmask = np.asarray(jax_tree_allowed_mask(jnp.asarray(par), jnp.asarray(lens), w, klen))
    tmask = tattn.tree_allowed_mask(*_t(par, lens), w, klen).numpy()
    np.testing.assert_array_equal(tmask, jmask)
    return tmask


@pytest.mark.parametrize("w", [1, 5, 13])
def test_quant_plain_versions_match_pallas_interpreter(w):
    """#6 (staircase) and #9 (tree) over int8 pools against the Pallas
    kernels in interpret mode at 32-row pages (the reference's int8
    kernels take no other), with a sentinel hole, a dead row and a
    scale-0 page."""
    rng = np.random.default_rng(10 + w)
    page = 32
    lengths = [3, 64 - w, 9, 20]
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, page, 12, lengths)
    tbl[1, 0] = 12  # a hole inside row 1's visible range
    tbl[3, :] = 12  # a dead row
    k8, v8, ks, vs = _quant(rng, kp, vp, tbl)
    pools = (q, k8, v8, ks, vs, tbl, lens)
    ours = dk.paged_flash_verify_quant(*_t(*pools)).numpy()
    kern = np.asarray(jdk.paged_flash_verify_quant(*map(jnp.asarray, pools), interpret=True))
    np.testing.assert_allclose(ours, kern, atol=ATOL)
    np.testing.assert_allclose(ours[3], 0.0)
    mask = _masks(_parents(rng, 4, w), lens, w, tbl.shape[1] * page)
    ours = dk.paged_flash_verify_tree_quant(*_t(*pools, mask)).numpy()
    kern = np.asarray(
        jdk.paged_flash_verify_tree_quant(
            *map(jnp.asarray, pools), jnp.asarray(mask, jnp.float32), interpret=True
        )
    )
    np.testing.assert_allclose(ours, kern, atol=ATOL)


@pytest.mark.parametrize("w", [1, 13])
@pytest.mark.parametrize("page", [8, 32])
def test_tree_plain_versions_match_pallas_interpreter(w, page):
    """#7 on the contiguous cache and #8 on pools with a hole and a dead
    row, under a random tree mask, against the Pallas kernels."""
    rng = np.random.default_rng(20 + w + page)
    q, k, v, lens = _contig(rng, 3, w, 2, 16, 64, [0, 17, 64 - w])
    mask = _masks(_parents(rng, 3, w), lens, w, 64)
    ours = dk.flash_verify_tree(*_t(q, k, v, lens, mask)).numpy()
    kern = np.asarray(
        jdk.flash_verify_tree(*map(jnp.asarray, (q, k, v, lens)), jnp.asarray(mask, jnp.float32), interpret=True)
    )
    np.testing.assert_allclose(ours, kern, atol=ATOL)
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, page, 32, [2, page, 64 - w, 9])
    tbl[2, 0] = 32  # hole
    tbl[3, :] = 32  # dead row
    mask = _masks(_parents(rng, 4, w), lens, w, 64)
    ours = dk.paged_flash_verify_tree(*_t(q, kp, vp, tbl, lens, mask)).numpy()
    kern = np.asarray(
        jdk.paged_flash_verify_tree(
            *map(jnp.asarray, (q, kp, vp, tbl, lens)), jnp.asarray(mask, jnp.float32), interpret=True
        )
    )
    np.testing.assert_allclose(ours, kern, atol=ATOL)
    np.testing.assert_allclose(ours[3], 0.0)


@pytest.mark.parametrize("page", [8, 16])
def test_plain_versions_match_jax_dense_paths(page):
    """At the pages the reference's int8 kernels refuse, #6-#9's plain
    versions against the reference's dense paths (paged_verify_attention
    with scales and tree_parents, verify_attention with tree_parents,
    paged_decode_attention with scales) on live rows; the port's
    attention seams give the same with the mask precomputed."""
    rng = np.random.default_rng(30 + page)
    for w in (1, 5, 13):
        lengths = [3, 64 - w, 9, page]
        q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, page, 40, lengths)
        k8, v8, ks, vs = _quant(rng, kp, vp, tbl)
        par = _parents(rng, 4, w)
        mask = _masks(par, lens, w, 64)
        jq = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        jargs = list(map(jnp.asarray, (q, k8, v8, tbl, lens)))
        targs = _t(q, k8, v8, tbl, lens)
        tq = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
        cases = [
            (dk.paged_flash_verify_quant(*_t(q, k8, v8, ks, vs, tbl, lens)),
             jax_paged_verify_attention(*jargs, **jq)),
            (dk.paged_flash_verify_tree_quant(*_t(q, k8, v8, ks, vs, tbl, lens, mask)),
             jax_paged_verify_attention(*jargs, **jq, tree_parents=jnp.asarray(par))),
            (dk.paged_flash_verify_tree(*_t(q, kp, vp, tbl, lens, mask)),
             jax_paged_verify_attention(*map(jnp.asarray, (q, kp, vp, tbl, lens)), tree_parents=jnp.asarray(par))),
            (tattn.paged_verify_attention(*targs, **tq, allowed=_t(mask)[0]),
             jax_paged_verify_attention(*jargs, **jq, tree_parents=jnp.asarray(par))),
            (tattn.paged_verify_attention(*targs, **tq, tree_parents=_t(par)[0]),
             jax_paged_verify_attention(*jargs, **jq, tree_parents=jnp.asarray(par))),
        ]
        qc, kc, vc, lc = _contig(rng, 3, w, 2, 16, 64, [0, 30, 64 - w])
        cpar = _parents(rng, 3, w)
        cmask = _masks(cpar, lc, w, 64)
        cases.append(
            (dk.flash_verify_tree(*_t(qc, kc, vc, lc, cmask)),
             jax_verify_attention(*map(jnp.asarray, (qc, kc, vc, lc)), tree_parents=jnp.asarray(cpar)))
        )
        cases.append(
            (tattn.verify_attention(*_t(qc, kc, vc, lc), tree_parents=_t(cpar)[0]),
             jax_verify_attention(*map(jnp.asarray, (qc, kc, vc, lc)), tree_parents=jnp.asarray(cpar)))
        )
        if w == 1:
            cases.append(
                (tattn.paged_decode_attention(*targs, **tq),
                 jax_paged_decode_attention(*jargs, **jq))
            )
        for ours, ref in cases:
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_chain_parents_reproduce_the_staircase():
    """A tree of chain parents is the linear verify: the mask equals the
    staircase, and #7/#8/#9's plain versions equal #4/#5/#6's."""
    rng = np.random.default_rng(40)
    w = 6
    q, kp, vp, tbl, lens = _paged(rng, 3, w, 2, 16, 16, 16, [0, 7, 40])
    chain = np.tile(np.arange(-1, w - 1, dtype=np.int32), (3, 1))
    mask = tattn.tree_allowed_mask(*_t(chain, lens), w, 64)
    torch.testing.assert_close(mask, dk._staircase(_t(lens)[0], w, 64))
    k8, v8, ks, vs = _quant(rng, kp, vp, tbl)
    torch.testing.assert_close(
        dk.paged_flash_verify_tree(*_t(q, kp, vp, tbl, lens), mask),
        dk.paged_flash_verify(*_t(q, kp, vp, tbl, lens)), atol=ATOL, rtol=0,
    )
    torch.testing.assert_close(
        dk.paged_flash_verify_tree_quant(*_t(q, k8, v8, ks, vs, tbl, lens), mask),
        dk.paged_flash_verify_quant(*_t(q, k8, v8, ks, vs, tbl, lens)), atol=ATOL, rtol=0,
    )
    qc, kc, vc, lc = _contig(rng, 3, w, 2, 16, 64, [0, 7, 58])
    cmask = tattn.tree_allowed_mask(*_t(chain, lc), w, 64)
    torch.testing.assert_close(
        dk.flash_verify_tree(*_t(qc, kc, vc, lc), cmask),
        dk.flash_verify(*_t(qc, kc, vc, lc)), atol=ATOL, rtol=0,
    )


def test_scale_zero_page_reads_as_zeros():
    """A page with scale 0 contributes zero vectors at its visible
    positions: the int8 plain version equals fp32 attention over the
    dequantized pools with that page zeroed."""
    rng = np.random.default_rng(41)
    q, kp, vp, tbl, lens = _paged(rng, 2, 3, 2, 16, 16, 8, [20, 5])
    k8, v8, ks, vs = _quant(rng, kp, vp, tbl)
    ours = dk.paged_flash_verify_quant(*_t(q, k8, v8, ks, vs, tbl, lens))
    kd = torch.from_numpy(k8).float() * torch.from_numpy(ks)[:, None, :, None]
    vd = torch.from_numpy(v8).float() * torch.from_numpy(vs)[:, None, :, None]
    assert float(kd[tbl[0, 0]].abs().max()) == 0.0
    ref = dk.paged_flash_verify(*_t(q), kd, vd, *_t(tbl, lens))
    torch.testing.assert_close(ours, ref, atol=ATOL, rtol=0)


def test_quant_and_tree_operand_checks():
    """What the int8 and tree launches reject, on CPU tensors."""
    rng = np.random.default_rng(42)
    q, kp, vp, tbl, lens = _t(*_paged(rng, 2, 3, 2, 16, 16, 8, [3, 9]))
    k8, v8 = kp.to(torch.int8), vp.to(torch.int8)
    dk._check_operands(q, (("k", k8), ("v", v8)), lens, tbl, quant=True)  # accepted
    assert dk._int8_vec16(k8, v8)  # 16-byte loads
    with pytest.raises(TypeError):
        dk._check_operands(q, (("k", kp), ("v", vp)), lens, tbl, quant=True)
    # head_dim 8 (and 24, 40: any multiple of 8) and rows 24 bytes apart
    # are taken in 8-byte loads
    dk._check_operands(q[..., :8], (("k", k8[..., :8]), ("v", v8[..., :8])), lens, tbl, quant=True)
    assert not dk._int8_vec16(k8[..., :8], v8[..., :8])
    odd = torch.zeros(8, 16, 2, 24, dtype=torch.int8)[..., :16]  # rows 24 bytes apart
    dk._check_operands(q, (("k", odd), ("v", v8)), lens, tbl, quant=True)
    assert not dk._int8_vec16(odd, v8)
    with pytest.raises(ValueError, match="multiple of 8"):
        dk._check_operands(q[..., :4], (("k", k8[..., :4]), ("v", v8[..., :4])), lens, tbl, quant=True)
    with pytest.raises(ValueError, match="strides"):
        odd = torch.zeros(8, 16, 2, 20, dtype=torch.int8)[..., :16]  # rows 20 bytes apart
        dk._check_operands(q, (("k", odd), ("v", v8)), lens, tbl, quant=True)
    scales = torch.zeros(8, 2)
    dk._check_scales(scales, scales, 8, 2, q.device)  # accepted
    with pytest.raises(ValueError, match="k_scale"):
        dk._check_scales(scales[:, :1], scales, 8, 2, q.device)
    mask = torch.ones(2, 3, 64, dtype=torch.bool)
    assert dk._mask_operand(mask, 2, 3, 64, q.device).dtype == torch.uint8
    assert dk._mask_operand(mask.float(), 2, 3, 64, q.device).dtype == torch.uint8
    with pytest.raises(ValueError, match="contiguous"):
        dk._mask_operand(torch.ones(2, 64, 3, dtype=torch.bool).transpose(1, 2), 2, 3, 64, q.device)
    with pytest.raises(ValueError, match="allowed must be"):
        dk._mask_operand(mask[:, :2], 2, 3, 64, q.device)
    with pytest.raises(TypeError):
        dk._mask_operand(mask.long(), 2, 3, 64, q.device)


# -- bf16 q (a mixed-precision model) against the fp32 and int8 pools ---------------------

# bf16 outputs of the two packages come from f32 results that differ in
# summation order only and are rounded to bf16 once, so they agree within
# one bf16 ulp of each entry; an entry near 0 (where the f32 results'
# own rounding noise exceeds its ulp) within BF16_NOISE
BF16_NOISE = 1e-5


def _assert_bf16_close(ours, kern):
    assert ours.dtype == torch.bfloat16, ours.dtype
    assert kern.dtype == jnp.bfloat16, kern.dtype
    a = ours.float().numpy().astype(np.float64)
    b = np.asarray(kern.astype(jnp.float32)).astype(np.float64)
    big = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0**-126)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    np.testing.assert_array_less(np.abs(a - b), ulp + BF16_NOISE)


def _bf16(q):
    """The same bf16 q on both sides (numpy f32 rounded to nearest even)."""
    return torch.from_numpy(q).bfloat16(), jnp.asarray(q).astype(jnp.bfloat16)


@pytest.mark.parametrize("d", [8, 16, 24])
@pytest.mark.parametrize("w", [1, 5, 13])
def test_bf16_q_plain_versions_match_pallas_interpreter(w, d):
    """#4-#9 at bf16 q (fp32 caches and pools; int8 pools at 32-row pages,
    the reference's int8 kernels' only size, so int8 at head_dim 24 too)
    against the Pallas kernels in interpret mode on the same bf16 q: the
    output is bf16 on both sides and within one bf16 ulp; each plain
    version is the fp32-q function of the widened q, rounded once."""
    rng = np.random.default_rng(60 + w + d)
    q, k, v, lens = _contig(rng, 3, w, 2, d, 64, [0, 17, 64 - w])
    tq, jq = _bf16(q)
    kv = list(map(jnp.asarray, (k, v, lens)))
    ours = dk.flash_verify(tq, *_t(k, v, lens))
    _assert_bf16_close(ours, jdk.flash_verify(jq, *kv, interpret=True))
    assert torch.equal(ours, dk.flash_verify(tq.float(), *_t(k, v, lens)).bfloat16())
    mask = _masks(_parents(rng, 3, w), lens, w, 64)
    _assert_bf16_close(
        dk.flash_verify_tree(tq, *_t(k, v, lens, mask)),
        jdk.flash_verify_tree(jq, *kv, jnp.asarray(mask, jnp.float32), interpret=True),
    )
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, d, 8, 32, [2, 8, 64 - w, 9])
    tbl[3, :] = 32  # a dead row
    tq, jq = _bf16(q)
    pools = list(map(jnp.asarray, (kp, vp, tbl, lens)))
    ours = dk.paged_flash_verify(tq, *_t(kp, vp, tbl, lens))
    _assert_bf16_close(ours, jdk.paged_flash_verify(jq, *pools, interpret=True))
    assert float(ours[3].float().abs().max()) == 0.0
    mask = _masks(_parents(rng, 4, w), lens, w, 64)
    _assert_bf16_close(
        dk.paged_flash_verify_tree(tq, *_t(kp, vp, tbl, lens, mask)),
        jdk.paged_flash_verify_tree(jq, *pools, jnp.asarray(mask, jnp.float32), interpret=True),
    )
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, d, 32, 12, [3, 64 - w, 9, 20])
    tbl[1, 0] = 12  # a hole
    k8, v8, ks, vs = _quant(rng, kp, vp, tbl)  # with a scale-0 page
    tq, jq = _bf16(q)
    pools = list(map(jnp.asarray, (k8, v8, ks, vs, tbl, lens)))
    ours = dk.paged_flash_verify_quant(tq, *_t(k8, v8, ks, vs, tbl, lens))
    _assert_bf16_close(ours, jdk.paged_flash_verify_quant(jq, *pools, interpret=True))
    assert torch.equal(ours, dk.paged_flash_verify_quant(tq.float(), *_t(k8, v8, ks, vs, tbl, lens)).bfloat16())
    mask = _masks(_parents(rng, 4, w), lens, w, tbl.shape[1] * 32)
    _assert_bf16_close(
        dk.paged_flash_verify_tree_quant(tq, *_t(k8, v8, ks, vs, tbl, lens, mask)),
        jdk.paged_flash_verify_tree_quant(jq, *pools, jnp.asarray(mask, jnp.float32), interpret=True),
    )


def test_bf16_q_decode_seams_match_jax():
    """The decode and verify seams of ops/attention.py pass a bf16 q
    through to #4/#5 (w = 1) and return bf16, as the reference's decode
    paths do on bf16 q against fp32 caches."""
    rng = np.random.default_rng(70)
    q, k, v, lens = _contig(rng, 3, 1, 2, 16, 64, [0, 17, 63])
    tq, jq = _bf16(q)
    _assert_bf16_close(
        tattn.decode_attention(tq, *_t(k, v, lens)),
        jdk.flash_decode(jq, *map(jnp.asarray, (k, v, lens)), interpret=True),
    )
    q, kp, vp, tbl, lens = _paged(rng, 3, 1, 2, 16, 8, 32, [0, 8, 40])
    tq, jq = _bf16(q)
    _assert_bf16_close(
        tattn.paged_decode_attention(tq, *_t(kp, vp, tbl, lens)),
        jdk.paged_flash_decode(jq, *map(jnp.asarray, (kp, vp, tbl, lens)), interpret=True),
    )


# -- the fp32 tree body's split-then-merge rule (csrc/tree_kernel.cu) -----------------


def _partial(s, v, seen):
    """(m, l, acc) of one range of positions: the running max, the sum of
    e^(s - m) and the unnormalised accumulator over the entries of `seen`;
    m = -1e30, l = 0 and acc = 0 where a row sees none of them."""
    sc = s.masked_fill(~seen, -1e30)
    m = sc.amax(-1)
    p = torch.where(seen, torch.exp(sc - m[..., None]), torch.zeros(()))
    return m, p.sum(-1), torch.einsum("bhqk,bkhd->bhqd", p, v)


def _merge(parts):
    """The exact merge of partials (m_s, l_s, acc_s): M = max m_s over the
    partials with l_s > 0, then (M, sum e^(m_s - M) l_s, sum e^(m_s - M)
    acc_s) over those only, so a partial with l_s = 0 is never read."""
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    live = l > 0
    big = m.masked_fill(~live, -1e30).amax(0)
    e = torch.where(live, torch.exp(m - big), torch.zeros(()))
    num = torch.where(live[..., None], e[..., None] * acc, torch.zeros(())).sum(0)
    return big, (e * l).sum(0), num


def _split_then_merge(q, k, v, vis, lengths, span, lanes=1):
    """A plain model of the split-KV body of #5, #7, #8 and #9: positions
    are cut into splits of `span`; each split gives a partial (m, l, acc)
    per query row over the visible entries of `vis` [b, w, L] (gated and
    page-checked). With `lanes` > 1 (the one-row tile of #5 at w = 1,
    whose 8 half-warps each take the positions lo + t + 8 i of the split)
    the split's partial is itself the merge of `lanes` partials. A split
    that starts at or past min(lengths + w, L) is empty (the kernel writes
    nothing for it; here m = -1e30, l = 0 and an accumulator of NaN, which
    the merge must never read), and the merge takes M = max m_s over the
    partials with l_s > 0 and returns sum e^(m_s - M) acc_s /
    max(sum e^(m_s - M) l_s, 1e-30) over those. Returns the output
    [b, w, h, d] and the counts of empty and of live but all-masked
    (sequence, split, query row) partials."""
    b, w, h, d = q.shape
    L = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    end = (lengths.long() + w).clamp(max=L)
    parts, empty_n, masked_n = [], 0, 0
    for lo in range(0, L, span):
        seen = vis[:, None, :, lo:lo + span].expand(b, h, w, -1)
        lane = torch.arange(seen.shape[-1]) % lanes
        m, l, acc = _merge(
            [_partial(s[..., lo:lo + span], v[:, lo:lo + span], seen & (lane == t)) for t in range(lanes)]
        )
        empty = (lo >= end)[:, None, None].expand(b, h, w)
        m = m.masked_fill(empty, -1e30)
        l = l.masked_fill(empty, 0.0)
        acc = acc.masked_fill(empty[..., None], float("nan"))
        empty_n += int(empty.sum())
        masked_n += int((~empty & (l == 0)).sum())
        parts.append((m, l, acc))
    _, den, num = _merge(parts)
    return (num / den.clamp_min(1e-30)[..., None]).transpose(1, 2), empty_n, masked_n


@functools.lru_cache(maxsize=None)
def _tree_case(w, page):
    """The inputs of test_tree_plain_versions_match_pallas_interpreter
    (same seed, same draws) and the Pallas kernels' outputs on them."""
    rng = np.random.default_rng(20 + w + page)
    q, k, v, lens = _contig(rng, 3, w, 2, 16, 64, [0, 17, 64 - w])
    mask = _masks(_parents(rng, 3, w), lens, w, 64)
    kern = np.asarray(
        jdk.flash_verify_tree(*map(jnp.asarray, (q, k, v, lens)), jnp.asarray(mask, jnp.float32), interpret=True)
    )
    contig = (q, k, v, lens, mask, kern)
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, page, 32, [2, page, 64 - w, 9])
    tbl[2, 0] = 32  # hole
    tbl[3, :] = 32  # dead row
    mask = _masks(_parents(rng, 4, w), lens, w, 64)
    kern = np.asarray(
        jdk.paged_flash_verify_tree(
            *map(jnp.asarray, (q, kp, vp, tbl, lens)), jnp.asarray(mask, jnp.float32), interpret=True
        )
    )
    return contig, (q, kp, vp, tbl, lens, mask, kern)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("w", [1, 13])
@pytest.mark.parametrize("page", [8, 32])
def test_tree_split_then_merge_matches_plain_and_pallas(page, w, splits):
    """The merge rule of the tree body over S splits (a span of
    ceil(64 / S) positions, whole pages on the paged layout) against #7's
    and #8's plain versions and the Pallas kernels in interpret mode, with
    empty splits (row 0 has length 0 or 2), all-masked splits (row 2's
    sentinel hole on the paged layout) and a dead row that must give
    exactly 0. atol 1e-5: summation order only."""
    (q, k, v, lens, mask, kern), (pq, kp, vp, tbl, plens, pmask, pkern) = _tree_case(w, page)
    q, k, v, lens, mask = _t(q, k, v, lens, mask)
    vis = dk._tree_visible(mask, lens, w)
    ours, empty, _ = _split_then_merge(q, k, v, vis, lens, -(-64 // splits))
    np.testing.assert_allclose(ours.numpy(), dk.flash_verify_tree_ref(q, k, v, lens, mask).numpy(), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), kern, atol=ATOL)
    assert (empty > 0) == (splits > 1)

    pq, kp, vp, tbl, plens, pmask = _t(pq, kp, vp, tbl, plens, pmask)
    kg, on_page = dk.gather_pages(kp, tbl)
    vg, _ = dk.gather_pages(vp, tbl)
    vis = dk._tree_visible(pmask, plens, w) & on_page[:, None, :]
    span = -(-(-(-64 // splits)) // page) * page
    ours, empty, masked = _split_then_merge(pq, kg, vg, vis, plens, span)
    ref = dk.paged_flash_verify_tree_ref(pq, kp, vp, tbl, plens, pmask)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), pkern, atol=ATOL)
    assert float(ours[3].abs().max()) == 0.0 and bool(torch.isfinite(ours).all())
    assert masked > 0 and (empty > 0) == (64 // span > 1)


@pytest.mark.parametrize(
    "b, h, max_len, unit",
    [(8, 16, 512, 16), (8, 16, 512, 1), (1, 1, 64, 16), (2, 4, 1000, 24), (64, 32, 4096, 16), (3, 2, 250, 2)],
)
def test_tree_split_rule(b, h, max_len, unit):
    """pick_splits: each split a multiple of 64 positions (a whole
    number of the kernel's chunks) and of pages, the splits just covering
    max_len and at most 64, and at least
    half the blocks per SM the rule aims at on a 132-SM card where
    max_len allows (rounding the span to whole chunks takes the rest),
    one split where one block per (sequence, head) already gives them."""
    target = dk._BLOCKS_PER_SM * 132
    splits, span = dk.pick_splits(b, h, max_len, unit, sms=132)
    assert span % 64 == 0 and span % unit == 0 and splits <= 64
    assert (splits - 1) * span < max_len <= splits * span
    assert 2 * b * h * splits >= target or span == math.lcm(64, unit)
    if b * h >= target:
        assert splits == 1
    if (b, h, max_len, unit) == (8, 16, 512, 16):  # the serving shape
        assert (splits, span) == (8, 64)


def _stage_int8(pool, scale, tables):
    """The int8 tree body's staging, position by position: each logical
    position's page from the block table (one lookup per row), its int8
    row times that page's (page, head) scale, zeros on a sentinel page.
    Returns [b, L, h, d] fp32."""
    num_pages, page = pool.shape[:2]
    pos = torch.arange(tables.shape[1] * page)
    pages = tables.long()[:, pos // page]  # [b, L]
    on = (pages >= 0) & (pages < num_pages)
    safe = pages.clamp(0, num_pages - 1)
    rows = pool[safe, pos % page].float() * scale[safe][..., None]
    return torch.where(on[..., None, None], rows, torch.zeros(()))


@functools.lru_cache(maxsize=None)
def _quant_tree_case(w, page):
    """int8 pools (a different random scale per page, row 0's first page
    at scale 0), a sentinel hole in row 2, a dead row 3 and a seeded tree
    per row; the Pallas kernel's output where the reference takes the
    page size (32 rows), else None."""
    rng = np.random.default_rng(50 + w + page)
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, page, 16, [3, 64 - w, 40, 20])
    tbl[2, 0] = 16  # a hole inside row 2's visible range
    tbl[3, :] = 16  # a dead row
    k8, v8, ks, vs = _quant(rng, kp, vp, tbl)
    mask = _masks(_parents(rng, 4, w), lens, w, tbl.shape[1] * page)
    pools = (q, k8, v8, ks, vs, tbl, lens)
    kern = None
    if page == 32:
        kern = np.asarray(
            jdk.paged_flash_verify_tree_quant(
                *map(jnp.asarray, pools), jnp.asarray(mask, jnp.float32), interpret=True
            )
        )
    return pools, mask, kern


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("w", [1, 13])
@pytest.mark.parametrize("page", [16, 32])
def test_int8_split_then_merge_matches_plain_and_pallas(page, w, splits):
    """#9 on the split-KV body: the int8 staging (per-row page lookup and
    scale) is bit-identical to the plain version's dense dequant, and the
    merge rule over those rows matches #9's plain version (16- and 32-row
    pages) and the Pallas kernel in interpret mode (32-row pages, the
    only int8 page the reference takes), with several scales inside one
    span, a scale-0 page, a sentinel hole and a dead row that gives
    exactly 0. atol 1e-5: summation order only."""
    pools, mask, kern = _quant_tree_case(w, page)
    q, k8, v8, ks, vs, tbl, lens = _t(*pools)
    mask = _t(mask)[0]
    kd, on_page = dk.gather_pages(k8, tbl, ks)
    vd, _ = dk.gather_pages(v8, tbl, vs)
    kst, vst = _stage_int8(k8, ks, tbl), _stage_int8(v8, vs, tbl)
    on = on_page[..., None, None]
    assert torch.equal(kst, torch.where(on, kd, torch.zeros(()))) and torch.equal(vst, torch.where(on, vd, torch.zeros(())))
    zero = int(tbl[0, 0])
    assert float(ks[zero].abs().max()) == 0.0 and float(kst[0, :page].abs().max()) == 0.0
    assert len({float(ks[int(p), 0]) for p in tbl[1]}) > 1  # row 1: several scales inside one span
    vis = dk._tree_visible(mask, lens, w) & on_page[:, None, :]
    span = -(-(-(-64 // splits)) // page) * page
    ours, empty, masked = _split_then_merge(q, kst, vst, vis, lens, span)
    ref = dk.paged_flash_verify_tree_quant_ref(q, k8, v8, ks, vs, tbl, lens, mask)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)
    if kern is not None:
        np.testing.assert_allclose(ours.numpy(), kern, atol=ATOL)
    assert float(ours[3].abs().max()) == 0.0 and bool(torch.isfinite(ours).all())
    assert masked > 0 and (empty > 0) == (64 // span > 1)


@functools.lru_cache(maxsize=None)
def _stair_case(w):
    """fp32 pools at 16-row pages with lengths 0, mid and 64 - w, a hole
    in row 1 and a dead row 3, and the Pallas kernel's output on them."""
    rng = np.random.default_rng(60 + w)
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, 16, 16, [0, 40, 64 - w, 9])
    tbl[1, 0] = 16  # hole
    tbl[3, :] = 16  # dead row
    kern = np.asarray(jdk.paged_flash_verify(*map(jnp.asarray, (q, kp, vp, tbl, lens)), interpret=True))
    return (q, kp, vp, tbl, lens), kern


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("w", [1, 5])
def test_staircase_split_then_merge_matches_plain_and_pallas(w, splits):
    """#5 on the split-KV body: the staircase p <= lengths + j in place of
    a mask, at w = 1 through the one-row tile (each split's partial the
    merge of 8 interleaved half-warp partials) and at w = 5 through the
    8 x 16 tile, against #5's plain version and the Pallas kernel in
    interpret mode, with empty splits (row 0 has length 0), a sentinel
    hole and a dead row that gives exactly 0. atol 1e-5: summation order
    only."""
    (q, kp, vp, tbl, lens), kern = _stair_case(w)
    q, kp, vp, tbl, lens = _t(q, kp, vp, tbl, lens)
    kg, on_page = dk.gather_pages(kp, tbl)
    vg, _ = dk.gather_pages(vp, tbl)
    vis = dk._staircase(lens, w, 64) & on_page[:, None, :]
    span = -(-(-(-64 // splits)) // 16) * 16
    ours, empty, masked = _split_then_merge(q, kg, vg, vis, lens, span, lanes=8 if w == 1 else 1)
    ref = dk.paged_flash_verify_ref(q, kp, vp, tbl, lens)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), kern, atol=ATOL)
    assert float(ours[3].abs().max()) == 0.0 and bool(torch.isfinite(ours).all())
    assert masked > 0 and (empty > 0) == (splits > 1)


@functools.lru_cache(maxsize=None)
def _contig_stair_case(w):
    """The contiguous cache with lengths 0, mid and 64 - w (the inputs
    of test_flash_verify_plain_matches_jax) and the Pallas kernel's
    output on them."""
    rng = np.random.default_rng(0)
    q, k, v, lens = _contig(rng, 3, w, 2, 16, 64, [0, 17, 64 - w])
    kern = np.asarray(jdk.flash_verify(*map(jnp.asarray, (q, k, v, lens)), interpret=True))
    return (q, k, v, lens), kern


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("w", [1, 5])
def test_contiguous_staircase_split_then_merge_matches_plain_and_pallas(w, splits):
    """#4 on the split-KV body: the staircase on the contiguous cache
    (no page lookup, spans of any multiple of 64 positions, here cut
    finer to exercise the merge), at w = 1 through the one-row tile (each
    split's partial the merge of 8 interleaved half-warp partials) and at
    w = 5 through the 8 x 16 tile, against #4's plain version and the
    Pallas kernel in interpret mode, with empty splits (row 0 has length
    0). atol 1e-5: summation order only."""
    (q, k, v, lens), kern = _contig_stair_case(w)
    q, k, v, lens = _t(q, k, v, lens)
    vis = dk._staircase(lens, w, 64)
    ours, empty, _ = _split_then_merge(q, k, v, vis, lens, -(-64 // splits), lanes=8 if w == 1 else 1)
    np.testing.assert_allclose(ours.numpy(), dk.flash_verify_ref(q, k, v, lens).numpy(), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), kern, atol=ATOL)
    assert bool(torch.isfinite(ours).all()) and (empty > 0) == (splits > 1)


# row groups of the int8 one-row tile (#6 at w = 1) at head_dim <= 64: 4
# lanes read a row's 64 int8 columns as one 16-byte load each, so the 128
# threads hold 32 rows at once, group g taking positions lo + g + 32 i of
# a split
INT8_ROW_GROUPS = 32


@functools.lru_cache(maxsize=None)
def _quant_stair_case(w, page):
    """int8 pools (a random scale per page, row 0's first page at scale
    0), a sentinel hole in row 2 and a dead row 3, and the Pallas
    kernel's output where the reference takes the page size (32 rows),
    else None."""
    rng = np.random.default_rng(70 + w + page)
    q, kp, vp, tbl, lens = _paged(rng, 4, w, 2, 16, page, 16, [3, 64 - w, 40, 20])
    tbl[2, 0] = 16  # a hole inside row 2's visible range
    tbl[3, :] = 16  # a dead row
    k8, v8, ks, vs = _quant(rng, kp, vp, tbl)
    pools = (q, k8, v8, ks, vs, tbl, lens)
    kern = None
    if page == 32:
        kern = np.asarray(jdk.paged_flash_verify_quant(*map(jnp.asarray, pools), interpret=True))
    return pools, kern


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("page", [16, 32])
def test_int8_staircase_split_then_merge_matches_plain_and_pallas(page, w, splits):
    """#6 on the split-KV body: int8 rows staged as #9's (per-row page
    lookup and scale, bit-identical to the plain version's dense dequant)
    under the staircase, at w = 1 through the int8 one-row tile (each
    split's partial the merge of its 32 interleaved row groups) and at
    w = 5 through the 8 x 16 tile, against #6's plain version (16- and
    32-row pages) and the Pallas kernel in interpret mode (32-row pages,
    the only int8 page the reference takes), with several scales inside
    one span, a scale-0 page, a sentinel hole and a dead row that gives
    exactly 0. atol 1e-5: summation order only."""
    pools, kern = _quant_stair_case(w, page)
    q, k8, v8, ks, vs, tbl, lens = _t(*pools)
    kst, vst = _stage_int8(k8, ks, tbl), _stage_int8(v8, vs, tbl)
    _, on_page = dk.gather_pages(k8, tbl, ks)
    assert float(kst[0, :page].abs().max()) == 0.0  # row 0's first page: scale 0
    assert len({float(ks[int(p), 0]) for p in tbl[1]}) > 1  # row 1: several scales inside one span
    vis = dk._staircase(lens, w, 64) & on_page[:, None, :]
    span = -(-(-(-64 // splits)) // page) * page
    ours, empty, masked = _split_then_merge(q, kst, vst, vis, lens, span, lanes=INT8_ROW_GROUPS if w == 1 else 1)
    ref = dk.paged_flash_verify_quant_ref(q, k8, v8, ks, vs, tbl, lens)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)
    if kern is not None:
        np.testing.assert_allclose(ours.numpy(), kern, atol=ATOL)
    assert float(ours[3].abs().max()) == 0.0 and bool(torch.isfinite(ours).all())
    assert masked > 0 and (empty > 0) == (64 // span > 1)


@pytest.mark.parametrize(
    "b, h, max_len, unit, want",
    [(8, 16, 512, 16, (4, 128)), (8, 16, 4096, 16, (8, 512)), (1, 1, 64, 16, (1, 128)),
     (3, 2, 250, 2, (2, 128)), (2, 4, 1000, 24, (3, 384)), (64, 32, 4096, 16, (1, 4096))],
)
def test_int8_decode_split_rule(b, h, max_len, unit, want):
    """pick_splits with #6's span unit at w = 1 (_QUANT_SPAN_UNIT, 128
    positions: two of the int8 one-row tile's 64-row passes): each split
    a multiple of that unit and of the page, the splits just covering
    max_len, the same aim at blocks per SM as the fp32 rule; at the
    serving shape 4 splits of 128 positions (the fp32 rule: 8 of 64)."""
    unit_q = dk._QUANT_SPAN_UNIT
    assert unit_q % dk._TREE_SPAN_UNIT == 0 and unit_q == 128
    splits, span = dk.pick_splits(b, h, max_len, unit, 132, unit_q)
    assert span % unit_q == 0 and span % unit == 0 and splits <= 64
    assert (splits - 1) * span < max_len <= splits * span
    assert (splits, span) == want


# -- #9's arithmetic on the split-KV body, and TF32 mma.sync products beside it -------


def _merge_splits(parts):
    """tree_kernel.cu's merge of a (sequence, head)'s split partials, in
    fp32: M = max m_s over the partials with l_s > 0, e_s = e^(m_s - M)
    (0 where l_s = 0), out = sum e_s acc_s / max(sum e_s l_s, 1e-30), the
    sums in split order and a partial whose weight is 0 never read."""
    m, l, acc = (torch.stack([t.float() for t in ts]) for ts in zip(*parts))
    live = l > 0
    big = m.masked_fill(~live, -1e30).amax(0)
    e = torch.where(live, torch.exp(m - big), torch.zeros(()))
    den = torch.zeros_like(big)
    num = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        den = den + e[s] * l[s]
        num = num + torch.where((e[s] > 0)[..., None], e[s][..., None] * acc[s], torch.zeros(()))
    return num / den.clamp_min(1e-30)[..., None]


def _fp32_dot4(a, b):
    """Sums over the last dim of fp32 products the way the tiles form them:
    4-term fp32 partials ((x0 y0 + x1 y1) + x2 y2) + x3 y3, returned
    [..., n / 4] for the caller to add in fp64."""
    p = (a * b).unflatten(-1, (-1, 4))
    return ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]


def _int8_tree_model(q, k8, v8, ks, vs, tbl, lens, mask, products="cuda_cores"):
    """#9 in the arithmetic order of its products, over the splits of
    pick_splits (tree_kernel.cu's grid), each read in chunks of 32
    positions. "cuda_cores" (tree_kernel.cu's tile at w <= 16): K and V
    rows dequantized in fp32 as the plain version does, scores and P V in
    fp32 4-term partials added into fp64 running sums (scores, m, l,
    acc), P in fp32. "tf32_mma" (an option for a redesign): per page, S =
    ks (Q_big K8 + Q_small K8) and P V = (P vs)_big V8 + (P vs)_small V8
    as chains of m16n8k8 TF32 mma's whose sums round toward zero, into
    fresh accumulators per page, the running sums in fp64. Each split's
    (m, l, acc) is rounded to fp32 and the splits merge as _merge_splits.
    Returns [b, w, h, d] fp32."""
    b, w, h, d = q.shape
    num_pages, page = k8.shape[:2]
    L = tbl.shape[1] * page
    kst, vst = _stage_int8(k8, ks, tbl), _stage_int8(v8, vs, tbl)
    _, on_page = dk.gather_pages(k8, tbl, ks)
    vis = (dk._tree_visible(mask, lens, w) & on_page[:, None, :])[:, None].expand(b, h, w, L)
    splits, span = dk.pick_splits(b, h, L, page, 132)
    scale = 1.0 / math.sqrt(d)
    qh = q.transpose(1, 2)  # [b, h, w, d]
    if products == "tf32_mma":
        pos = torch.arange(L)
        pages = tbl.long()[:, pos // page].clamp(0, num_pages - 1)  # [b, L]
        k_raw = k8[pages, pos % page].float()  # [b, L, h, d]: int8 values, exact in TF32
        v_raw = v8[pages, pos % page].float()
        ks_pos = ks[pages].transpose(1, 2)  # [b, h, L]
        vs_pos = vs[pages].transpose(1, 2)
        q_big, q_small = _tf32_split(qh)
        # each key's score chain starts afresh at its page, so the chains of
        # every page run at once: one batched product per k8 step and pass
        raw_all = torch.zeros(b, h, w, L)
        for c in range(0, d, 8):
            for x in (q_small, q_big):
                y = k_raw[..., c:c + 8].permute(0, 2, 3, 1).double()  # [b, h, 8, L]
                raw_all = _round_toward_zero(raw_all.double() + x[..., c:c + 8].double() @ y)
    parts = []
    for lo in range(0, splits * span, span):
        m = torch.full((b, h, w), -1e30, dtype=torch.float64)
        l = torch.zeros(b, h, w, dtype=torch.float64)
        acc = torch.zeros(b, h, w, d, dtype=torch.float64)
        hi = min(lo + span, L)
        step = page if products == "tf32_mma" else 32
        for k0, k1 in ((k0, min(k0 + step, hi)) for k0 in range(lo, hi, step)):
            seen = vis[..., k0:k1]
            kk, vv = kst[:, k0:k1].transpose(1, 2), vst[:, k0:k1].transpose(1, 2)  # [b, h, n, d]
            if products == "tf32_mma":
                s = ((raw_all[..., k0:k1] * ks_pos[..., None, k0:k1]) * scale).double()
            else:
                s = _fp32_dot4(qh[:, :, :, None, :], kk[:, :, None, :, :]).double().sum(-1) * scale
            s = s.masked_fill(~seen, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp((m - m_new).float()).double()
            p = torch.where(seen, torch.exp((s - m_new[..., None]).float()), torch.zeros(()))
            l = l * corr + p.double().sum(-1)
            if products == "tf32_mma":
                pv_big, pv_small = _tf32_split(p * vs_pos[..., None, k0:k1])
                part = torch.zeros(b, h, w, d)
                for r in range(0, k1 - k0, 8):
                    vr = v_raw[:, k0 + r:min(k0 + r + 8, k1)].transpose(1, 2).double()  # [b, h, <= 8, d]
                    for x in (pv_small, pv_big):
                        part = _round_toward_zero(part.double() + x[..., r:r + 8].double() @ vr)
                acc = acc * corr[..., None] + part.double()
            else:
                n4 = -(-(k1 - k0) // 4) * 4
                pp = torch.nn.functional.pad(p, (0, n4 - (k1 - k0)))
                vp = torch.nn.functional.pad(vv, (0, 0, 0, n4 - (k1 - k0)))
                prod = pp[..., :, None] * vp[:, :, None]  # [b, h, w, n4, d]
                prod = prod.unflatten(-2, (-1, 4))
                four = ((prod[..., 0, :] + prod[..., 1, :]) + prod[..., 2, :]) + prod[..., 3, :]
                acc = acc * corr[..., None] + four.double().sum(-2)
            m = m_new
        parts.append((m.float(), l.float(), acc.float()))
    return _merge_splits(parts).transpose(1, 2)


@pytest.mark.parametrize("w", [13, 16])
@pytest.mark.parametrize("page", [16, 32])
def test_int8_tree_model_matches_plain_fp64_and_pallas(page, w):
    """#9 on the split-KV body in its arithmetic order (CUDA-core
    products from dequantized rows, fp64 running sums, the fp32 split
    merge) against #9's plain version (atol 1e-5, chip_smoke.py's
    ATOL_SPEC_KERNEL), float64 (no further than the plain version is) and
    the Pallas kernel in interpret mode at 32-row pages, with a scale-0
    page, a sentinel hole and a dead row that gives exactly 0."""
    pools, mask, kern = _quant_tree_case(w, page)
    q, k8, v8, ks, vs, tbl, lens = _t(*pools)
    mask = _t(mask)[0]
    ours = _int8_tree_model(q, k8, v8, ks, vs, tbl, lens, mask)
    ref = dk.paged_flash_verify_tree_quant_ref(q, k8, v8, ks, vs, tbl, lens, mask)
    exact = dk.paged_flash_verify_tree_quant_ref(q.double(), k8, v8, ks, vs, tbl, lens, mask)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)
    assert float((ours.double() - exact).abs().max()) <= float((ref.double() - exact).abs().max()) + 1e-6
    if kern is not None:
        np.testing.assert_allclose(ours.numpy(), kern, atol=ATOL)
    assert float(ours[3].abs().max()) == 0.0 and bool(torch.isfinite(ours).all())


def _smoke_int8_tree(w, **shape):
    """#9's operands as chip_smoke.py's gates read them (kernel_inputs: at
    the serving shape 8 sequences x 16 heads x 64, max_len 512, 16-row
    pages; lengths 0, max_len - w and random, a sentinel hole, a dead
    row, a scale-0 page and a random draft tree per row), on the CPU."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x = smoke.kernel_inputs("cpu", w, **shape)
    return list(smoke.decode_args(x, "paged_flash_verify_tree_quant"))


def test_int8_tree_products_chosen_by_their_cpu_model():
    """Why a redesign of #9 keeps its products on the CUDA cores: on the
    inputs of chip_smoke.py's gates at w = 13, at the serving shape and at
    check_split_body_edges' head_dim-256 edge (2 heads, max_len 250,
    2-row pages), the model of TF32 mma.sync products (int8 values exact
    in TF32, Q and P vs split in two TF32 passes, sums rounding toward
    zero, fresh accumulators per page, fp64 running sums) lands further
    than ATOL_SPEC_KERNEL (1e-5) from the plain version at the edge, where
    the CUDA-core order stays within it at both and closer to float64
    than the plain version."""
    worst = {"cuda_cores": 0.0, "tf32_mma": 0.0}
    for shape in ({}, dict(h=2, d=256, max_len=250, page=2, num_pages=8 * 125)):
        args = _smoke_int8_tree(13, **shape)
        ref = dk.paged_flash_verify_tree_quant_ref(*args)
        exact = dk.paged_flash_verify_tree_quant_ref(args[0].double(), *args[1:])
        for products in worst:
            ours = _int8_tree_model(*args, products=products)
            worst[products] = max(worst[products], float((ours - ref).abs().max()))
            if products == "cuda_cores":
                assert float((ours.double() - exact).abs().max()) < float((ref.double() - exact).abs().max())
    assert worst["cuda_cores"] <= ATOL < worst["tf32_mma"]
