"""flexflow_tpu_torch on a CUDA card: the hand-written decode and flash
kernels against their plain PyTorch versions, launch counting, a small
model served through both KV layouts and a small model trained through
the flash kernels. Every test here needs the card and skips without one
(the kernels have no CPU mode).

This file imports no jax, so it also runs where only torch is
installed: `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
Tolerances: the decode kernels atol 1e-4 — fp32 kernels against fp32
plain versions, which differ in summation order only. The flash kernels
#1-#3 at the reference's own scale (tests/test_flash_kernel.py): O and
LSE atol 2e-5 (the reference's bound taken as absolute, with no relative
term, so that no entry's bound exceeds the decode kernels' 1e-4), dQ, dK
and dV atol 5e-5 and rtol 5e-4. Their bf16 bodies (mixed precision)
against float64 of the same bf16 inputs, beside their plain versions
(the gate is stated above `_bf16_ulp`)."""

import os
import sys

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType, SGDOptimizer
from flexflow_tpu_torch.models import build_decoder_lm, build_transformer_encoder
from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk
from flexflow_tpu_torch.serving import ServeConfig

pytestmark = pytest.mark.cuda

ATOL = 1e-4  # decode kernels #4-#9
FWD_TOL = 2e-5  # flash forward #1: O and LSE, absolute
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4  # flash backward #2, #3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, dev, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def _flash_launches(**counts):
    """fk.LAUNCHES as it must read: `counts`, every other kernel 0."""
    return dict(dict.fromkeys(fk.LAUNCHES, 0), **counts)


@pytest.mark.parametrize("w", [1, 5])
def test_kernels_match_plain_versions(w):
    """Both kernels at serving widths (16 heads x 64) with lengths 0,
    mid and max_len - w, sentinel pages past each length, a sentinel
    hole and a dead row; one launch counted per call."""
    dev = _card()
    rng = np.random.default_rng(w)
    b, h, d, max_len, page, num_pages = 6, 16, 64, 128, 16, 48
    lengths = np.array([0, 5, max_len - w, 30, 64, 9], dtype=np.int32)
    q = _rand(rng, dev, b, w, h, d)
    k, v = _rand(rng, dev, b, max_len, h, d), _rand(rng, dev, b, max_len, h, d)
    lens = torch.from_numpy(lengths).to(dev)
    tables = np.full((b, max_len // page), num_pages, dtype=np.int32)
    perm = list(rng.permutation(num_pages))
    for i, ln in enumerate(lengths):
        for p in range(-(-(int(ln) + w) // page)):
            tables[i, p] = perm.pop()
    tables[3, 1] = num_pages  # hole
    tables[5, :] = num_pages  # dead row
    tbl = torch.from_numpy(tables).to(dev)
    kp, vp = _rand(rng, dev, num_pages, page, h, d), _rand(rng, dev, num_pages, page, h, d)
    dk.reset_launches()
    out = dk.flash_verify(q, k, v, lens)
    pout = dk.paged_flash_verify(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), flash_verify=1, paged_flash_verify=1)
    torch.testing.assert_close(out, dk.flash_verify_ref(q, k, v, lens), atol=ATOL, rtol=0)
    torch.testing.assert_close(pout, dk.paged_flash_verify_ref(q, kp, vp, tbl, lens), atol=ATOL, rtol=0)
    assert float(pout[5].abs().max()) == 0.0


@pytest.mark.parametrize("w", [1, 5, 13, 64])
def test_quant_and_tree_kernels_match_plain_versions(w):
    """#6-#9 at serving widths (16 heads x 64, 16-row pages) with ragged
    lengths, a sentinel hole, a dead row, a scale-0 page and a seeded
    random tree per row; one launch counted per call."""
    from flexflow_tpu_torch.ops.attention import tree_allowed_mask

    dev = _card()
    rng = np.random.default_rng(100 + w)
    b, h, d, max_len, page, num_pages = 6, 16, 64, 256, 16, 128
    lengths = np.array([0, 5, max_len - w, 30, 77, 9], dtype=np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    tables = np.full((b, max_len // page), num_pages, dtype=np.int32)
    perm = list(rng.permutation(num_pages))
    for i, ln in enumerate(lengths):
        for p in range(-(-(int(ln) + w) // page)):
            tables[i, p] = perm.pop()
    tables[3, 1] = num_pages  # hole
    tables[5, :] = num_pages  # dead row
    tbl = torch.from_numpy(tables).to(dev)
    q = _rand(rng, dev, b, w, h, d)
    k, v = _rand(rng, dev, b, max_len, h, d), _rand(rng, dev, b, max_len, h, d)
    kp, vp = _rand(rng, dev, num_pages, page, h, d), _rand(rng, dev, num_pages, page, h, d)
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, (num_pages, page, h, d)).astype(np.int8)).to(dev)
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.05, (num_pages, h)).astype(np.float32)).to(dev)
              for _ in range(2))
    ks[tables[0, 0]] = 0.0  # a page never written
    vs[tables[0, 0]] = 0.0
    par = np.full((b, w), -1, dtype=np.int32)
    for j in range(1, w):
        par[:, j] = rng.integers(0, j, size=b)
    mask = tree_allowed_mask(torch.from_numpy(par).to(dev), lens, w, max_len)
    calls = {
        "paged_flash_verify_quant": (q, k8, v8, ks, vs, tbl, lens),
        "flash_verify_tree": (q, k, v, lens, mask),
        "paged_flash_verify_tree": (q, kp, vp, tbl, lens, mask),
        "paged_flash_verify_tree_quant": (q, k8, v8, ks, vs, tbl, lens, mask),
    }
    dk.reset_launches()
    outs = {name: getattr(dk, name)(*args) for name, args in calls.items()}
    torch.cuda.synchronize()
    assert dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), **dict.fromkeys(calls, 1))
    for name, args in calls.items():
        ref = getattr(dk, name + "_ref")(*args)
        torch.testing.assert_close(outs[name], ref, atol=ATOL, rtol=0, msg=name)
    assert float(outs["paged_flash_verify_tree_quant"][5].abs().max()) == 0.0


def _tree_operands(rng, dev, b, w, h, d, max_len, page, lengths, hole_row, dead_row):
    """Caches, pools with a table per row (sentinels past each length, a
    sentinel hole in `hole_row` and a dead `dead_row`) and a seeded random
    draft tree per row, for #7 and #8."""
    from flexflow_tpu_torch.ops.attention import tree_allowed_mask

    num_pages = b * (max_len // page) + 8
    tables = np.full((b, max_len // page), num_pages, dtype=np.int32)
    perm = list(rng.permutation(num_pages))
    for i, ln in enumerate(lengths):
        for p in range(-(-(int(ln) + w) // page)):
            tables[i, p] = perm.pop()
    tables[hole_row, 1] = num_pages
    tables[dead_row, :] = num_pages
    lens = torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(dev)
    par = np.full((b, w), -1, dtype=np.int32)
    for j in range(1, w):
        par[:, j] = rng.integers(0, j, size=b)
    return dict(
        q=_rand(rng, dev, b, w, h, d),
        k=_rand(rng, dev, b, max_len, h, d),
        v=_rand(rng, dev, b, max_len, h, d),
        kp=_rand(rng, dev, num_pages, page, h, d),
        vp=_rand(rng, dev, num_pages, page, h, d),
        tbl=torch.from_numpy(tables).to(dev),
        lens=lens,
        mask=tree_allowed_mask(torch.from_numpy(par).to(dev), lens, w, max_len),
    )


def _check_tree_body(x, dead_row):
    """#7 and #8 once each: one launch counted per call, both within atol
    1e-5 of their plain versions (summation order only), finite, the dead
    row exactly 0, and the arrival counters back at zero."""
    dk.reset_launches()
    out = dk.flash_verify_tree(x["q"], x["k"], x["v"], x["lens"], x["mask"])
    pout = dk.paged_flash_verify_tree(x["q"], x["kp"], x["vp"], x["tbl"], x["lens"], x["mask"])
    torch.cuda.synchronize()
    assert dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), flash_verify_tree=1, paged_flash_verify_tree=1)
    assert all(int(c.abs().sum()) == 0 for c in dk._counters.values())
    ref = dk.flash_verify_tree_ref(x["q"], x["k"], x["v"], x["lens"], x["mask"])
    pref = dk.paged_flash_verify_tree_ref(x["q"], x["kp"], x["vp"], x["tbl"], x["lens"], x["mask"])
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(pout).all())
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(pout, pref, atol=1e-5, rtol=0)
    assert float(pout[dead_row].abs().max()) == 0.0


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("w", [1, 13, 33, 64])
def test_tree_body_matches_plain_versions(w, d):
    """#7 and #8 on the split-KV tree body at 8 sequences x 16 heads,
    max_len 512, 16-row pages: lengths 0 and max_len - w, a visible range
    ending exactly on a split boundary and one a row short of it, a
    length on the boundary, a sentinel hole and a dead row."""
    dev = _card()
    rng = np.random.default_rng(200 + w + d)
    b, h, max_len, page = 8, 16, 512, 16
    splits, span = dk.pick_splits(b, h, max_len, page, dk._sm_count(torch.cuda.current_device()))
    assert splits > 1
    edge = span * (splits // 2)
    lengths = [0, max_len - w, edge - w, edge - w - 1, edge, 77, 300, 9]
    _check_tree_body(_tree_operands(rng, dev, b, w, h, d, max_len, page, lengths, hole_row=5, dead_row=7), 7)


@pytest.mark.parametrize("max_len", [62, 250])
@pytest.mark.parametrize("d", [16, 96, 160])
def test_tree_body_takes_ragged_shapes(d, max_len):
    """Head dims short of the tile (16, 96, 160), 2-row pages, a max_len that
    is no multiple of 4 or of the split (mask rows read bytewise), one
    split (62) or several (250)."""
    dev = _card()
    rng = np.random.default_rng(300 + d + max_len)
    b, w, h, page = 5, 5, 2, 2
    lengths = [0, max_len - w, min(64, max_len) - w, min(64, max_len) - w - 1, 30]
    _check_tree_body(_tree_operands(rng, dev, b, w, h, d, max_len, page, lengths, hole_row=2, dead_row=4), 4)


def _int8_pools(rng, dev, x, page, scale0_row=0):
    """int8 pools of x's pool shape with one random scale per (page,
    head), the first page of `scale0_row` never written (scale 0)."""
    num_pages, _, h, d = x["kp"].shape
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, (num_pages, page, h, d)).astype(np.int8)).to(dev)
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.05, (num_pages, h)).astype(np.float32)).to(dev)
              for _ in range(2))
    first = int(x["tbl"][scale0_row, 0])
    ks[first] = vs[first] = 0.0
    return dict(x, k8=k8, v8=v8, ks=ks, vs=vs)


def _check_split_body(name, args, atol, dead_row):
    """One kernel twice on the same operands: two launches counted under
    `name` and none under any other name, the arrival counters back at
    zero, finite, within `atol` of the plain version, bit-identical across
    the two calls, and the dead row (None: there is none) exactly 0."""
    fn, ref_fn = getattr(dk, name), getattr(dk, name + "_ref")
    dk.reset_launches()
    out, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), **{name: 2})
    assert all(int(c.abs().sum()) == 0 for c in dk._counters.values())
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref_fn(*args), atol=atol, rtol=0)
    assert torch.equal(out, again)
    assert dead_row is None or float(out[dead_row].abs().max()) == 0.0


# (max_len, page): the serving shape, and a ragged max_len at 2-row pages
SPLIT_BODY_SHAPES = [(512, 16), (250, 2)]


def _split_body_operands(w, d, max_len, page, seed):
    """8 sequences (16 heads at max_len 512, else 2) with lengths 0 and
    max_len - w, a visible range ending on a split boundary and one a row
    short of it (each length within [0, max_len - w]), a sentinel hole
    (row 5), a dead row (7), and fp32 and int8 pools (scale 0 on row 0's
    first page)."""
    dev = _card()
    rng = np.random.default_rng(seed)
    b, h = 8, 16 if max_len == 512 else 2
    splits, span = dk.pick_splits(b, h, max_len, page, dk._sm_count(torch.cuda.current_device()))
    edge = span * max(1, splits // 2)
    lengths = [min(max(n, 0), max_len - w) for n in (0, max_len - w, edge - w, edge - w - 1, edge, 77, 100, 9)]
    x = _tree_operands(rng, dev, b, w, h, d, max_len, page, lengths, hole_row=5, dead_row=7)
    return _int8_pools(rng, dev, x, page)


@pytest.mark.parametrize("max_len,page", SPLIT_BODY_SHAPES)
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("w", [1, 5, 13, 64])
def test_paged_verify_on_the_split_body_matches_plain_version(w, d, max_len, page):
    """#5 (the staircase; at w = 1 the one-row tile) on the split-KV body
    of tree_kernel.cu at head_dim 16-256, atol 1e-4."""
    x = _split_body_operands(w, d, max_len, page, 400 + w + d + page)
    _check_split_body("paged_flash_verify", (x["q"], x["kp"], x["vp"], x["tbl"], x["lens"]), ATOL, 7)


def _dead_contiguous(x, w):
    """x's lengths with row 7 at -w: on the contiguous cache (no pages to
    leave unallocated) the row whose staircase sees no position."""
    lens = x["lens"].clone()
    lens[7] = -w
    return lens


@pytest.mark.parametrize("max_len,page", SPLIT_BODY_SHAPES)
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("w", [1, 5, 13, 64])
def test_contiguous_decode_on_the_split_body_matches_plain_version(w, d, max_len, page):
    """#4 (the staircase on the contiguous cache; at w = 1 the one-row
    tile) on the split-KV body of tree_kernel.cu at head_dim 16-256, atol
    1e-4; row 7 sees nothing (length -w) and gives exactly 0."""
    x = _split_body_operands(w, d, max_len, page, 800 + w + d + page)
    _check_split_body("flash_verify", (x["q"], x["k"], x["v"], _dead_contiguous(x, w)), ATOL, 7)


@pytest.mark.parametrize("max_len,page", SPLIT_BODY_SHAPES)
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("w", [1, 5, 13, 64])
def test_int8_decode_on_the_split_body_matches_plain_version(w, d, max_len, page):
    """#6 (the staircase on int8 pools; at w = 1 the int8 one-row tile)
    on the split-KV body of tree_kernel.cu at head_dim 16-256, with a
    scale-0 page: within 1e-5 of the plain version at head_dim 64 (the
    serving path's, chip_smoke.py's gate), 1e-4 elsewhere, as #9."""
    x = _split_body_operands(w, d, max_len, page, 900 + w + d + page)
    args = (x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"])
    _check_split_body("paged_flash_verify_quant", args, 1e-5 if d == 64 else ATOL, 7)


@pytest.mark.parametrize("max_len,page", SPLIT_BODY_SHAPES)
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("w", [1, 13, 33, 64])
def test_int8_tree_verify_on_the_split_body_matches_plain_version(w, d, max_len, page):
    """#9 (int8 pools, a seeded random tree per row) on the split-KV body
    of tree_kernel.cu at head_dim 16-256, with a scale-0 page, atol 1e-4
    as every decode kernel here: the staged rows equal the plain
    version's dequant, so only summation order differs, but over 128-256
    columns of values up to 127 x 0.05 that order moves the output by up
    to ~2.5e-5 (1e-5 holds at head_dim 64, chip_smoke.py's shape)."""
    x = _split_body_operands(w, d, max_len, page, 500 + w + d + page)
    args = (x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"], x["mask"])
    _check_split_body("paged_flash_verify_tree_quant", args, ATOL, 7)


@pytest.mark.parametrize("w", [1, 5, 13, 33, 64])
def test_paged_verify_past_256_runs_where_it_ran_before(w):
    """head_dim 320, past the split body's tiles: #4, #5 and #6 (w 1, 5,
    13, 33, 64) and #9 (w 1, 13, 33, 64) run on decode_kernel.cu's body,
    counted under their own names, within 1e-4 of their plain versions.
    w = 64 included: that body stages head_dim in 64-column pieces, so
    its shared memory no longer grows with head_dim (it refused w = 64
    at 320 before)."""
    d, max_len, page = 320, 128, 16
    x = _split_body_operands(w, d, max_len, page, 600 + w)
    calls = {
        "flash_verify": ((x["q"], x["k"], x["v"], _dead_contiguous(x, w)), ATOL),
        "paged_flash_verify": ((x["q"], x["kp"], x["vp"], x["tbl"], x["lens"]), ATOL),
        "paged_flash_verify_quant": ((x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"]), ATOL),
        "paged_flash_verify_tree_quant": (
            (x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"], x["mask"]), ATOL),
    }
    for name, (args, atol) in calls.items():
        if name != "paged_flash_verify_tree_quant" or w != 5:
            _check_split_body(name, args, atol, 7)


@pytest.mark.parametrize("w", [1, 13, 33, 64])
def test_tree_verify_past_256_runs_on_the_decode_body(w):
    """head_dim 320, past the split body's tiles: the fp32 tree verifies
    #7 and #8 run on decode_kernel.cu's body (its kTree variants) for w
    up to 64, within 1e-4 of their plain versions, counted under their
    own names (w = 64 raised before the body staged head_dim in pieces)."""
    x = _split_body_operands(w, 320, 128, 16, 650 + w)
    contig = (x["q"], x["k"], x["v"], x["lens"], x["mask"])
    paged = (x["q"], x["kp"], x["vp"], x["tbl"], x["lens"], x["mask"])
    _check_split_body("flash_verify_tree", contig, ATOL, None)
    _check_split_body("paged_flash_verify_tree", paged, ATOL, 7)


@pytest.mark.parametrize("d", [256, 320])
def test_paged_verify_picks_its_body_by_head_dim_alone(monkeypatch, d):
    """Every decode kernel (#4-#9) goes to the split body (_launch_tree)
    at head_dim <= 256 and to decode_kernel.cu's body (_launch) past it,
    whatever the width, and a call launches exactly one of them."""
    calls = []
    for fn in ("_launch", "_launch_tree"):
        real = getattr(dk, fn)
        monkeypatch.setattr(dk, fn, lambda *a, _f=fn, _r=real, **k: calls.append(_f) or _r(*a, **k))
    want = "_launch_tree" if d <= dk._TREE_MAX_D else "_launch"
    for w in (1, 13):
        x = _split_body_operands(w, d, 128, 16, 700 + w + d)
        dk.flash_verify(x["q"], x["k"], x["v"], x["lens"])
        dk.paged_flash_verify(x["q"], x["kp"], x["vp"], x["tbl"], x["lens"])
        dk.paged_flash_verify_quant(x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"])
        dk.flash_verify_tree(x["q"], x["k"], x["v"], x["lens"], x["mask"])
        dk.paged_flash_verify_tree(x["q"], x["kp"], x["vp"], x["tbl"], x["lens"], x["mask"])
        dk.paged_flash_verify_tree_quant(x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"], x["mask"])
    torch.cuda.synchronize()
    assert calls == [want] * 12


def test_quant_and_tree_kernels_reject_what_they_do_not_take():
    """w = 65, head_dim 4 on int8 pools (no multiple of 8; head_dim 8 is
    taken in 8-byte loads and runs), fp32 pools where int8 is expected,
    misshapen scales, a strided mask and int64 tables raise before a
    launch, on the split body that #4-#9 take at head_dim <= 256 (#6's
    cases first, then #7's, then #4's, #5's and #9's)."""
    dev = _card()
    b, h, d, page, num_pages = 2, 2, 64, 16, 8
    lens = torch.zeros(b, dtype=torch.int32, device=dev)
    tbl = torch.zeros(b, 2, dtype=torch.int32, device=dev)
    k8 = torch.zeros(num_pages, page, h, d, dtype=torch.int8, device=dev)
    ks = torch.zeros(num_pages, h, device=dev)
    k32 = torch.zeros(b, 2 * page, h, d, device=dev)
    dk.reset_launches()
    with pytest.raises(ValueError, match="w="):
        dk.paged_flash_verify_quant(torch.zeros(b, 65, h, d, device=dev), k8, k8, ks, ks, tbl, lens)
    with pytest.raises(ValueError, match="w="):
        wide = torch.zeros(b, 65, h, d, device=dev)
        dk.flash_verify_tree(wide, k32, k32, lens, torch.ones(b, 65, 2 * page, dtype=torch.bool, device=dev))
    q = torch.zeros(b, 1, h, d, device=dev)
    k8n = torch.zeros(num_pages, page, h, 8, dtype=torch.int8, device=dev)
    out = dk.paged_flash_verify_quant(q[..., :8].contiguous(), k8n, k8n, ks, ks, tbl, lens)
    assert out.shape == (b, 1, h, 8) and dk.LAUNCHES["paged_flash_verify_quant"] == 1
    dk.reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        k8q = torch.zeros(num_pages, page, h, 4, dtype=torch.int8, device=dev)
        dk.paged_flash_verify_quant(q[..., :4].contiguous(), k8q, k8q, ks, ks, tbl, lens)
    with pytest.raises(TypeError):
        kf = torch.zeros(num_pages, page, h, d, device=dev)
        dk.paged_flash_verify_quant(q, kf, kf, ks, ks, tbl, lens)
    with pytest.raises(ValueError, match="k_scale"):
        dk.paged_flash_verify_quant(q, k8, k8, ks[:, :1], ks, tbl, lens)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.ones(b, 1, 4 * page, dtype=torch.bool, device=dev)[..., ::2]
        dk.flash_verify_tree(q, k32, k32, lens, strided)
    # #5 and #9 on the split body check the same before their launch
    kf32 = torch.zeros(num_pages, page, h, d, device=dev)
    allowed = torch.ones(b, 1, 2 * page, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="w="):
        dk.paged_flash_verify(torch.zeros(b, 65, h, d, device=dev), kf32, kf32, tbl, lens)
    with pytest.raises(ValueError, match="w="):
        wide_mask = torch.ones(b, 65, 2 * page, dtype=torch.bool, device=dev)
        dk.paged_flash_verify_tree_quant(torch.zeros(b, 65, h, d, device=dev), k8, k8, ks, ks, tbl, lens, wide_mask)
    mask8 = torch.ones(b, 1, 2 * page, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        dk.paged_flash_verify_tree_quant(q[..., :4].contiguous(), k8q, k8q, ks, ks, tbl, lens, mask8)
    with pytest.raises(TypeError):
        dk.paged_flash_verify_tree_quant(q, kf32, kf32, ks, ks, tbl, lens, allowed)
    with pytest.raises(ValueError, match="k_scale"):
        dk.paged_flash_verify_tree_quant(q, k8, k8, ks[:, :1], ks, tbl, lens, allowed)
    with pytest.raises(ValueError, match="contiguous"):
        dk.paged_flash_verify_tree_quant(q, k8, k8, ks, ks, tbl, lens, strided)
    with pytest.raises(ValueError, match="int32"):
        dk.paged_flash_verify(q, kf32, kf32, tbl.long(), lens)
    with pytest.raises(ValueError, match="w="):
        dk.flash_verify(torch.zeros(b, 65, h, d, device=dev), k32, k32, lens)
    with pytest.raises(ValueError, match="int32"):
        dk.flash_verify(q, k32, k32, lens.long())
    assert sum(dk.LAUNCHES.values()) == 0


# -- bf16 q (mixed precision) and int8 rows in 8-byte loads ---------------------------
# A bf16-q kernel and its plain version both compute the fp32 function of
# the widened q and round it to bf16 once, so they agree within one bf16
# ulp of each entry beyond the fp32 kernels' own ATOL (summation order).


def _assert_bf16_q_close(out, ref, what):
    assert out.dtype == ref.dtype == torch.bfloat16, (what, out.dtype, ref.dtype)
    assert bool(torch.isfinite(out).all()), what
    a, p = out.double(), ref.double()
    big = torch.maximum(a.abs(), p.abs()).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool(((a - p).abs() <= ulp + ATOL).all()), (what, float((a - p).abs().max()))


def _decode_calls(x):
    """The six entry points' operands on _split_body_operands x: row 7 is
    dead in each (its pages all sentinels; on the contiguous cache its
    length -w, whose chunk gate lets no position through)."""
    dead = _dead_contiguous(x, x["q"].shape[1])
    return {
        "flash_verify": (x["q"], x["k"], x["v"], dead),
        "paged_flash_verify": (x["q"], x["kp"], x["vp"], x["tbl"], x["lens"]),
        "paged_flash_verify_quant": (x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"]),
        "flash_verify_tree": (x["q"], x["k"], x["v"], dead, x["mask"]),
        "paged_flash_verify_tree": (x["q"], x["kp"], x["vp"], x["tbl"], x["lens"], x["mask"]),
        "paged_flash_verify_tree_quant": (x["q"], x["k8"], x["v8"], x["ks"], x["vs"], x["tbl"], x["lens"], x["mask"]),
    }


@pytest.mark.parametrize("d", [16, 64, 128, 256, 320])
@pytest.mark.parametrize("w", [1, 5, 13, 64])
def test_bf16_q_decode_kernels_match_plain_versions(w, d):
    """All six decode kernels at bf16 q against fp32 and int8 pools (the
    split-KV body up to head_dim 256, decode_kernel.cu's past it), with
    the split-body edges of _split_body_operands (lengths 0 and max_len -
    w, split boundaries, a hole, a dead row, a scale-0 page): bf16 out,
    within one bf16 ulp of the plain version, bit-identical across two
    calls, the dead row 0, two launches counted under name + "_bf16" and
    none under the fp32-q name."""
    x = _split_body_operands(w, d, 512 if d <= 256 else 128, 16, 1000 + w + d)
    x = dict(x, q=x["q"].bfloat16())
    for name, args in _decode_calls(x).items():
        fn, ref_fn = getattr(dk, name), getattr(dk, name + "_ref")
        dk.reset_launches()
        out, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), **{name + "_bf16": 2}), name
        assert all(int(c.abs().sum()) == 0 for c in dk._counters.values())
        _assert_bf16_q_close(out, ref_fn(*args), f"{name} w={w} d={d}")
        assert torch.equal(out, again), name
        assert float(out[7].float().abs().max()) == 0.0, name


@pytest.mark.parametrize("d", [8, 16, 24, 40, 320])
@pytest.mark.parametrize("w", [1, 5, 13, 64])
def test_int8_rows_in_8_byte_loads_match_plain_versions(w, d):
    """#6 and #9 where the int8 rows are 8-byte but not 16-byte aligned:
    head_dim 8, 24 and 40 (an odd number of 8-byte words; the reference
    takes any multiple of 8), and head_dim 16 and 320 read through a view
    whose rows lie 24 (336) bytes apart; within 1e-4 of the plain
    versions, fp32 and bf16 q."""
    x = _split_body_operands(w, d, 250, 2, 1100 + w + d)
    if d in (16, 320):  # the same values in pools whose rows are 8 bytes longer
        for name in ("k8", "v8"):
            t = x[name]
            wide = torch.zeros(*t.shape[:-1], d + 8, dtype=torch.int8, device=t.device)
            wide[..., :d] = t
            x[name] = wide[..., :d]
    assert not dk._int8_vec16(x["k8"], x["v8"])
    for q in (x["q"], x["q"].bfloat16()):
        y = dict(x, q=q)
        calls = _decode_calls(y)
        for name in ("paged_flash_verify_quant", "paged_flash_verify_tree_quant"):
            out = getattr(dk, name)(*calls[name])
            ref = getattr(dk, name + "_ref")(*calls[name])
            if q.dtype == torch.bfloat16:
                _assert_bf16_q_close(out, ref, f"{name} w={w} d={d}")
            else:
                torch.testing.assert_close(out, ref, atol=ATOL, rtol=0, msg=f"{name} w={w} d={d}")
            assert float(out[7].float().abs().max()) == 0.0


def test_mixed_precision_lm_serves_through_the_bf16_q_kernels():
    """A 2-layer LM compiled with allow_mixed_precision serves on the card
    through every layout, pool and mode: each leg's bf16-q kernel
    launches steps x layers times and no fp32-q decode kernel launches,
    every stream finishes at full length, and graph windows give the
    eager streams token for token."""
    from flexflow_tpu_torch.serving import Request, build_scheduler

    _card()
    layers = 2
    model = FFModel(FFConfig(batch_size=4, seed=0, allow_mixed_precision=True))
    tok = model.create_tensor([4, 64], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(model, tok, vocab_size=128, hidden=64, num_heads=4, num_layers=layers, ff_dim=128)
    model.compile()
    tree = dict(spec_draft="ngram", spec_k=3, spec_branch=2)
    legs = {
        "flash_verify": dict(kv_layout="slot"),
        "paged_flash_verify": {},
        "paged_flash_verify_quant": dict(kv_dtype="int8"),
        "flash_verify_tree": dict(kv_layout="slot", **tree),
        "paged_flash_verify_tree": dict(tree),
        "paged_flash_verify_tree_quant": dict(kv_dtype="int8", **tree),
    }
    prompts = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [10, 11], [12]]
    streams = {}
    for kernel, kw in legs.items():
        for fused in (False, True) if "spec_draft" not in kw else (False,):
            sched, _, _ = build_scheduler(
                model, ServeConfig(max_seqs=2, max_seq_len=64, decode_multistep=fused, **kw)
            )
            dk.reset_launches()
            done = sched.run([Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            assert all(r.ok and len(r.generated) == 16 for r in done), kernel
            steps = sched.stats.verify_steps if "spec_draft" in kw else sched.stats.decode_steps
            assert dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), **{kernel + "_bf16": steps * layers}), kernel
            streams[kernel, fused] = {r.rid: r.generated for r in done}
    for kernel in ("flash_verify", "paged_flash_verify", "paged_flash_verify_quant"):
        assert streams[kernel, True] == streams[kernel, False], kernel


def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    q = torch.zeros(1, 1, 2, 16, device=dev)
    k = torch.zeros(1, 8, 2, 16, device=dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        dk.flash_verify(q.half(), k.half(), k.half(), lens)
    with pytest.raises(ValueError):
        dk.flash_verify(q, k, k, lens.cpu())


def test_small_lm_serves_identically_on_both_layouts():
    dev = _card()
    model = FFModel(FFConfig(batch_size=4, seed=0))
    tok = model.create_tensor([4, 64], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(model, tok, vocab_size=128, hidden=64, num_heads=4, num_layers=2, ff_dim=128)
    model.compile()
    assert model.device.type == "cuda" == dev.type
    prompts = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [10, 11], [12]]
    streams = {}
    for layout in ("slot", "paged"):
        dk.reset_launches()
        streams[layout] = model.generate(
            prompts, max_new_tokens=12,
            serve_config=ServeConfig(max_seqs=2, max_seq_len=64, kv_layout=layout),
        )
        kernel = "flash_verify" if layout == "slot" else "paged_flash_verify"
        assert dk.LAUNCHES[kernel] > 0
    assert streams["slot"] == streams["paged"]
    assert all(len(s) == 12 for s in streams["paged"])
    # speculative decoding (linear and tree) and int8 pools through
    # kernels #6-#9: every stream finishes at full length
    legs = {
        "flash_verify_tree": dict(kv_layout="slot", spec_draft="ngram", spec_k=3, spec_branch=2),
        "paged_flash_verify_tree": dict(spec_draft="ngram", spec_k=3, spec_branch=2),
        "paged_flash_verify_quant": dict(kv_dtype="int8"),
        "paged_flash_verify_tree_quant": dict(kv_dtype="int8", spec_draft="ngram", spec_k=3, spec_branch=2),
    }
    for kernel, kw in legs.items():
        dk.reset_launches()
        out = model.generate(
            prompts, max_new_tokens=12, serve_config=ServeConfig(max_seqs=2, max_seq_len=64, **kw)
        )
        assert dk.LAUNCHES[kernel] > 0 and all(len(s) == 12 for s in out), kernel


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [(2, 256, 256, 4, 64), (2, 200, 77, 3, 128), (1, 96, 160, 2, 8),
     # the reference's test shapes (tests/test_flash_kernel.py)
     (2, 256, 256, 2, 32), (2, 128, 128, 2, 32), (1, 128, 384, 2, 32),
     # head_dims past 128: the wide bodies (all output columns in one
     # block up to 512, 3 chunks at 1032, #1's Q and #2/#3's fixed tile
     # streamed there), 2 to 9 streamed pieces
     (2, 200, 77, 3, 136), (1, 96, 160, 2, 160), (2, 129, 300, 2, 256),
     (2, 129, 300, 2, 264), (2, 300, 129, 2, 320), (1, 200, 77, 2, 512), (1, 200, 200, 2, 1032)],
)
def test_flash_kernels_match_plain_versions(shape, causal):
    """Kernels #1-#3 at ragged and sq != sk shapes and at the reference's
    test shapes, head_dim 8 to 1032; one launch counted per call (the
    wide bodies, past 128, under name + "_wide")."""
    dev = _card()
    b, sq, sk, h, d = shape
    rng = np.random.default_rng(sq + d)
    q, do = _rand(rng, dev, b, sq, h, d), _rand(rng, dev, b, sq, h, d)
    k, v = _rand(rng, dev, b, sk, h, d), _rand(rng, dev, b, sk, h, d)
    fk.reset_launches()
    o, lse = fk.flash_fwd(q, k, v, causal)
    ro, rlse = fk.flash_fwd_ref(q, k, v, causal)
    delta = (do * ro).sum(-1).transpose(1, 2).contiguous()
    dq = fk.flash_dq(q, k, v, do, rlse, delta, causal)
    dk_, dv = fk.flash_dkv(q, k, v, do, rlse, delta, causal)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == _flash_launches(**{name + _wide(d): 1 for name in ("flash_fwd", "flash_dq", "flash_dkv")})
    torch.testing.assert_close(o, ro, atol=FWD_TOL, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=FWD_TOL, rtol=0)
    rdk, rdv = fk.flash_dkv_ref(q, k, v, do, rlse, delta, causal)
    torch.testing.assert_close(dq, fk.flash_dq_ref(q, k, v, do, rlse, delta, causal), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    torch.testing.assert_close(dk_, rdk, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    torch.testing.assert_close(dv, rdv, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _wide(d):
    """The LAUNCHES suffix of the fp32 bodies at head_dim d: the wide
    bodies of #1-#3 past 128."""
    return "_wide" if d > 128 else ""


WIDE_FWD_DIMS = [136, 248, 256, 264, 512, 1032, 1216, 1224]
WIDE_FWD_LENGTHS = [(200, 77), (77, 200), (300, 1), (32, 40), (33, 40)]


@pytest.mark.parametrize("d", WIDE_FWD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", WIDE_FWD_LENGTHS)
def test_flash_wide_forward_matches_plain_version_at_its_edges(sq, sk, causal, d):
    """#1's wide body at its edges: head_dim 136 (a ragged last piece),
    248 and 256 (the last full piece), 264, 512 (one block's widest
    output), 1032 (3 output chunks over grid z), 1216 and 1224 (the
    widest resident Q and the first streamed one); sq != sk with a ragged
    last tile both ways, one visible key (sk 1), one query tile (sq 32)
    and one row past it (sq 33). O and LSE of every row finite and within
    2e-5, one launch under flash_fwd_wide."""
    dev = _card()
    rng = np.random.default_rng(sq * 1000 + sk + d + 11)
    q = _rand(rng, dev, 2, sq, 2, d)
    k, v = _rand(rng, dev, 2, sk, 2, d), _rand(rng, dev, 2, sk, 2, d)
    fk.reset_launches()
    o, lse = fk.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == _flash_launches(flash_fwd_wide=1)
    ro, rlse = fk.flash_fwd_ref(q, k, v, causal)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(o, ro, atol=FWD_TOL, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("d", [136, 256, 320, 512, 1032, 1216, 1224])
def test_flash_wide_forward_fits_the_card(d):
    """#1's wide body with Q resident (136-1216) and streamed (1224):
    no spilled registers, and a block fits an SM."""
    _card()
    occ = fk.occupancy("flash_fwd_wide", d)
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


def _flash_backward_operands(rng, dev, b, sq, sk, h, d, causal):
    q, do = _rand(rng, dev, b, sq, h, d), _rand(rng, dev, b, sq, h, d)
    k, v = _rand(rng, dev, b, sk, h, d), _rand(rng, dev, b, sk, h, d)
    o, lse = fk.flash_fwd_ref(q, k, v, causal)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, causal


MMA_EDGE_DIMS = [8, 16, 24, 40, 64, 96, 128, 136, 160, 256, 320]
MMA_EDGE_LENGTHS = [(1, 1), (15, 17), (17, 15), (65, 200), (200, 65), (1, 200), (200, 1), (65, 65)]


@pytest.mark.parametrize("d", MMA_EDGE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", MMA_EDGE_LENGTHS)
def test_flash_backward_matches_plain_versions_at_mma_edges(sq, sk, causal, d):
    """#2 and #3 where the tiles are ragged against mma's 16 rows and 8
    columns as well as the 64-row and 32-row tiles: sq, sk in {1, 15, 17,
    65, 200}, sk < sq and sk > sq, every head_dim bucket of the mma
    kernels and, past 128, the wide kernels (136 with a ragged last
    piece)."""
    dev = _card()
    args = _flash_backward_operands(np.random.default_rng(sq * 1000 + sk + d), dev, 2, sq, sk, 3, d, causal)
    fk.reset_launches()
    dq = fk.flash_dq(*args)
    dk_, dv = fk.flash_dkv(*args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == _flash_launches(**{"flash_dq" + _wide(d): 1, "flash_dkv" + _wide(d): 1})
    rdk, rdv = fk.flash_dkv_ref(*args)
    torch.testing.assert_close(dq, fk.flash_dq_ref(*args), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    torch.testing.assert_close(dk_, rdk, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    torch.testing.assert_close(dv, rdv, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("d", MMA_EDGE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", MMA_EDGE_LENGTHS)
def test_flash_forward_matches_plain_version_at_mma_edges(sq, sk, causal, d):
    """#1 at the backward's mma edges: O and LSE of every row, rows that
    see one key (causal row 0) included, finite and within 2e-5."""
    dev = _card()
    rng = np.random.default_rng(sq * 1000 + sk + d + 7)
    q = _rand(rng, dev, 2, sq, 3, d)
    k, v = _rand(rng, dev, 2, sk, 3, d), _rand(rng, dev, 2, sk, 3, d)
    fk.reset_launches()
    o, lse = fk.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == _flash_launches(**{"flash_fwd" + _wide(d): 1})
    ro, rlse = fk.flash_fwd_ref(q, k, v, causal)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(o, ro, atol=FWD_TOL, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("d", [64, 256, 320, 1032])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_is_bit_identical_across_calls(causal, d):
    """#1: each output row is written by one block, in a fixed order of
    sums, so two calls on the same inputs give the same bits (past 128
    on the wide body: Q resident at 256 and 320, streamed at 1032)."""
    dev = _card()
    rng = np.random.default_rng(19)
    q, k, v = (_rand(rng, dev, 2, s, 4, d) for s in (300, 260, 260))
    first, second = fk.flash_fwd(q, k, v, causal), fk.flash_fwd(q, k, v, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [24, 64, 128, 320, 1032])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_is_bit_identical_across_calls(causal, d):
    """No atomics: two calls on the same inputs give the same bits (up to
    head_dim 128 on the tf32 bodies, one bucket each at 24, 64 and 128;
    past 256 on the wide kernels, their fixed tile resident at 320 and
    streamed at 1032)."""
    dev = _card()
    args = _flash_backward_operands(np.random.default_rng(9), dev, 2, 300, 260, 4, d, causal)
    first = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    second = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# fp32 #2 and #3 up to head_dim 128 (flash_dq_tf32_kernel,
# flash_dkv_tf32_kernel: the score products on .tf32 wgmma over TMA-fed
# tiles, split once per staged tile) at each bucket's edges: 8 and 32 (one
# 32-column box), 40 and 64 (two), 72 and 128 (four; 40 and 72 with a
# ragged last box); lengths no multiple of a tile, sq != sk both ways, one
# query or one key, and causal blocks of #3 whose keys no query sees
# (sq 65 against sk 300: no loop tile)
TF32_BWD_DIMS = [8, 32, 40, 64, 72, 128]
TF32_BWD_LENGTHS = [(65, 300), (300, 65), (129, 77), (1, 200), (200, 1)]


@pytest.mark.parametrize("d", TF32_BWD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", TF32_BWD_LENGTHS)
def test_flash_tf32_backward_matches_plain_version_and_float64_at_its_edges(sq, sk, causal, d):
    """#2 and #3's tf32 bodies against their plain versions and the
    float64 function of the same inputs, at the reference's gradient
    scale; every entry finite, one launch of each counted under flash_dq
    and flash_dkv, and a second call gives the same bits."""
    dev = _card()
    args = _flash_backward_operands(np.random.default_rng(sq * 1000 + sk + d + 37), dev, 2, sq, sk, 2, d, causal)
    fk.reset_launches()
    got = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    torch.cuda.synchronize()
    assert fk.LAUNCHES == _flash_launches(flash_dq=1, flash_dkv=1)
    plain = (fk.flash_dq_ref(*args), *fk.flash_dkv_ref(*args))
    exact_args = (*(t.double() for t in args[:6]), causal)
    exact = (fk.flash_dq_ref(*exact_args), *fk.flash_dkv_ref(*exact_args))
    again = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    for a, p, e, a2 in zip(got, plain, exact, again):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, p, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        torch.testing.assert_close(a.double(), e, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        assert torch.equal(a, a2)


@pytest.mark.parametrize("d", [24, 64, 128])
def test_flash_tf32_backward_reads_strided_operands(d):
    """#2 and #3's tf32 bodies read [b, s, h, d] views in place through
    their strides (the TMA maps take them), as the wide body's test: the
    gradients are the bits of the same call on contiguous copies."""
    dev = _card()
    rng = np.random.default_rng(d + 41)
    b, sq, sk, h = 2, 200, 77, 2
    q = _rand(rng, dev, b, sq, 2 * h, d)[:, :, ::2]
    k = _rand(rng, dev, b, h, sk, d).transpose(1, 2)
    v = _rand(rng, dev, b, sk, h, d + 16)[..., 8 : 8 + d]
    do = _rand(rng, dev, b, sq, h, d + 16)[..., 16:]
    o, lse = fk.flash_fwd_ref(q, k, v, True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    assert all(fk._readable(t) is t for t in (q, k, v, do))
    views = (q, k, v, do, lse, delta, True)
    dense = (*(t.contiguous() for t in (q, k, v, do)), lse, delta, True)
    got = (fk.flash_dq(*views), *fk.flash_dkv(*views))
    want = (fk.flash_dq(*dense), *fk.flash_dkv(*dense))
    plain = (fk.flash_dq_ref(*dense), *fk.flash_dkv_ref(*dense))
    torch.cuda.synchronize()
    for a, w, p in zip(got, want, plain):
        assert torch.equal(a, w)
        torch.testing.assert_close(a, p, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("d", [8, 32, 64, 72, 128])
def test_flash_tf32_backward_fits_the_card(d):
    """#2 and #3's tf32 bodies at each bucket: no spilled registers or
    other local memory, and a block fits an SM."""
    _card()
    for name in ("flash_dq", "flash_dkv"):
        occ = fk.occupancy(name, d)
        assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, (name, occ)


def test_flash_tf32_backward_issues_wgmma_and_tma_loads():
    """The SASS of #2 and #3's tf32 bodies (a kernel per bucket they take)
    holds wgmma (HGMMA) and TMA loads (UTMALDG), and no cp.async copy
    (LDGSTS); both kernels have one."""
    _card()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    fk._bwd_lib()
    ops = chip_smoke.sass_opcodes(fk.BWD_SOURCE, r"flash_(dq|dkv)_tf32_kernel")
    assert ops is not None and any("dq_tf32" in f for f in ops) and any("dkv_tf32" in f for f in ops), ops
    for fn, c in ops.items():
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["LDGSTS"] == 0, (fn, dict(c))


@pytest.mark.parametrize("d", [136, 256, 320, 512, 520, 1032, 1224])
def test_flash_wide_backward_fits_the_card(d):
    """#2 and #3's fp32 wide body (a producer warpgroup and two consumer
    warpgroups, 384 threads) with the fixed tile resident (136-512, 512
    the widest it is) and streamed (520-1224): no spilled registers or
    other local memory, and one block fits an SM."""
    _card()
    for name in ("flash_dq_wide", "flash_dkv_wide"):
        occ = fk.occupancy(name, d)
        assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1 and occ["threads"] == 384, (name, occ)


# fp32 #2 and #3's wide body at its edges: head_dim 136 (a ragged last TMA
# box), 248 and 256 (the last full piece), 264, 320, 512 (one block's
# widest output and widest resident fixed tile), 520 (the first streamed
# one, 2 output chunks over grid z) and 1032; sq != sk with ragged last
# tiles both ways, and one visible key (sk 1, or causal at sq 1)
WIDE_BWD_DIMS = [136, 248, 256, 264, 320, 512, 520, 1032]
WIDE_BWD_LENGTHS = [(129, 300), (300, 129), (300, 1), (1, 300)]


@pytest.mark.parametrize("d", WIDE_BWD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", WIDE_BWD_LENGTHS)
def test_flash_wide_backward_matches_plain_version_and_float64_at_its_edges(sq, sk, causal, d):
    """#2 and #3's fp32 wide body against its plain version and against the
    float64 function of the same inputs, both at the reference's gradient
    scale; every entry finite, one launch of each counted under
    flash_dq_wide and flash_dkv_wide, and a second call gives the same
    bits."""
    dev = _card()
    args = _flash_backward_operands(np.random.default_rng(sq * 1000 + sk + d + 29), dev, 2, sq, sk, 2, d, causal)
    fk.reset_launches()
    got = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    torch.cuda.synchronize()
    assert fk.LAUNCHES == _flash_launches(flash_dq_wide=1, flash_dkv_wide=1)
    plain = (fk.flash_dq_ref(*args), *fk.flash_dkv_ref(*args))
    exact_args = (*(t.double() for t in args[:6]), causal)
    exact = (fk.flash_dq_ref(*exact_args), *fk.flash_dkv_ref(*exact_args))
    again = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    for a, p, e, a2 in zip(got, plain, exact, again):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, p, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        torch.testing.assert_close(a.double(), e, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        assert torch.equal(a, a2)


@pytest.mark.parametrize("d", [136, 320, 1032])
def test_flash_wide_backward_reads_strided_operands(d):
    """#2 and #3's fp32 wide body reads [b, s, h, d] views in place through
    their strides (the TMA maps take them): q every other head of a
    wider tensor, k a [b, h, s, d] tensor seen as [b, s, h, d], v and dO
    column slices of [b, s, h, d + 16] rows. The gradients are the bits
    of the same call on contiguous copies, within the gate of the plain
    version."""
    dev = _card()
    rng = np.random.default_rng(d + 31)
    b, sq, sk, h = 2, 200, 77, 2
    q = _rand(rng, dev, b, sq, 2 * h, d)[:, :, ::2]
    k = _rand(rng, dev, b, h, sk, d).transpose(1, 2)
    v = _rand(rng, dev, b, sk, h, d + 16)[..., 8 : 8 + d]
    do = _rand(rng, dev, b, sq, h, d + 16)[..., 16:]
    o, lse = fk.flash_fwd_ref(q, k, v, True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    assert all(fk._readable(t) is t for t in (q, k, v, do))
    views = (q, k, v, do, lse, delta, True)
    dense = (*(t.contiguous() for t in (q, k, v, do)), lse, delta, True)
    got = (fk.flash_dq(*views), *fk.flash_dkv(*views))
    want = (fk.flash_dq(*dense), *fk.flash_dkv(*dense))
    plain = (fk.flash_dq_ref(*dense), *fk.flash_dkv_ref(*dense))
    torch.cuda.synchronize()
    for a, w, p in zip(got, want, plain):
        assert torch.equal(a, w)
        torch.testing.assert_close(a, p, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_flash_wide_backward_loads_through_tma_alone():
    """The SASS of #2 and #3's fp32 wide kernels (X resident and streamed)
    holds TMA loads (UTMALDG) and no cp.async copy (LDGSTS): the consumer
    warps issue no copy."""
    _card()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    fk._bwd_lib()
    wide = chip_smoke.sass_opcodes(fk.BWD_SOURCE, r"flash_(dq|dkv)_wide_kernelILb[01]E")
    assert wide is not None and len(wide) == 4, wide
    for fn, ops in wide.items():
        assert ops["UTMALDG"] > 0 and ops["LDGSTS"] == 0 and ops["HMMA"] > 0, (fn, dict(ops))


def test_flash_kernel_rejects_what_it_does_not_take():
    """float16, mixed float32 and bf16 operands, head_dim 60 or 260 (no
    multiple of 8, on either side of 256, in either dtype) and mixed
    devices raise before any launch (bf16 past head_dim 256 runs the bf16
    wide kernels: test_bf16_flash_kernels_past_256_match_plain_versions)."""
    dev = _card()
    fk.reset_launches()
    q = torch.zeros(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        fk.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fk.flash_fwd(q.bfloat16(), q, q.bfloat16())
    odd = torch.zeros(1, 8, 2, 260, device=dev)
    with pytest.raises(ValueError, match="head_dim 260 .* multiple of 8"):
        fk.flash_fwd(odd, odd, odd)
    with pytest.raises(ValueError, match="head_dim 260 .* multiple of 8"):
        fk.flash_fwd(odd.bfloat16(), odd.bfloat16(), odd.bfloat16())
    with pytest.raises(ValueError, match="head_dim 60"):
        fk.flash_fwd(q[..., :60], q[..., :60], q[..., :60])
    with pytest.raises(ValueError):
        fk.flash_fwd(q, q.cpu(), q)
    assert sum(fk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("use_flash", ["auto", True])
def test_mha_raises_where_the_flash_kernels_do_not_take_the_shape(use_flash):
    """On a CUDA tensor the MHA lowering launches the flash kernels or
    raises: head_dim 260 (no multiple of 8) never falls back to the
    dense core unasked."""
    from flexflow_tpu_torch.core.types import OperatorType
    from flexflow_tpu_torch.ops.registry import LowerCtx, lower_op

    dev = _card()
    p = {"embed_dim": 520, "num_heads": 2, "bias": False, "use_flash": use_flash}
    x = torch.zeros(1, 8, 520, device=dev)
    ws = [torch.zeros(520, 2, 260, device=dev)] * 3 + [torch.zeros(2, 260, 520, device=dev)]
    fk.reset_launches()
    with pytest.raises(ValueError, match="head_dim 260"):
        lower_op(OperatorType.MULTIHEAD_ATTENTION, p)([x] * 3, ws, LowerCtx())
    assert fk.LAUNCHES["flash_fwd"] == 0
    (dense,) = lower_op(OperatorType.MULTIHEAD_ATTENTION, dict(p, use_flash=False))([x] * 3, ws, LowerCtx())
    assert dense.shape == (1, 8, 520)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_with_head_dim_160_trains_through_the_flash_kernels(monkeypatch, causal):
    """An MHA with head_dim 160 on a CUDA tensor launches #1-#3 once each
    (their wide bodies) for a forward and backward; its output and
    gradients match the same lowering on the same card with the kernels'
    plain versions in their place."""
    from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
    from flexflow_tpu_torch.core.types import DataType, OperatorType
    from flexflow_tpu_torch.ops.registry import LowerCtx, infer_shapes, lower_op

    dev = _card()
    p = {"embed_dim": 320, "num_heads": 2, "bias": False, "causal": causal}
    shape = ParallelTensorShape.make((2, 70, 320), DataType.FLOAT)
    _, wshapes = infer_shapes(OperatorType.MULTIHEAD_ATTENTION, [shape] * 3, p)
    rng = np.random.default_rng(160)
    host = [rng.standard_normal((2, 70, 320)).astype(np.float32)]
    host += [(0.05 * rng.standard_normal(s.logical_sizes)).astype(np.float32) for s in wshapes]

    def run():
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in host]
        (out,) = lower_op(OperatorType.MULTIHEAD_ATTENTION, p)([leaves[0]] * 3, leaves[1:], LowerCtx())
        (out * torch.cos(out)).sum().backward()
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in leaves]

    fk.reset_launches()
    got = run()
    assert fk.LAUNCHES == _flash_launches(flash_fwd_wide=1, flash_dq_wide=1, flash_dkv_wide=1)
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        monkeypatch.setattr(fk, name, getattr(fk, name + "_ref"))
    want = run()
    torch.testing.assert_close(got[0], want[0], atol=FWD_TOL, rtol=0)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_flash_backward_reads_an_expanded_gradient():
    """sum() hands the backward a stride-0 dO, which the wrapper copies
    to a contiguous one before the kernels read it."""
    dev = _card()
    rng = np.random.default_rng(3)
    leaves = [_rand(rng, dev, 2, 70, 2, 32).requires_grad_(True) for _ in range(3)]
    fk.flash_attention(*leaves, causal=True).sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    fk.flash_fwd_ref(*ref, causal=True)[0].sum().backward()
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_small_transformer_trains_through_the_flash_kernels():
    """A 2-layer encoder takes 3 train steps through fit(); each flash
    kernel runs once per layer per step."""
    dev = _card()
    model = FFModel(FFConfig(batch_size=2, seed=0))
    build_transformer_encoder(model, model.create_tensor([2, 100, 64], name="x"), hidden=64, num_heads=4, num_layers=2)
    model.compile(SGDOptimizer(lr=0.01), LossType.IDENTITY, [])
    assert model.device.type == "cuda" == dev.type
    rng = np.random.RandomState(0)
    data = rng.randn(6, 100, 64).astype(np.float32)
    fk.reset_launches()
    hist = model.fit(data, np.zeros((6, 100, 1), np.float32), verbose=False)
    assert hist[0]["iterations"] == 3 and np.isfinite(hist[0]["loss_sum"])
    assert fk.LAUNCHES == _flash_launches(flash_fwd=6, flash_dq=6, flash_dkv=6)


# -- the bf16 bodies of #1-#3 (mixed precision) ---------------------------------------
# Each bf16 kernel is held with its plain version against the float64
# function of the same bf16 inputs: the kernel's max error may be at most
# twice the plain version's plus one bf16 ulp of the exact output's largest
# entry. Both round P (or dS) and the output to bf16, at places that differ
# (the kernel rounds P under its running max), so their errors are of one
# size; a wrong mask, scale or fragment layout is off by O(1). The ulp is
# taken of at least ULP_FLOOR: where only one key is visible, dQ and dK
# are 0 in exact arithmetic and both versions give the f32 rounding noise
# of dP - delta (~1e-7, measured on an H100), which no bf16 ulp of the
# output scales.
ULP_FLOOR = 2.0**-13


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, ULP_FLOOR))) - 7)


def _assert_bf16_close(got, plain, exact, what):
    for i, (a, p, e) in enumerate(zip(got, plain, exact)):
        assert a.dtype == p.dtype, (what, i, a.dtype)
        assert bool(torch.isfinite(a).all()), (what, i)
        kernel_err = float((a.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        limit = 2 * plain_err + _bf16_ulp(float(e.abs().max()))
        assert kernel_err <= limit, (what, i, kernel_err, plain_err, limit)


def _bf16_operands(rng, dev, b, sq, sk, h, d, causal):
    """bf16 q, k, v, dO, and LSE and delta (float32) of the plain forward."""
    q, do = (_rand(rng, dev, b, sq, h, d).bfloat16() for _ in range(2))
    k, v = (_rand(rng, dev, b, sk, h, d).bfloat16() for _ in range(2))
    o, lse = fk.flash_fwd_ref(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, causal


def _check_bf16_kernels(args, fwd=True, bwd=True):
    q, k, v, do, lse, delta, causal = args
    body = "_wide_bf16" if q.shape[-1] > 256 else "_bf16"  # the bodies past 256
    exact = [t.double() for t in (q, k, v, do)]
    fk.reset_launches()
    if fwd:
        got = fk.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        plain = fk.flash_fwd_ref(q, k, v, causal)
        ref = fk.flash_fwd_ref(*exact[:3], causal)
        _assert_bf16_close(got[:1], plain[:1], ref[:1], "O")
        assert got[1].dtype == torch.float32
        torch.testing.assert_close(got[1], plain[1], atol=FWD_TOL, rtol=0)
    if bwd:
        got = (fk.flash_dq(*args), *fk.flash_dkv(*args))
        torch.cuda.synchronize()
        plain = (fk.flash_dq_ref(*args), *fk.flash_dkv_ref(*args))
        ref = (fk.flash_dq_ref(*exact, lse, delta, causal), *fk.flash_dkv_ref(*exact, lse, delta, causal))
        _assert_bf16_close(got, plain, ref, "dQ, dK, dV")
    assert fk.LAUNCHES == _flash_launches(
        **{"flash_fwd" + body: int(fwd), "flash_dq" + body: int(bwd), "flash_dkv" + body: int(bwd)}
    )


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [(8, 512, 512, 16, 64),  # the flagship's
     (2, 500, 500, 4, 64), (2, 500, 380, 4, 64), (2, 128, 384, 4, 64),
     (2, 200, 77, 3, 24), (2, 384, 129, 4, 128), (1, 96, 160, 2, 160), (2, 129, 300, 2, 256),
     # the reference's test shapes (tests/test_flash_kernel.py)
     (2, 256, 256, 2, 32), (2, 128, 128, 2, 32), (1, 128, 384, 2, 32),
     # #2 and #3's wgmma bodies: ragged against their 128-row fixed tiles,
     # 128- and 64-row loop tiles, sq != sk both ways, head_dims whose
     # last 64-column TMA box is part zero-filled
     (2, 127, 129, 3, 40), (2, 129, 127, 3, 136), (2, 255, 257, 2, 200), (2, 257, 255, 2, 256),
     (2, 130, 300, 2, 24), (2, 300, 130, 2, 128), (8, 512, 512, 8, 128), (8, 512, 512, 4, 256)],
)
def test_bf16_flash_kernels_match_plain_versions(shape, causal):
    """The bf16 #1-#3 at the flagship shape, ragged and sq != sk shapes,
    head_dim 24 to 256 (#2 and #3 also at their tiles' edges, and at the
    flagship's width in heads of 128 and 256) and the reference's test
    shapes; one launch of each bf16 body counted per call, none of the
    fp32 bodies."""
    dev = _card()
    b, sq, sk, h, d = shape
    _check_bf16_kernels(_bf16_operands(np.random.default_rng(sq + sk + d), dev, b, sq, sk, h, d, causal))


@pytest.mark.parametrize("d", [8, 24, 40, 64, 136, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", MMA_EDGE_LENGTHS)
def test_bf16_flash_kernels_match_plain_versions_at_mma_edges(sq, sk, causal, d):
    """The bf16 bodies where tiles are ragged against the products' 16
    rows and the 64-row tiles, and head_dims whose last 64-column TMA box
    is part zero-filled (8-40 in the 64 bucket, 136 in 192, 200 in 256)
    or full (64, 256); at one visible key (sk = 1) dQ and dK are 0 in
    exact arithmetic and what is left is dP - delta's rounding, which
    #2 and #3 keep at the plain version's level from 128 on with one
    fresh chain a 64-column box."""
    dev = _card()
    rng = np.random.default_rng(sq * 1000 + sk + d + 11)
    _check_bf16_kernels(_bf16_operands(rng, dev, 2, sq, sk, 3, d, causal))


# bf16 #1's wgmma body: lengths around its 128-row query tile and its key
# tile (128 rows up to head_dim 128, 64 past it), one query or one key;
# head_dims whose last 64-column TMA box is part zero-filled, in each of
# its instantiations (64, 192, 256)
BF16_FWD_TILE_LENGTHS = [(127, 129), (129, 127), (128, 256), (255, 257), (1, 300), (300, 1)]


@pytest.mark.parametrize("d", [24, 40, 136, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", BF16_FWD_TILE_LENGTHS)
def test_bf16_forward_matches_plain_version_at_tile_edges(sq, sk, causal, d):
    """bf16 #1 at its tiles' ragged edges, by the float64 gate; one launch
    counted under flash_fwd_bf16."""
    dev = _card()
    rng = np.random.default_rng(sq * 1000 + sk + d + 17)
    _check_bf16_kernels(_bf16_operands(rng, dev, 2, sq, sk, 3, d, causal), bwd=False)


# bf16 #2 and #3's wgmma bodies: lengths around their 128-row fixed tile
# and their loop tiles (128 or 64 keys for #2, 64 queries for #3), one
# query or one key, causal with sq != sk both ways
BF16_BWD_TILE_LENGTHS = [(127, 129), (129, 127), (255, 257), (257, 255), (130, 300), (300, 130), (1, 300), (300, 1)]


@pytest.mark.parametrize("d", [24, 40, 128, 136, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", BF16_BWD_TILE_LENGTHS)
def test_bf16_backward_matches_plain_versions_at_tile_edges(sq, sk, causal, d):
    """bf16 #2 and #3 at their tiles' ragged edges and head_dims whose
    last TMA box is part zero-filled (or, at 128, two full boxes whose dP
    chains are added), by the float64 gate; one launch each counted
    under flash_dq_bf16 and flash_dkv_bf16."""
    dev = _card()
    rng = np.random.default_rng(sq * 1000 + sk + d + 23)
    _check_bf16_kernels(_bf16_operands(rng, dev, 2, sq, sk, 3, d, causal), fwd=False)


@pytest.mark.parametrize("name", ["flash_dq_bf16", "flash_dkv_bf16"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bf16_backward_fits_the_card(d, name):
    """bf16 #2 and #3's wgmma bodies: no spilled registers (their
    consumers hold the output accumulators, S and dP and the bf16
    fragments in the 240 registers setmaxnreg gives them), one block an
    SM."""
    _card()
    occ = fk.occupancy(name, d)
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


@pytest.mark.parametrize("d", [64, 128, 256])
def test_bf16_forward_fits_the_card(d):
    """bf16 #1's wgmma body: no spilled registers (its consumers hold O, S
    and P in the 240 registers setmaxnreg gives them), one block an SM."""
    _card()
    occ = fk.occupancy("flash_fwd_bf16", d)
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


# bf16 #1's wide wgmma body takes output chunks of kB 64-column boxes, the
# kB (2-4) that wide_boxes picks from the grid (H100, 132 SMs): (b, sq, sk,
# h, d, kB). Grids of one wave run kB = 2 (2056 at 8 query tiles: kB = 3,
# 11 chunks in one wave), the timed [8, 512, 4, 320] and its grid at 264
# run kB = 3, [8, 512, 4, 512] and [4, 512, 8, 1032] run kB = 4.
WIDE_BF16_SHAPES = [
    (2, 129, 300, 2, 264, 2), (2, 300, 129, 2, 320, 2), (1, 200, 77, 2, 512, 2),
    # #1's Q tile streamed beside K (past head_dim 640)
    (1, 130, 70, 1, 1032, 2), (1, 130, 70, 1, 2056, 2),
    # chunks of 2 boxes (the last chunk's last box wholly past d at 320,
    # 520 and 648, part zero-filled at 328), Q resident at 640 and
    # streamed from 648 (1032: 9 chunks of 2; 2056: 11 chunks of 3), sq !=
    # sk with ragged last tiles
    *[(2, 129, 300, 2, d, 3 if d == 2056 else 2) for d in (320, 328, 384, 520, 640, 648, 1032, 2056)],
    (2, 300, 77, 2, 384, 2),
    # one visible key (LSE is the score chains' sum alone), query lengths
    # around a warpgroup's 64 rows and the 128-row tile
    *[(2, sq, sk, 2, d, 2) for d in (320, 512) for sq, sk in ((300, 1), (64, 64), (65, 70), (128, 128), (129, 129))],
    # grids of many waves: chunks of 3 boxes (at 264 and 320 chunk 1's
    # last box wholly past d, at 328 part zero-filled), of 4 (at 392 chunk
    # 1's last box wholly past d; at 1032 Q streamed, 5 chunks, the last
    # with one box in d), ragged last tiles and sq != sk at 328 and 392
    (8, 512, 512, 4, 264, 3), (8, 512, 512, 4, 320, 3), (8, 500, 380, 4, 328, 3),
    (8, 512, 512, 4, 512, 4), (8, 500, 380, 4, 392, 4), (4, 512, 512, 8, 1032, 4),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", WIDE_BF16_SHAPES)
def test_bf16_flash_kernels_past_256_match_plain_versions(shape, causal):
    """bf16 #1-#3 past head_dim 256 (#1 on the bf16 file's wide wgmma body,
    the scores once per output chunk of 2-4 boxes, at each of its three
    instantiations; #2 and #3 on the backward file's wide kernels
    instantiated for bf16), ragged and sq != sk, at one visible key and
    around #1's tiles, held with their plain versions against float64 by
    the bf16 gate (LSE at the reference's 2e-5 against plain); one launch
    of each counted under name + "_wide_bf16", none of any other body."""
    dev = _card()
    b, sq, sk, h, d, boxes = shape
    assert fk.wide_boxes(b, h, sq, d) == boxes
    _check_bf16_kernels(_bf16_operands(np.random.default_rng(sq + sk + d + 3), dev, b, sq, sk, h, d, causal))


@pytest.mark.parametrize("boxes", [2, 3, 4])
@pytest.mark.parametrize("d", [264, 320, 512, 1032])
def test_bf16_wide_forward_fits_the_card(d, boxes):
    """bf16 #1's wide wgmma body at each instantiation (output chunks of
    2, 3 or 4 boxes) at head_dim 264, 320, 512 (Q resident) and 1032 (Q
    streamed): no spilled registers (its consumers hold O's columns of
    the chunk, S, a later score chain and P in the 240 registers
    setmaxnreg gives them), and one block fits an SM."""
    _card()
    occ = fk.occupancy("flash_fwd_wide_bf16", d, boxes)
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512, 2056])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_flash_kernels_are_bit_identical_across_calls(causal, d):
    """No atomics in the bf16 bodies either: two calls give the same bits
    (the wgmma bodies of #1-#3 at 64, 128, 192 and 256, ragged against
    every tile; past head_dim 256 on the wide bodies, #1's Q tile
    resident at 320 and 512 and streamed at 2056)."""
    dev = _card()
    args = _bf16_operands(np.random.default_rng(29), dev, 2, 300, 260, 4, d, causal)
    q, k, v = args[:3]
    first = (*fk.flash_fwd(q, k, v, causal), fk.flash_dq(*args), *fk.flash_dkv(*args))
    second = (*fk.flash_fwd(q, k, v, causal), fk.flash_dq(*args), *fk.flash_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 320])
def test_bf16_flash_kernels_read_misaligned_views(d):
    """A bf16 view whose strides or start are not 16-byte multiples is
    copied before the kernels read it (at 320 #1's wide body), and gives
    the contiguous result; head_dim 60 (no multiple of 8) raises before
    any launch."""
    dev = _card()
    rng = np.random.default_rng(31)
    base = _rand(rng, dev, 2, 70, 2, d + 8).bfloat16()
    q = base[..., 4 : d + 4]  # strides of d + 8 elements, data 8 bytes in
    k, v = (_rand(rng, dev, 2, 70, 2, d).bfloat16() for _ in range(2))
    assert q.data_ptr() % 16 != 0
    fk.reset_launches()
    for a, b in zip(fk.flash_fwd(q, k, v, True), fk.flash_fwd(q.contiguous(), k, v, True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head_dim 60"):
        fk.flash_fwd(q[..., :60], k[..., :60], v[..., :60])
    assert fk.LAUNCHES == _flash_launches(**{"flash_fwd_wide_bf16" if d > 256 else "flash_fwd_bf16": 2})


def test_bf16_forward_reads_broadcast_views():
    """K and V broadcast over the batch (stride 0 over two batches) give
    bf16 #1 the result of their contiguous copies: the wrapper copies
    a view that repeats itself along a dimension before a tensor map is
    made of it."""
    dev = _card()
    rng = np.random.default_rng(37)
    q = _rand(rng, dev, 2, 130, 2, 64).bfloat16()
    k, v = (_rand(rng, dev, 1, 150, 2, 64).bfloat16().expand(2, 150, 2, 64) for _ in range(2))
    assert k.stride(0) == 0
    fk.reset_launches()
    for a, b in zip(fk.flash_fwd(q, k, v, True), fk.flash_fwd(q, k.contiguous(), v.contiguous(), True)):
        assert torch.equal(a, b)
    assert fk.LAUNCHES == _flash_launches(flash_fwd_bf16=2)


def test_bf16_backward_reads_broadcast_views():
    """K, V and dO broadcast over the batch (stride 0 over two batches)
    give bf16 #2 and #3 the result of their contiguous copies: the
    wrapper copies a view that repeats itself along a dimension before a
    tensor map is made of it."""
    dev = _card()
    rng = np.random.default_rng(41)
    q = _rand(rng, dev, 2, 130, 2, 64).bfloat16()
    k, v = (_rand(rng, dev, 1, 150, 2, 64).bfloat16().expand(2, 150, 2, 64) for _ in range(2))
    do = _rand(rng, dev, 1, 130, 2, 64).bfloat16().expand(2, 130, 2, 64)
    assert k.stride(0) == 0 and do.stride(0) == 0
    o, lse = fk.flash_fwd_ref(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    fk.reset_launches()
    views = (q, k, v, do, lse, delta, True)
    copies = (q, k.contiguous(), v.contiguous(), do.contiguous(), lse, delta, True)
    assert torch.equal(fk.flash_dq(*views), fk.flash_dq(*copies))
    for a, b in zip(fk.flash_dkv(*views), fk.flash_dkv(*copies)):
        assert torch.equal(a, b)
    assert fk.LAUNCHES == _flash_launches(flash_dq_bf16=2, flash_dkv_bf16=2)


def test_mixed_precision_transformer_trains_through_the_bf16_kernels():
    """A 2-layer encoder compiled with allow_mixed_precision takes 3 train
    steps through fit(): each bf16 flash kernel runs once per layer per
    step and no fp32 body runs; the weights stay float32 masters."""
    dev = _card()
    model = FFModel(FFConfig(batch_size=2, seed=0, allow_mixed_precision=True))
    build_transformer_encoder(model, model.create_tensor([2, 100, 64], name="x"), hidden=64, num_heads=4, num_layers=2)
    model.compile(SGDOptimizer(lr=0.01), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    assert model.device.type == "cuda" == dev.type and model.executor.mixed_precision
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    rng = np.random.RandomState(0)
    fk.reset_launches()
    hist = model.fit(rng.randn(6, 100, 64).astype(np.float32), rng.randn(6, 100, 1).astype(np.float32), verbose=False)
    assert hist[0]["iterations"] == 3 and np.isfinite(hist[0]["loss_sum"])
    assert fk.LAUNCHES == _flash_launches(flash_fwd_bf16=6, flash_dq_bf16=6, flash_dkv_bf16=6)
    assert all(w.dtype == torch.float32 for ws in model.params.values() for w in ws)


# -- multi-step decode windows as CUDA graphs ------------------------------------------

_WINDOW_LEGS = {
    "slot": (dict(kv_layout="slot"), "flash_verify"),
    "paged": (dict(kv_layout="paged"), "paged_flash_verify"),
    "int8": (dict(kv_layout="paged", kv_dtype="int8"), "paged_flash_verify_quant"),
}


def _small_lm(layers=2):
    model = FFModel(FFConfig(batch_size=4, seed=0))
    tok = model.create_tensor([4, 64], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(model, tok, vocab_size=128, hidden=64, num_heads=4, num_layers=layers, ff_dim=128)
    model.compile()
    return model


@pytest.mark.parametrize("leg", sorted(_WINDOW_LEGS))
def test_graph_window_equals_eager_steps(leg):
    """A decode_multi window on the card (its first step eager, then
    replays of the captured decode core) equals K eager decode steps,
    tokens and logits exactly, on the slot layout (#4), fp32 pools (#5)
    and int8 pools (#6); the leg's kernel launches replays x layers; a
    second window replays the captured graph, and a third with other
    limits does too."""
    from flexflow_tpu_torch.serving import build_scheduler

    _card()
    layers, K = 2, 4
    model = _small_lm(layers)
    kw, kernel = _WINDOW_LEGS[leg]
    serve = ServeConfig(max_seqs=3, max_seq_len=64, **kw)
    prompts = [[3, 1, 4, 1, 5], [9, 2]]
    active = np.array([True, True, False])

    def prefilled():
        _, eng, cache = build_scheduler(model, serve)
        slots = [cache.alloc(len(p), 64) for p in prompts]
        first, _ = eng.prefill(model.params, prompts, slots)
        cur = np.zeros(3, dtype=np.int32)
        cur[:2] = first
        return eng, cache, cur

    eng_seq, cache_seq, cur = prefilled()
    seq = []
    for _ in range(3 * K):
        nxt, logits = eng_seq.decode(model.params, cur, active)
        seq.append((nxt.copy(), logits.clone()))
        cur = np.where(active, nxt, cur).astype(np.int32)
    eng, cache, cur = prefilled()
    graphs = []
    done = 0
    for limits in (np.where(active, K, 0), np.where(active, K, 0), np.array([K, 2, 0])):
        dk.reset_launches()
        toks, logits, mask = eng.decode_multi(model.params, cur, active, limits)
        torch.cuda.synchronize()
        assert dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), **{kernel: K * layers})
        assert eng.multistep_cache_entries == 1
        graphs.append(next(iter(eng._graphs.values())).graph)
        for i in range(K):
            want_t, want_l = seq[done + i]
            live = mask[i]
            np.testing.assert_array_equal(toks[i][live], want_t[live], err_msg=f"step {done + i}")
            assert torch.equal(logits[i][torch.from_numpy(live).to(logits.device)],
                               want_l[torch.from_numpy(live).to(want_l.device)]), f"step {done + i}"
        if limits[1] < K:
            break
        done += K
        cur = np.where(active, toks[-1], cur).astype(np.int32)
    assert graphs[0] is graphs[1] is graphs[2]
    np.testing.assert_array_equal(mask.sum(axis=0), [K, 2, 0])


@pytest.mark.parametrize("leg", sorted(_WINDOW_LEGS))
def test_multistep_serving_on_the_card_matches_plain_streams(leg):
    """The continuous scheduler with decode_multistep=True on the card:
    the streams equal plain decode's, every decode step launches the
    leg's kernel once per layer (replays counted), the windows fused, and
    one graph serves every window."""
    from flexflow_tpu_torch.serving import Request, build_scheduler

    _card()
    layers = 2
    model = _small_lm(layers)
    kw, kernel = _WINDOW_LEGS[leg]
    prompts = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [10, 11], [12]]
    runs = {}
    for fused in (False, True):
        sched, eng, _ = build_scheduler(
            model, ServeConfig(max_seqs=2, max_seq_len=64, decode_multistep=fused, **kw)
        )
        dk.reset_launches()
        done = sched.run([Request(rid=i, prompt=p, max_new_tokens=20) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        assert all(r.ok and len(r.generated) == 20 for r in done)
        assert dk.LAUNCHES[kernel] == sched.stats.decode_steps * layers
        runs[fused] = ({r.rid: r.generated for r in done}, sched.stats, eng)
    (plain, pstats, _), (streams, stats, eng) = runs[False], runs[True]
    assert streams == plain
    assert stats.multistep_steps > stats.multistep_windows > 0
    assert stats.host_syncs < pstats.host_syncs
    assert stats.multistep_cache_entries == eng.multistep_cache_entries == 1
