"""flexflow_tpu_torch on a CUDA card: the hand-written decode and flash
kernels against their plain PyTorch versions, launch counting, a small
model served through both KV layouts and a small model trained through
the flash kernels. Every test here needs the card and skips without one
(the kernels have no CPU mode).

This file imports no jax, so it also runs where only torch is
installed: `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
Tolerance: atol 1e-4 — fp32 kernels against fp32 plain versions, which
differ in summation order only; gradients also rtol 1e-3."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType, SGDOptimizer
from flexflow_tpu_torch.models import build_decoder_lm, build_transformer_encoder
from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk
from flexflow_tpu_torch.serving import ServeConfig

pytestmark = pytest.mark.cuda

ATOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, dev, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


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


def test_tree_body_rejects_wide_heads():
    """head_dim 260 is past the tree body's tiles (256): a ValueError
    before any launch."""
    dev = _card()
    q = torch.zeros(1, 3, 2, 260, device=dev)
    k = torch.zeros(1, 64, 2, 260, device=dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    dk.reset_launches()
    with pytest.raises(ValueError, match="head_dim 260"):
        dk.flash_verify_tree(q, k, k, lens, torch.ones(1, 3, 64, dtype=torch.bool, device=dev))
    assert sum(dk.LAUNCHES.values()) == 0


def test_quant_and_tree_kernels_reject_what_they_do_not_take():
    """w = 65, head_dim 8 on int8 pools, fp32 pools where int8 is
    expected, misshapen scales and a strided mask raise before a launch."""
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
    with pytest.raises(ValueError, match="multiple of 16"):
        k8n = torch.zeros(num_pages, page, h, 8, dtype=torch.int8, device=dev)
        dk.paged_flash_verify_quant(q[..., :8], k8n, k8n, ks, ks, tbl, lens)
    with pytest.raises(TypeError):
        kf = torch.zeros(num_pages, page, h, d, device=dev)
        dk.paged_flash_verify_quant(q, kf, kf, ks, ks, tbl, lens)
    with pytest.raises(ValueError, match="k_scale"):
        dk.paged_flash_verify_quant(q, k8, k8, ks[:, :1], ks, tbl, lens)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.ones(b, 1, 4 * page, dtype=torch.bool, device=dev)[..., ::2]
        dk.flash_verify_tree(q, k32, k32, lens, strided)
    assert sum(dk.LAUNCHES.values()) == 0


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
@pytest.mark.parametrize("shape", [(2, 256, 256, 4, 64), (2, 200, 77, 3, 128), (1, 96, 160, 2, 8)])
def test_flash_kernels_match_plain_versions(shape, causal):
    """Kernels #1-#3 at ragged and sq != sk shapes, head_dim 8 to 128;
    one launch counted per call."""
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
    assert fk.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    torch.testing.assert_close(o, ro, atol=ATOL, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=ATOL, rtol=0)
    rdk, rdv = fk.flash_dkv_ref(q, k, v, do, rlse, delta, causal)
    torch.testing.assert_close(dq, fk.flash_dq_ref(q, k, v, do, rlse, delta, causal), atol=ATOL, rtol=1e-3)
    torch.testing.assert_close(dk_, rdk, atol=ATOL, rtol=1e-3)
    torch.testing.assert_close(dv, rdv, atol=ATOL, rtol=1e-3)


def _flash_backward_operands(rng, dev, b, sq, sk, h, d, causal):
    q, do = _rand(rng, dev, b, sq, h, d), _rand(rng, dev, b, sq, h, d)
    k, v = _rand(rng, dev, b, sk, h, d), _rand(rng, dev, b, sk, h, d)
    o, lse = fk.flash_fwd_ref(q, k, v, causal)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, causal


@pytest.mark.parametrize("d", [8, 16, 24, 40, 64, 96, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1, 1), (15, 17), (17, 15), (65, 200), (200, 65), (1, 200), (200, 1), (65, 65)])
def test_flash_backward_matches_plain_versions_at_mma_edges(sq, sk, causal, d):
    """#2 and #3 where the tiles are ragged against mma's 16 rows and 8
    columns as well as the 64-row tiles: sq, sk in {1, 15, 17, 65, 200},
    sk < sq and sk > sq, every head_dim bucket."""
    dev = _card()
    args = _flash_backward_operands(np.random.default_rng(sq * 1000 + sk + d), dev, 2, sq, sk, 3, d, causal)
    fk.reset_launches()
    dq = fk.flash_dq(*args)
    dk_, dv = fk.flash_dkv(*args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 1}
    rdk, rdv = fk.flash_dkv_ref(*args)
    torch.testing.assert_close(dq, fk.flash_dq_ref(*args), atol=ATOL, rtol=1e-3)
    torch.testing.assert_close(dk_, rdk, atol=ATOL, rtol=1e-3)
    torch.testing.assert_close(dv, rdv, atol=ATOL, rtol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_is_bit_identical_across_calls(causal):
    """No atomics: two calls on the same inputs give the same bits."""
    dev = _card()
    args = _flash_backward_operands(np.random.default_rng(9), dev, 2, 300, 260, 4, 64, causal)
    first = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    second = (fk.flash_dq(*args), *fk.flash_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_kernel_rejects_what_it_does_not_take():
    dev = _card()
    q = torch.zeros(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        fk.flash_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16())
    wide = torch.zeros(1, 8, 2, 160, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError):
        fk.flash_fwd(q, q.cpu(), q)


@pytest.mark.parametrize("use_flash", ["auto", True])
def test_mha_raises_where_the_flash_kernels_do_not_take_the_shape(use_flash):
    """On a CUDA tensor the MHA lowering launches the flash kernels or
    raises: head_dim 160 never falls back to the dense core unasked."""
    from flexflow_tpu_torch.core.types import OperatorType
    from flexflow_tpu_torch.ops.registry import LowerCtx, lower_op

    dev = _card()
    p = {"embed_dim": 320, "num_heads": 2, "bias": False, "use_flash": use_flash}
    x = torch.zeros(1, 8, 320, device=dev)
    ws = [torch.zeros(320, 2, 160, device=dev)] * 3 + [torch.zeros(2, 160, 320, device=dev)]
    fk.reset_launches()
    with pytest.raises(ValueError, match="head_dim 160"):
        lower_op(OperatorType.MULTIHEAD_ATTENTION, p)([x] * 3, ws, LowerCtx())
    assert fk.LAUNCHES["flash_fwd"] == 0
    (dense,) = lower_op(OperatorType.MULTIHEAD_ATTENTION, dict(p, use_flash=False))([x] * 3, ws, LowerCtx())
    assert dense.shape == (1, 8, 320)


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
        torch.testing.assert_close(a.grad, b.grad, atol=ATOL, rtol=1e-3)


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
    assert fk.LAUNCHES == {"flash_fwd": 6, "flash_dq": 6, "flash_dkv": 6}
