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
    assert dk.LAUNCHES == {"flash_verify": 1, "paged_flash_verify": 1}
    torch.testing.assert_close(out, dk.flash_verify_ref(q, k, v, lens), atol=ATOL, rtol=0)
    torch.testing.assert_close(pout, dk.paged_flash_verify_ref(q, kp, vp, tbl, lens), atol=ATOL, rtol=0)
    assert float(pout[5].abs().max()) == 0.0


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
