"""flexflow_tpu_torch on a CUDA card: the hand-written decode kernels
against their plain PyTorch versions, launch counting, and a small
model served through both KV layouts. Every test here needs the card
and skips without one (the kernels have no CPU mode).

This file imports no jax, so it also runs where only torch is
installed: `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
Tolerance: atol 1e-4 — fp32 kernels against fp32 plain versions, which
differ in summation order only."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import DataType, FFConfig, FFModel
from flexflow_tpu_torch.models import build_decoder_lm
from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
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
