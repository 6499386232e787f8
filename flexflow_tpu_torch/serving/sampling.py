"""Temperature sampling with the reference's keys (port of the part of
`jax.random` that flexflow_tpu/serving/engine.py `_pick` relies on).

The reference draws each sampled token as

    categorical(fold_in(fold_in(PRNGKey(seed), slot), position), logits / T)

with `position` the cache position the token will occupy, so a stream
depends only on (seed, slot, position), never on which requests share a
batch. This module is a counter-based copy of those functions under JAX's
defaults (the threefry2x32 PRNG, `jax_threefry_partitionable=True`):

  * `threefry2x32`: the 20-round Threefry-2x32 hash;
  * `prng_key(seed)`: the key [seed >> 32, seed & 0xFFFFFFFF];
  * `fold_in(key, data)`: threefry2x32(key, (0, data));
  * `random_bits(key, n)`: 32-bit words, word i = y0 ^ y1 of
    threefry2x32(key, (0, i)) (the partitionable layout);
  * `uniform(key, n)`: [tiny, 1) floats from the top 23 bits of each word;
  * `gumbel`: -log(-log(uniform));
  * `categorical`: argmax(logits + gumbel), the first maximum.

Everything is plain tensor arithmetic on the logits' device: uint32
words live in int64 tensors masked to 32 bits, so the keys of a batch
are rows of one tensor and a CUDA graph can sample inside its capture
(the per-slot keys ride in as a tensor; no torch.Generator and no host
RNG). The bits, and so the uniforms, equal `jax.random`'s exactly;
`log` may differ from XLA's by an ulp, so a token can differ only where
two candidates of logits / T + gumbel lie within about 1e-5.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds, key injection every 4) of the
    counter pairs (x0, x1) under key (k0, k1); every operand is an int64
    tensor of uint32 values (broadcasting). Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): int64 [2] = (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([(seed >> 32) & _M32, seed & _M32])


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """jax.random.fold_in for a batch: key [..., 2], data [...] (uint32
    values) -> keys [..., 2]."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def slot_keys(seed, slots: torch.Tensor) -> torch.Tensor:
    """fold_in(PRNGKey(seed), slot) per row: [n, 2]. Constant for a
    slot, so a caller that samples every step (the decode core) keeps
    them."""
    base = prng_key(seed, device=slots.device)
    return fold_in(base.expand(slots.shape[0], 2), slots)


def row_keys(seed, slots: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """fold_in(fold_in(PRNGKey(seed), slot), position) per row: [n, 2]."""
    return fold_in(slot_keys(seed, slots), positions)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words of jax.random.bits(key, (n,)), one row per key:
    keys [rows, 2] -> int64 [rows, n] of uint32 values."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(count), count)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1) per
    row: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    then shifted onto [tiny, 1) as the reference's gumbel asks."""
    mant = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # (maxval - minval) rounds to 1 in f32, so the affine map is + tiny
    return torch.clamp_min(floats + _TINY, _TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)), [rows, n] float32."""
    return -torch.log(-torch.log(uniform(keys, n)))


def sample(logits: torch.Tensor, temperature: float, seed, slots: torch.Tensor,
           positions: torch.Tensor, keys_of_slots=None) -> torch.Tensor:
    """The reference engine's `_pick` at temperature > 0: logits [n, V]
    (any float dtype; cast to float32 and divided by T in float32), one
    draw per row under row_keys(seed, slots, positions), or
    fold_in(keys_of_slots, positions) where the caller keeps its rows'
    slot_keys. Returns int64 token ids [n] on the logits' device."""
    scaled = logits.float() / torch.full((), float(temperature), device=logits.device)
    if keys_of_slots is None:
        keys_of_slots = slot_keys(seed, slots.to(torch.int64))
    keys = fold_in(keys_of_slots, positions.to(torch.int64))
    return torch.argmax(gumbel(keys, logits.shape[-1]) + scaled, dim=-1)
