"""flexflow_tpu_torch's temperature sampling (serving/sampling.py, the
engine's `_select` and the decode core's on-device draw) against the JAX
package: the sampler's keys, bits, uniforms, Gumbel noise and tokens
against `jax.random` (threefry2x32, partitionable) on the CPU, and
sampled streams against the JAX engine's at temperature 0.8 on the slot
layout, fp32 pools and int8 pools, eager and multi-step, with linear and
tree speculation beside them. Tolerances: keys, bits and uniforms exact;
Gumbel noise within 2e-6 absolute (torch's log and XLA's may differ by
an ulp); a token may differ from jax.random's only
where the top two of logits / T + gumbel lie within 1e-5; streams exact
(the sampled tokens of the tiny model never meet such a tie)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu_torch.serving import sampling
from torch_serving_models import JAX, LEGS, PORT, build_lms, one_torch_thread, prompts, serve  # noqa: F401 (autouse)

pytestmark = pytest.mark.serving

T = 0.8
# -log(-log(u)): an ulp of either log, near -log(u) = 1 cancelled into a
# small result, moves it by a few 1e-7 absolute
GUMBEL_ATOL = 2e-6
PROMPTS = prompts(11, (3, 12, 7, 21, 1, 9))
MAX_NEW = [10, 8, 12, 6, 9, 11]
KEYS = [(seed, slot, pos) for seed in (0, 1234, 2**31 - 1) for slot in (0, 3) for pos in (0, 17, 511)]


@pytest.fixture(scope="module")
def lms():
    return build_lms()


def _jax_key(seed, slot, pos):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), slot), pos)


def _port_key(seed, slot, pos):
    return sampling.row_keys(seed, torch.tensor([slot]), torch.tensor([pos]))


@pytest.mark.parametrize("seed,slot,pos", KEYS)
def test_keys_bits_and_uniforms_equal_jax_random(seed, slot, pos):
    """fold_in(fold_in(PRNGKey(seed), slot), position), the 32-bit words
    of jax.random.bits and the [tiny, 1) uniforms the Gumbel draw takes
    are bit-identical to jax.random's, over vectors of 1 to 1000."""
    key = _jax_key(seed, slot, pos)
    ours = _port_key(seed, slot, pos)
    assert ours[0].tolist() == np.asarray(key).astype(np.int64).tolist()
    tiny = np.finfo(np.float32).tiny
    for n in (1, 7, 64, 1000):
        bits = np.asarray(jax.random.bits(key, (n,)), dtype=np.uint32).astype(np.int64)
        np.testing.assert_array_equal(sampling.random_bits(ours, n)[0].numpy(), bits)
        uni = np.asarray(jax.random.uniform(key, (n,), jnp.float32, minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(sampling.uniform(ours, n)[0].numpy(), uni)


def test_threefry_hash_matches_the_known_answer():
    """Threefry-2x32's published test vector (Random123: key and counter
    all ones -> 0x1cb996fc, 0xbb002be7), which jax.random also meets."""
    ones = torch.tensor(0xFFFFFFFF, dtype=torch.int64)
    y0, y1 = sampling.threefry2x32(ones, ones, ones, ones)
    assert (int(y0), int(y1)) == (0x1CB996FC, 0xBB002BE7)


@pytest.mark.parametrize("n", [2, 64, 32000])
def test_gumbel_and_tokens_agree_with_jax_random(n):
    """Gumbel noise within 2e-6 of jax.random.gumbel, and categorical
    draws over random logits equal jax.random.categorical's except where
    the top two candidates of logits / T + gumbel lie within 1e-5 (none
    do at these seeds)."""
    rng = np.random.RandomState(n)
    differ = 0
    for seed, slot, pos in KEYS:
        key, ours = _jax_key(seed, slot, pos), _port_key(seed, slot, pos)
        g = sampling.gumbel(ours, n)[0].numpy()
        jg = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
        np.testing.assert_allclose(g, jg, atol=GUMBEL_ATOL, rtol=0)
        logits = (3 * rng.randn(n)).astype(np.float32)
        want = int(jax.random.categorical(key, jnp.asarray(logits) / T))
        got = int(sampling.sample(torch.from_numpy(logits)[None], T, seed, torch.tensor([slot]),
                                  torch.tensor([pos]))[0])
        if got != want:
            z = np.sort(logits / np.float32(T) + g)
            assert z[-1] - z[-2] < 1e-5
            differ += 1
    assert differ == 0


def test_rows_draw_independently_of_their_batch():
    """A row's draw depends on (seed, slot, position) alone: sampled in a
    batch or alone, the same token."""
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(6, 50).astype(np.float32))
    slots = torch.tensor([0, 1, 2, 3, 1, 0])
    pos = torch.tensor([4, 9, 9, 100, 10, 5])
    batch = sampling.sample(logits, T, 42, slots, pos)
    alone = [int(sampling.sample(logits[i:i + 1], T, 42, slots[i:i + 1], pos[i:i + 1])[0]) for i in range(6)]
    assert batch.tolist() == alone
    assert sampling.sample(logits, T, 43, slots, pos).tolist() != batch.tolist()


@pytest.mark.parametrize("multistep", [False, True])
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_sampled_streams_match_jax_engine(lms, leg, multistep):
    """At temperature 0.8 the port's streams equal the JAX engine's
    (dense attention), prefill and decode keyed at the reference's
    positions, eager and in multi-step windows, on each layout."""
    jm, tm = lms
    kw = dict(LEGS[leg], temperature=T, seed=1234, decode_multistep=multistep)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, _, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **kw)
    assert ours == ref
    greedy, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **LEGS[leg])
    assert ours != greedy
    if multistep:
        assert stats.multistep_windows > 0


def test_sampled_streams_match_jax_pallas_engine(lms):
    """The same against the JAX engine running its Pallas decode kernels
    in the interpreter (paged fp32 pools)."""
    jm, tm = lms
    kw = dict(temperature=T, seed=99)
    ours, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, _, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="pallas", **kw)
    assert ours == ref


def test_sampled_streams_reproduce_and_follow_the_seed(lms):
    """A fixed seed replays the same streams; another seed gives others."""
    _, tm = lms
    a, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, temperature=T, seed=5)
    b, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, temperature=T, seed=5)
    c, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, temperature=T, seed=6)
    assert a == b and a != c


@pytest.mark.parametrize("branch", [1, 2])
def test_speculative_sampling_matches_jax_scheduler(lms, branch):
    """Linear and tree speculation at temperature 0.8: the reference's
    host-side rejection sampling (serving/spec.py) gets the engine's
    temperature and seed, so streams and acceptance counts equal the JAX
    scheduler's."""
    jm, tm = lms
    # prompts holding most of the vocabulary: a sampled token's 1-gram is
    # usually found, so the drafts are many
    rng = np.random.RandomState(8)
    wide = [[int(t) for t in rng.permutation(np.arange(1, 64))[:40]] for _ in range(4)]
    kw = dict(temperature=T, seed=3, spec_draft="ngram", spec_ngram=1, spec_k=3, spec_branch=branch)
    ours, stats, _ = serve(PORT, tm, wide, MAX_NEW, **kw)
    ref, jstats, _ = serve(JAX, jm, wide, MAX_NEW, decode_kernel="dense", **kw)
    assert ours == ref
    assert stats.draft_tokens_proposed == jstats.draft_tokens_proposed > 0
    assert stats.draft_tokens_accepted == jstats.draft_tokens_accepted
