"""flexflow_tpu_torch serving a model compiled with allow_mixed_precision
against the JAX package's, on the CPU (the decode kernel wrappers take
their plain versions here): the reference's tiny decoder LM (2 layers,
hidden 32, 4 heads, vocab 64) compiled with the flag on both sides, its
weights carried across by guid, serves the same prompts through
generate() / build_scheduler() with bf16 activations and logits over
fp32 and int8 pools, on the paged and slot layouts, plain, with linear
and token-tree speculation and with multi-step decode windows. The JAX
engine runs its Pallas kernels (interpret mode) or its dense attention.

Greedy streams must be equal. bf16 logits tie far more often than f32
ones, and the two packages round some bf16 sums in another order, so a
stream may part from the reference's only where the reference's own top
two logits lie within one bf16 ulp of the top logit (`_assert_streams`
says where and how much); at these seeds none parts.

Logit tolerances are counted in bf16 ulps of a row's largest |logit|
(`_row_ulps`). The two packages' full no-cache mixed forwards of the
same tokens differ by 2-2.4 of them at this size (bf16 GEMM sums
rounded in another order, compounded over 2 layers; the prefill, which
reaches no decode kernel, differs as much), so verify logits, which
reach the host as float32, must equal the JAX engine's bf16 verify
logits within one such ulp beyond what the two forwards differ by on
the same prompts (measured in the test). Cached decode logits equal the
port's own full no-cache mixed forward within CACHE_ULPS ulps on fp32
pools: the full forward's dense core rounds P to bf16 where the decode
kernels keep it f32, and every layer rounds its activations to bf16.
(int8 pools are held against the reference's int8 path, never against a
forward without the round trip.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import LossType, SGDOptimizer
from flexflow_tpu.models import build_decoder_lm as jax_build_decoder_lm
from flexflow_tpu.serving import Request as JRequest
from flexflow_tpu.serving import ServeConfig as JServeConfig
from flexflow_tpu.serving import build_scheduler as jax_build_scheduler
from flexflow_tpu_torch import DataType, FFConfig, FFModel
from flexflow_tpu_torch.models import build_decoder_lm
from flexflow_tpu_torch.runtime.interop import params_from_host
from flexflow_tpu_torch.serving import Request, RequestStatus, ServeConfig, build_scheduler

pytestmark = pytest.mark.serving

VOCAB = 64
MAX_LEN = 32
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 3, 1, 2], [7], [11, 12], [3, 3, 3]]
MAX_NEW = [6, 3, 8, 5, 2, 7]
# cached decode logits against the full no-cache forward, in bf16 ulps
# of each row's largest |logit|
CACHE_ULPS = 4


def _ulp(x):
    """One bf16 ulp of |x| (elementwise): 2^(floor(log2 |x|) - 7)."""
    x = np.maximum(np.abs(np.asarray(x, dtype=np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.fixture(scope="module")
def lms():
    """(jax model, port model), both compiled with allow_mixed_precision,
    sharing the same float32 weights by guid."""
    jm = JFFModel(JFFConfig(batch_size=2, seed=0, allow_mixed_precision=True))
    tok = jm.create_tensor([2, MAX_LEN], dtype=JDataType.INT32, name="tokens")
    jax_build_decoder_lm(jm, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=2, ff_dim=64)
    jm.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[],
        devices=jax.devices()[:1],
    )
    tm = FFModel(FFConfig(batch_size=2, seed=0, allow_mixed_precision=True))
    tok = tm.create_tensor([2, MAX_LEN], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(tm, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=2, ff_dim=64)
    tm.compile(device="cpu")
    host = jm.executor.export_host_params(jm.params)
    params_from_host(tm, {g: [np.asarray(w) for w in ws] for g, ws in host.items()})
    assert tm.executor.mixed_precision
    return jm, tm


def _row_ulps(a, b):
    """max |a - b| in bf16 ulps of each row's largest |logit|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    top = np.maximum(np.abs(a).max(-1, keepdims=True), np.abs(b).max(-1, keepdims=True))
    return float((np.abs(a - b) / _ulp(top)).max())


def _jax_logits(jm, seq):
    """The reference's full no-cache mixed forward of one token sequence:
    its logits [len(seq), V] as float32."""
    tokens = np.zeros((2, MAX_LEN), dtype=np.int32)
    tokens[0, : len(seq)] = seq
    out = jm.forward({"tokens": tokens})
    return np.asarray(jnp.asarray(out).astype(jnp.float32))[0, : len(seq)]


def _assert_streams(jm, ours, ref, prompts):
    """Each of our streams equals the reference's, or first parts from it
    where the reference's top two logits for that token lie within one
    bf16 ulp of the top logit (a near-tie that the two packages' bf16
    rounding orders may break either way); returns the partings as
    (request, token, gap)."""
    partings = []
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a == b:
            continue
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        logits = _jax_logits(jm, list(prompts[i]) + list(b[:j]))[-1]
        top = np.sort(logits)[::-1]
        gap = float(top[0] - top[1])
        assert gap <= float(_ulp(top[0])), (
            f"request {i} parts from the reference at token {j}, where its top two logits are "
            f"{gap:.3e} apart, more than one bf16 ulp ({float(_ulp(top[0])):.3e})"
        )
        partings.append((i, j, gap))
    return partings


def _serve(build, serve_cls, req_cls, model, **kw):
    sched, _, _ = build(model, serve_cls(max_seqs=2, max_seq_len=MAX_LEN, **kw))
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    done = sched.run(reqs)
    return [list(r.generated) for r in sorted(done, key=lambda r: r.rid)], done, sched.stats


_LEGS = {
    "paged": dict(kv_layout="paged"),
    "slot": dict(kv_layout="slot"),
    "int8": dict(kv_layout="paged", kv_dtype="int8"),
}


@pytest.mark.parametrize("jax_mode", ["pallas", "dense"])
@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_mixed_streams_match_jax_engine(lms, leg, jax_mode):
    """6 requests through 2 slots on each layout and on int8 pools: the
    port's greedy streams equal the JAX engine's (its Pallas kernels in
    interpret mode, or its dense attention), every request finishes, and
    the decode-step, token and prefill counts are equal."""
    jm, tm = lms
    ref, _, jstats = _serve(jax_build_scheduler, JServeConfig, JRequest, jm, decode_kernel=jax_mode, **_LEGS[leg])
    ours, done, tstats = _serve(build_scheduler, ServeConfig, Request, tm, debug_invariants=True, **_LEGS[leg])
    _assert_streams(jm, ours, ref, PROMPTS)
    assert all(r.status == RequestStatus.FINISHED for r in done)
    assert tstats.decode_steps == jstats.decode_steps
    assert tstats.tokens_generated == jstats.tokens_generated
    assert tstats.prefill_batches == jstats.prefill_batches


@pytest.mark.parametrize("jax_mode", ["pallas", "dense"])
@pytest.mark.parametrize("branch", [1, 2])
@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_mixed_spec_streams_match_jax_engine(lms, leg, branch, jax_mode):
    """Linear (branch 1) and token-tree (branch 2) speculation on each
    layout and on int8 pools: the port's streams equal the JAX engine's
    and its own plain streams, with equal verify and acceptance counts."""
    jm, tm = lms
    kw = dict(spec_draft="ngram", spec_k=3, spec_branch=branch, **_LEGS[leg])
    ref, _, jstats = _serve(jax_build_scheduler, JServeConfig, JRequest, jm, decode_kernel=jax_mode, **kw)
    ours, done, tstats = _serve(build_scheduler, ServeConfig, Request, tm, debug_invariants=True, **kw)
    _assert_streams(jm, ours, ref, PROMPTS)
    plain, _, _ = _serve(build_scheduler, ServeConfig, Request, tm, **_LEGS[leg])
    assert ours == plain
    assert all(r.status == RequestStatus.FINISHED for r in done)
    assert tstats.verify_steps == jstats.verify_steps > 0 and tstats.decode_steps == jstats.decode_steps == 0
    assert tstats.draft_tokens_accepted == jstats.draft_tokens_accepted
    assert tstats.tree_verify_steps == jstats.tree_verify_steps


@pytest.mark.parametrize("jax_mode", ["pallas", "dense"])
@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_mixed_multistep_streams_match_jax_engine(lms, leg, jax_mode):
    """decode_multistep=True windows: the port's streams equal the JAX
    engine's multistep streams and the port's own plain streams, with
    equal decode-step counts."""
    jm, tm = lms
    kw = dict(decode_multistep=True, max_fused_steps=4, **_LEGS[leg])
    ref, _, jstats = _serve(jax_build_scheduler, JServeConfig, JRequest, jm, decode_kernel=jax_mode, **kw)
    ours, _, tstats = _serve(build_scheduler, ServeConfig, Request, tm, **kw)
    _assert_streams(jm, ours, ref, PROMPTS)
    plain, _, _ = _serve(build_scheduler, ServeConfig, Request, tm, **_LEGS[leg])
    assert ours == plain
    assert tstats.decode_steps == jstats.decode_steps
    assert tstats.multistep_steps > tstats.multistep_windows > 0


def _forward_floor(jm, tm, seqs):
    """How far the two packages' full no-cache mixed forwards of the same
    token sequences differ, in bf16 ulps of each row's largest logit."""
    floor = 0.0
    for seq in seqs:
        batch = np.zeros((2, MAX_LEN), dtype=np.int32)
        batch[0, : len(seq)] = seq
        ours = tm.forward({"tokens": batch})[0, : len(seq)].float().numpy()
        floor = max(floor, _row_ulps(ours, _jax_logits(jm, seq)))
    return floor


@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_mixed_verify_logits_match_jax_engine(lms, leg):
    """One tree verify and one linear verify step on each layout: the
    port's host logits are float32 and equal the JAX engine's (Pallas
    kernels) bf16 verify logits within one bf16 ulp of each row's largest
    logit beyond the floor of the two packages' full forwards on the
    prompts and their linear drafts; lengths unmoved."""
    jm, tm = lms
    rng = np.random.default_rng(9)
    kw = dict(max_seqs=2, max_seq_len=MAX_LEN, **_LEGS[leg])
    _, jeng, jcache = jax_build_scheduler(jm, JServeConfig(decode_kernel="pallas", **kw))
    _, teng, tcache = build_scheduler(tm, ServeConfig(**kw))
    prompts = [[3, 1, 4, 1, 5], [9, 2]]
    for c in (jcache, tcache):
        assert [c.alloc(len(p), 30) for p in prompts] == [0, 1]
    jeng.prefill(jm.params, prompts, [0, 1])
    _, last = teng.prefill(tm.params, prompts, [0, 1])
    assert last.dtype == torch.bfloat16
    w = 7
    tokens = rng.integers(0, VOCAB, size=(2, w)).astype(np.int32)
    parents = np.full((2, w), -1, dtype=np.int32)
    for j in range(1, w):
        parents[:, j] = rng.integers(0, j, size=2)
    draft_lens = np.asarray([w, 4], dtype=np.int32)

    floor = _forward_floor(jm, tm, [p + list(tokens[i, :4]) for i, p in enumerate(prompts)])

    def close(got, ref):
        assert got.dtype == np.float32
        ulps = _row_ulps(got, np.asarray(jnp.asarray(ref).astype(jnp.float32)))
        assert ulps <= floor + 1.0, (ulps, floor)

    ref = jeng.verify_tree(jm.params, tokens, draft_lens, parents)
    got = teng.verify_tree(tm.params, tokens, draft_lens, parents)
    close(got[0], np.asarray(ref)[0])
    close(got[1, :4], np.asarray(ref)[1, :4])
    np.testing.assert_array_equal(tcache.lengths, [5, 2])
    lens = np.asarray([4, 2], np.int32)
    lin_ref = np.asarray(jeng.verify(jm.params, tokens[:, :4], lens))
    lin = teng.verify(tm.params, tokens[:, :4], lens)
    close(lin[0], lin_ref[0])
    close(lin[1, :2], lin_ref[1, :2])


@pytest.mark.parametrize("leg", ["paged", "slot"])
def test_mixed_decode_logits_match_a_full_forward(lms, leg):
    """Cache equivalence under mixed precision on fp32 pools: the
    prefill's and every decode step's bf16 logits against the full
    no-cache mixed forward of prompt + generated tokens, within
    CACHE_ULPS bf16 ulps of each row's largest logit."""
    _, tm = lms
    _, engine, cache = build_scheduler(tm, ServeConfig(max_seqs=2, max_seq_len=MAX_LEN, **_LEGS[leg]))
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    slots = [cache.alloc(len(p), MAX_LEN) for p in prompts]
    nxt, last = engine.prefill(tm.params, prompts, slots)
    seqs = [list(p) + [int(t)] for p, t in zip(prompts, nxt)]
    step_logits = [[last[i]] for i in range(2)]
    tokens = np.zeros(2, dtype=np.int32)
    active = np.ones(2, dtype=bool)
    for _ in range(10):
        tokens[slots] = [s[-1] for s in seqs]
        nxt, logits = engine.decode(tm.params, tokens, active)
        assert logits.dtype == torch.bfloat16
        for i, s in enumerate(slots):
            seqs[i].append(int(nxt[s]))
            step_logits[i].append(logits[s])
    for i, p in enumerate(prompts):
        batch = np.zeros((2, MAX_LEN), dtype=np.int32)
        batch[0, : len(seqs[i]) - 1] = seqs[i][:-1]
        full = tm.forward({"tokens": batch})[0, len(p) - 1 : len(seqs[i]) - 1].float()
        got = torch.stack(step_logits[i]).float()
        ulps = _row_ulps(got.numpy(), full.numpy())
        assert ulps <= CACHE_ULPS, (leg, i, ulps)


def test_generate_of_a_mixed_model_matches_jax_generate(lms):
    """generate() on a mixed-precision model equals the JAX package's
    generate() of the same model, prompts and ServeConfig."""
    jm, tm = lms
    serve = dict(max_seqs=3, max_seq_len=MAX_LEN)
    ref = jm.generate(PROMPTS, max_new_tokens=5, serve_config=JServeConfig(**serve))
    ours = tm.generate(PROMPTS, max_new_tokens=5, serve_config=ServeConfig(**serve))
    _assert_streams(jm, ours, ref, PROMPTS)
    assert all(len(s) == 5 for s in ours)


def test_greedy_pick_takes_the_first_of_tied_bf16_logits(lms):
    """bf16 logits tie far more often than f32 ones: the engine's greedy
    pick (its on-device selection at temperature 0, which prefill, chunk
    steps and the decode core run) takes the first maximal index, as
    jnp.argmax does."""
    _, tm = lms
    _, engine, _ = build_scheduler(tm, ServeConfig(max_seqs=2, max_seq_len=MAX_LEN))
    rng = np.random.default_rng(3)
    logits = np.round(rng.standard_normal((6, 64)) * 4) / 4  # few distinct values: many ties
    logits[:, 7] = logits[:, 40] = logits.max() + 1.0  # an exact tie at the top of every row
    ours = engine._select_device(torch.from_numpy(logits).bfloat16(), None, None).numpy()
    ref = np.asarray(jnp.argmax(jnp.asarray(logits).astype(jnp.bfloat16), axis=-1))
    np.testing.assert_array_equal(ours, ref)
    assert (ours == 7).all()

