"""flexflow_tpu_torch serving against the JAX package: greedy streams
through the whole stack (ServeConfig -> build_scheduler -> engine ->
KV cache -> decode kernel seam) token-identical to the JAX engine on
both KV layouts, with equal decode-step and token counts; cached decode
logits against a full no-cache forward (atol 1e-4); the paged
allocator step for step against the JAX allocator; and the request
lifecycle. All on the CPU, where the kernel wrappers take their plain
versions."""

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
from flexflow_tpu.serving.kv_cache import KVCacheSpec as JSpec
from flexflow_tpu.serving.kv_cache import PagedKVCache as JPaged
from flexflow_tpu_torch import DataType, FFConfig, FFModel
from flexflow_tpu_torch.models import build_decoder_lm
from flexflow_tpu_torch.runtime.interop import params_from_host
from flexflow_tpu_torch.serving import (
    KVCacheSpec,
    PagedKVCache,
    Request,
    RequestStatus,
    ServeConfig,
    build_scheduler,
)

pytestmark = pytest.mark.serving

VOCAB = 64
MAX_LEN = 32
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 3, 1, 2], [7], [11, 12], [3, 3, 3]]
MAX_NEW = [6, 3, 8, 5, 2, 7]


@pytest.fixture(scope="module")
def lms():
    """(jax model, port model) sharing the same weights by guid."""
    jm = JFFModel(JFFConfig(batch_size=2, seed=0))
    tok = jm.create_tensor([2, MAX_LEN], dtype=JDataType.INT32, name="tokens")
    jax_build_decoder_lm(jm, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=2, ff_dim=64)
    jm.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[],
        devices=jax.devices()[:1],
    )
    tm = FFModel(FFConfig(batch_size=2, seed=0))
    tok = tm.create_tensor([2, MAX_LEN], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(tm, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=2, ff_dim=64)
    tm.compile(device="cpu")
    host = jm.executor.export_host_params(jm.params)
    params_from_host(tm, {g: [np.asarray(w) for w in ws] for g, ws in host.items()})
    return jm, tm


def _serve(build, serve_cls, req_cls, model, **kw):
    sched, _, _ = build(model, serve_cls(max_seqs=2, max_seq_len=MAX_LEN, **kw))
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    done = sched.run(reqs)
    return {r.rid: (r.status, list(r.generated)) for r in done}, sched.stats


@pytest.mark.parametrize("jax_mode", ["pallas", "dense"])
@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_streams_match_jax_engine(lms, layout, jax_mode):
    """6 requests through 2 slots (slot reuse, mixed budgets): the port's
    greedy streams equal the JAX engine's, with its Pallas kernel
    (interpret mode) or its dense attention, and so do the counts."""
    jm, tm = lms
    jstreams, jstats = _serve(
        jax_build_scheduler, JServeConfig, JRequest, jm, kv_layout=layout, decode_kernel=jax_mode
    )
    tstreams, tstats = _serve(build_scheduler, ServeConfig, Request, tm, kv_layout=layout, debug_invariants=True)
    assert tstreams == jstreams
    assert all(s == RequestStatus.FINISHED for s, _ in tstreams.values())
    assert tstats.decode_steps == jstats.decode_steps
    assert tstats.tokens_generated == jstats.tokens_generated
    assert tstats.prefill_batches == jstats.prefill_batches


def test_static_scheduler_matches_jax(lms):
    jm, tm = lms
    jstreams, jstats = _serve(jax_build_scheduler, JServeConfig, JRequest, jm, scheduler="static")
    tstreams, tstats = _serve(build_scheduler, ServeConfig, Request, tm, scheduler="static")
    assert tstreams == jstreams
    assert tstats.decode_steps == jstats.decode_steps
    _, cstats = _serve(build_scheduler, ServeConfig, Request, tm)
    # continuous batching never holds a finished request's slot hostage
    assert cstats.decode_steps < tstats.decode_steps
    assert cstats.occupancy > tstats.occupancy


def test_generate_matches_jax_generate(lms):
    jm, tm = lms
    serve = dict(max_seqs=3, max_seq_len=MAX_LEN)
    ref = jm.generate(PROMPTS, max_new_tokens=5, serve_config=JServeConfig(**serve))
    assert tm.generate(PROMPTS, max_new_tokens=5, serve_config=ServeConfig(**serve)) == ref


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_decode_logits_match_full_forward(lms, layout):
    """Cache equivalence: each cached decode step's logits equal the
    full no-cache forward of prompt + generated tokens."""
    _, tm = lms
    _, engine, cache = build_scheduler(tm, ServeConfig(max_seqs=2, max_seq_len=MAX_LEN, kv_layout=layout))
    prompts, n_new = [[3, 1, 4, 1, 5], [9, 2]], 9
    slots = [cache.alloc(len(p), len(p) + n_new) for p in prompts]
    nxt, last = engine.prefill(tm.params, prompts, slots)
    seqs = [list(p) + [int(t)] for p, t in zip(prompts, nxt)]
    got = [[last[i]] for i in range(2)]
    tokens = np.zeros(2, dtype=np.int32)
    active = np.ones(2, dtype=bool)
    for _ in range(n_new - 1):
        tokens[slots] = [s[-1] for s in seqs]
        nxt, logits = engine.decode(tm.params, tokens, active)
        for i, s in enumerate(slots):
            seqs[i].append(int(nxt[s]))
            got[i].append(logits[s])
    for i, p in enumerate(prompts):
        full = tm.forward({"tokens": np.asarray([seqs[i][:-1]], dtype=np.int32)})[0]
        torch.testing.assert_close(torch.stack(got[i]), full[len(p) - 1:], atol=1e-4, rtol=0)


def test_paged_allocator_matches_jax():
    """The same admission / page-claim / free sequence on both
    allocators gives the same verdicts and block tables."""
    geo = dict(layer_guids=(100,), max_seqs=3, max_len=32, num_heads=1, head_dim=4,
               buckets=(16, 32), page_size=8, num_pages=10)
    j = JPaged(JSpec(**geo), jnp.float32)
    t = PagedKVCache(KVCacheSpec(**geo), torch.float32, "cpu")
    ops = [("alloc", 5, 20), ("alloc", 9, 16), ("alloc", 3, 30), ("ensure", 0, 8),
           ("ensure", 0, 16), ("free", 1), ("alloc", 3, 30), ("ensure", 2, 8), ("ensure", 2, 9),
           ("free", 0), ("alloc", 1, 12), ("free", 2)]
    for op in ops:
        if op[0] == "alloc":
            assert t.can_admit(op[1], op[2]) == j.can_admit(op[1], op[2])
            assert t.alloc(op[1], op[2]) == j.alloc(op[1], op[2])
        elif op[0] == "ensure":
            t.ensure_position(op[1], op[2])
            j.ensure_position(op[1], op[2])
        else:
            t.free(op[1])
            j.free(op[1])
        t.check_invariants()
        j.check_invariants()
        np.testing.assert_array_equal(t.block_tables, j.block_tables)
        assert t.num_free_pages == j.num_free_pages and t.num_free == j.num_free


def test_eos_stops_a_stream(lms):
    _, tm = lms
    serve = ServeConfig(max_seqs=2, max_seq_len=MAX_LEN)
    (full,) = tm.generate([[5, 6, 7]], max_new_tokens=8, serve_config=serve)
    eos = full[2]
    (cut,) = tm.generate([[5, 6, 7]], max_new_tokens=8, serve_config=serve, eos_token=eos)
    assert cut == full[: full.index(eos) + 1]


def test_request_lifecycle(lms):
    _, tm = lms
    sched, _, cache = build_scheduler(tm, ServeConfig(max_seqs=2, max_seq_len=MAX_LEN))
    too_long = Request(rid=0, prompt=[1] * 30, max_new_tokens=8)
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit(too_long)
    assert not sched.submit(Request(rid=1, prompt=[], max_new_tokens=2), strict=False)
    sched.submit(Request(rid=2, prompt=[1, 2], max_new_tokens=4))
    sched.submit(Request(rid=3, prompt=[3], max_new_tokens=4))
    sched.submit(Request(rid=4, prompt=[4], max_new_tokens=4))
    sched.submit(Request(rid=5, prompt=[5], max_new_tokens=4, deadline_s=1e-9))
    assert sched.cancel(4) and not sched.cancel(4) and not sched.cancel(99)
    done = {r.rid: r for r in sched.run()}
    assert done[1].status == RequestStatus.FAILED and "empty" in done[1].error
    assert done[4].status == RequestStatus.CANCELLED
    assert done[5].status == RequestStatus.TIMED_OUT
    assert done[2].ok and done[3].ok and len(done[2].generated) == 4
    assert cache.num_free == 2 and cache.num_free_pages == cache.spec.num_pages
    s = sched.stats
    assert (s.finished_requests, s.failed_requests, s.cancelled_requests, s.timed_out_requests) == (2, 1, 1, 1)
    assert s.tokens_generated == 8 and s.tokens_per_s > 0


def test_serve_config_takes_only_the_slice():
    for kw in (dict(kv_swap=True), dict(prefix_evict="cost", prefix_cache=True), dict(decode_kernel="pallas")):
        with pytest.raises(NotImplementedError):
            ServeConfig(**kw)
    for kw in (dict(kv_layout="ring"), dict(max_seq_len=30, kv_page_size=16),
               dict(kv_dtype="int8", kv_layout="slot"), dict(kv_dtype="bf16"),
               dict(spec_draft="ngram", spec_k=8, spec_branch=8),
               dict(spec_draft="ngram", spec_k=64), dict(temperature=-0.1),
               dict(admission="eager"), dict(max_preemptions=-1), dict(prefix_cache=True, kv_layout="slot"),
               dict(token_budget=-1), dict(token_budget=64, chunk_size=0),
               dict(token_budget=8, chunk_size=16), dict(token_budget=64, chunk_size=12),
               dict(token_budget=64, scheduler="static"), dict(prefix_evict="fifo"),
               dict(serve_async=True, scheduler="static"), dict(prefix_evict="lru"),
               dict(adapters=-1), dict(classes="gold:4,gold:1"), dict(classes="gold:x")):
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    # the serving features this slice ports, all at once
    ServeConfig(temperature=0.8, seed=7, token_budget=128, chunk_size=16, prefix_cache=True,
                admission="optimistic", max_preemptions=2, prefix_evict="lru", serve_async=True)
    # multi-tenancy and the small-model draft
    ServeConfig(adapters=2, adapter_rank=8, classes="gold:4,bronze:1", spec_draft="model", spec_k=4)
    # the widest verify the decode kernels take: 1 + 9 * 7 = 64 rows
    ServeConfig(spec_draft="ngram", spec_k=9, spec_branch=7, kv_dtype="int8")
    assert ServeConfig().kv_layout == "paged" and ServeConfig().scheduler == "continuous"
