"""flexflow_tpu_torch's async double-buffered serving loop
(`ServeConfig(serve_async=True)`: scheduler.AsyncContinuousBatchingScheduler,
the dispatch / reconcile pairs of engine.py and the caches' in-flight
windows) and its LRU published-prefix eviction (`prefix_evict="lru"`),
against the port's own synchronous loop and against the JAX package's
AsyncContinuousBatchingScheduler and PagedKVCache on the same weights
(carried across by runtime/interop.py), on a tiny decoder LM (2 layers,
hidden 32, vocab 50, as tests/test_async_engine.py builds it). The JAX
scheduler runs dense attention.

Tolerances: tokens exact; step, dispatch, pre-proposal, preemption and
eviction counts and the caches' pinned and free pages equal the JAX
package's at every step.

The ports of tests/test_async_engine.py's tests of what this slice
brings keep their names. Left out: the chaos test (it needs
serving/faults.py) and the model-draft test (spec_draft="model"), whose
modules are not ported, and the verify-cache LRU tests (the port keeps
no cache of compiled step programs). The reference's ordering of the
overlapped host time, async above sync, is kept; no wall-clock
threshold is."""

import numpy as np
import pytest
import torch

from flexflow_tpu.serving import KVCacheSpec as JKVCacheSpec
from flexflow_tpu.serving import PagedKVCache as JPagedKVCache
from flexflow_tpu.serving import PagePoolExhausted as JPagePoolExhausted
from flexflow_tpu_torch import FFConfig
from flexflow_tpu_torch.serving import (
    AsyncContinuousBatchingScheduler,
    ContinuousBatchingScheduler,
    InflightStep,
    KVCacheSpec,
    PagedKVCache,
    Request,
    RequestStatus,
    ServeConfig,
    build_scheduler,
    generate,
)
from flexflow_tpu_torch.serving.kv_cache import PagePoolExhausted
from torch_serving_models import JAX, LEGS, PORT, build_lms, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.serving

VOCAB = 50
LEN = 64  # max_seq_len
_PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1, 4, 1, 5], [7, 7, 2]]
_CHUNK_PROMPTS = [[(i * 7 + j) % (VOCAB - 1) + 1 for j in range(n)] for i, n in enumerate([13, 22, 2, 18, 9])]


@pytest.fixture(scope="module")
def lms():
    return build_lms(vocab=VOCAB, hidden=32, ff_dim=64)


def _run(side, model, prompts, max_new, eos=None, lead=False, **kw):
    """Serve `prompts` through one package's build_scheduler (the port's
    with its cache invariants checked after every iteration). `lead`:
    the first request runs an iteration ahead of the rest. Returns
    ({rid: (status, generated)}, stats, scheduler)."""
    build, serve_cls, req_cls = side
    kw = dict(dict(max_seqs=4, max_seq_len=LEN, kv_page_size=8, debug_invariants=side is PORT), **kw)
    if side is JAX:
        kw.setdefault("decode_kernel", "dense")
    sched, _, _ = build(model, serve_cls(**kw))
    reqs = [req_cls(rid=i, prompt=list(p), max_new_tokens=max_new, eos_token=eos) for i, p in enumerate(prompts)]
    if lead:
        sched.submit(reqs.pop(0))
        sched.step()
    for r in reqs:
        sched.submit(r)
    while sched.work_pending():
        sched.step()
    return {r.rid: (r.status, list(r.generated)) for r in sched.finished}, sched.stats, sched


def _three(lms, prompts, max_new, **kw):
    """The port's sync run, the port's async run and the JAX async run."""
    jm, tm = lms
    return (_run(PORT, tm, prompts, max_new, **kw), _run(PORT, tm, prompts, max_new, serve_async=True, **kw),
            _run(JAX, jm, prompts, max_new, serve_async=True, **kw))


def _counts(stats):
    return (stats.decode_steps, stats.verify_steps, stats.chunk_steps, stats.busy_slot_steps, stats.dispatch_count,
            stats.multistep_windows, stats.preemptions, stats.tokens_generated)


def _same(sync, asy, ref):
    """The three runs' streams equal, every request finished, and the
    async runs' step counts equal."""
    assert asy[0] == sync[0] == ref[0]
    assert all(status == RequestStatus.FINISHED for status, _ in asy[0].values())
    assert isinstance(asy[2], AsyncContinuousBatchingScheduler) and not asy[2]._inflight
    assert _counts(asy[1]) == _counts(ref[1])


@pytest.mark.parametrize("leg,temperature", [("slot", 0.0), ("paged", 0.0), ("int8", 0.0), ("paged", 0.8)])
def test_async_matches_sync_and_jax_streams(lms, leg, temperature):
    """Slot layout, fp32 and int8 pools, greedy and sampled: the async
    streams equal the sync streams and the JAX async scheduler's."""
    _same(*_three(lms, [_PROMPTS[i % 5] for i in range(6)], 8, temperature=temperature, seed=5, **LEGS[leg]))


@pytest.mark.parametrize("leg", ["slot", "paged"])
def test_async_matches_sync_with_eos_mid_stream(lms, leg):
    """EOS lands while the next step is in flight: its token is
    discarded, and the streams still equal the sync loop's."""
    _, tm = lms
    plain = _run(PORT, tm, [_PROMPTS[i % 5] for i in range(4)], 10, **LEGS[leg])[0]
    eos = plain[0][1][len(plain[0][1]) // 2]
    sync, asy, ref = _three(lms, [_PROMPTS[i % 5] for i in range(4)], 10, eos=eos, **LEGS[leg])
    assert any(len(g) < 10 and g[-1] == eos for _, g in sync[0].values())
    _same(sync, asy, ref)


@pytest.mark.parametrize("leg", ["slot", "paged"])
def test_async_matches_sync_with_speculation(lms, leg):
    """Linear n-gram speculation: while verify N is in flight the loop
    drafts N + 1; the streams equal the sync loop's and the JAX
    scheduler's, and so do the pre-proposal hits and misses."""
    sync, asy, ref = _three(lms, [_PROMPTS[i % 5] for i in range(6)], 24, spec_draft="ngram", spec_k=3, **LEGS[leg])
    _same(sync, asy, ref)
    s, js = asy[1], ref[1]
    assert (s.pre_proposal_hits, s.pre_proposal_misses) == (js.pre_proposal_hits, js.pre_proposal_misses)
    assert s.pre_proposal_hits > 0 and s.pre_proposal_misses > 0
    assert (s.draft_tokens_proposed, s.draft_tokens_accepted) == (js.draft_tokens_proposed, js.draft_tokens_accepted)
    assert sync[1].pre_proposal_hits == sync[1].pre_proposal_misses == 0


@pytest.mark.parametrize("leg", ["paged", "int8"])
def test_async_tree_speculation_matches_sync_and_jax(lms, leg):
    """Token trees draft fresh each iteration (no pre-proposals)."""
    sync, asy, ref = _three(lms, [_PROMPTS[i % 5] for i in range(6)], 16, spec_draft="ngram", spec_k=3,
                            spec_branch=2, **LEGS[leg])
    _same(sync, asy, ref)
    assert asy[1].tree_verify_steps == ref[1].tree_verify_steps > 0
    assert asy[1].pre_proposal_hits == asy[1].pre_proposal_misses == 0


@pytest.mark.parametrize("leg,spec_kw", [("slot", {}), ("paged", {}), ("paged", dict(spec_draft="ngram", spec_k=3))],
                         ids=["slot-plain", "paged-plain", "paged-spec"])
def test_async_chunked_matches_sync_and_unchunked(lms, leg, spec_kw):
    """Chunked prefill commits only at reconcile: a chunk step rides the
    device beside the decode or verify; the async chunked streams equal
    the sync chunked run's, the unchunked run's and the JAX async
    scheduler's, with every prompt token streamed in by chunks."""
    _, tm = lms
    plain = _run(PORT, tm, _CHUNK_PROMPTS, 6, **LEGS[leg], **spec_kw)[0]
    sync, asy, ref = _three(lms, _CHUNK_PROMPTS, 6, token_budget=16, chunk_size=8, **LEGS[leg], **spec_kw)
    _same(sync, asy, ref)
    assert asy[0] == plain
    for s in (sync[1], asy[1]):
        assert s.chunk_steps > 0 and s.chunk_tokens == sum(len(p) for p in _CHUNK_PROMPTS)


def test_async_multistep_windows_match_sync_and_jax(lms):
    """Fused windows through the deque: a window drains what is in
    flight before it dispatches and is drained at the next iteration's
    top; the streams and window counts equal the JAX scheduler's."""
    sync, asy, ref = _three(lms, [_PROMPTS[i % 5] for i in range(4)], 20, decode_multistep=True, max_fused_steps=4)
    _same(sync, asy, ref)
    assert asy[1].multistep_steps == ref[1].multistep_steps > asy[1].multistep_windows > 0


def test_async_forced_preemption_completes_all(lms):
    """The smallest legal pool under optimistic admission forces
    preemption (int8 pools); pages pinned by the in-flight step come
    back by a drain before anyone is preempted. Every request finishes,
    with the sync loop's and the JAX async scheduler's streams and
    preemptions."""
    kw = dict(max_seq_len=32, kv_page_size=4, kv_pages=8, admission="optimistic", max_preemptions=8, **LEGS["int8"])
    sync, asy, ref = _three(lms, [_PROMPTS[i % 5] for i in range(6)], 10, **kw)
    _same(sync, asy, ref)
    assert asy[1].preemptions == ref[1].preemptions > 0


def _shared(n=10, system=16):
    rng = np.random.RandomState(3)
    head = [int(t) for t in rng.randint(1, VOCAB, system)]
    return [head + [int(t) for t in rng.randint(1, VOCAB, 8 + (i * 5) % 7)] for i in range(n)]


def test_async_prefix_cache_matches_sync_and_jax(lms):
    """The prefix cache under the async loop with chunked admissions:
    each chunk commit publishes from the step's own record; streams,
    hits and copies equal the JAX scheduler's (monolithic shared
    admissions run in the eviction test below)."""
    sync, asy, ref = _three(lms, _shared(), 6, lead=True, prefix_cache=True, token_budget=16, chunk_size=8)
    _same(sync, asy, ref)
    s, js = asy[1], ref[1]
    assert (s.prefix_hits, s.cow_copies) == (js.prefix_hits, js.cow_copies)
    assert s.prefix_hits > 0 and s.prefix_tokens_skipped > 0


def test_lru_prefix_eviction_matches_jax_scheduler(lms):
    """prefix_evict="lru" on a pool too small to keep every released
    published page: pages are evicted, and the sync and async streams,
    hits and evictions equal the JAX async scheduler's; the same traffic
    with prefix_evict="none" gives the same streams."""
    kw = dict(lead=True, prefix_cache=True, kv_pages=16)
    sync, asy, ref = _three(lms, _shared(12), 6, prefix_evict="lru", **kw)
    _same(sync, asy, ref)
    none = _run(PORT, lms[1], _shared(12), 6, **kw)
    assert none[0] == asy[0] and none[1].prefix_evictions == 0
    assert sync[1].prefix_evictions == asy[1].prefix_evictions == ref[1].prefix_evictions > 0
    assert (asy[1].prefix_hits, asy[1].cow_copies) == (ref[1].prefix_hits, ref[1].cow_copies)


@pytest.mark.parametrize("half", ["_decode_core", "_wait"], ids=["dispatch", "reconcile"])
def test_failed_dispatch_or_reconcile_fails_its_requests(lms, half):
    """No fallback: a dispatch or a reconcile that raises fails the
    requests running then (one step fault), its in-flight window closes,
    and the queue behind them is served."""
    _, tm = lms
    sched, eng, cache = build_scheduler(tm, ServeConfig(max_seqs=2, max_seq_len=32, serve_async=True,
                                                        debug_invariants=True))
    real, calls = getattr(eng, half), [0]

    def broken(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("injected")
        return real(*a, **kw)

    setattr(eng, half, broken)
    done = sched.run([Request(rid=i, prompt=list(_PROMPTS[i % 5]), max_new_tokens=6) for i in range(5)])
    failed = [r for r in done if r.status == RequestStatus.FAILED]
    assert len(failed) == 2 and all(r.error == "decode step failed: RuntimeError('injected')" for r in failed)
    assert sum(r.ok for r in done) == 3 and sched.stats.step_faults == 1
    assert cache._inflight_depth == 0 and cache.pinned_pages == 0
    cache.check_invariants()


def test_async_no_wasted_slot_steps_on_budget_streams(lms):
    """Without EOS the budget gate predicts every retirement, so the
    async loop does exactly the sync loop's useful slot work."""
    _, tm = lms
    prompts = [_PROMPTS[i % 5] for i in range(8)]
    sync = _run(PORT, tm, prompts, 8)[1]
    asy = _run(PORT, tm, prompts, 8, serve_async=True)[1]
    assert asy.busy_slot_steps == sync.busy_slot_steps
    assert asy.tokens_generated == sync.tokens_generated


def test_overlap_and_dispatch_gap_stats(lms):
    """Both loops count dispatches and gaps; the async loop puts a whole
    iteration of host work between a dispatch and its reconcile, the
    sync loop none; TTFT is stamped at commit; one host sync a
    reconcile."""
    _, tm = lms
    prompts = [_PROMPTS[i % 5] for i in range(6)]
    sync = _run(PORT, tm, prompts, 8)
    asy = _run(PORT, tm, prompts, 8, serve_async=True)
    for done, s, sched in (sync, asy):
        assert s.dispatch_count == s.decode_steps > 0
        assert s.mean_dispatch_gap_s > 0.0
        assert 0.0 <= s.overlap_fraction <= 1.0
        assert s.commit_wait_s >= 0.0
        assert s.host_syncs == s.dispatch_count + s.prefill_batches
        assert all(r.ttft_s > 0.0 for r in sched.finished)
    assert asy[1].overlapped_host_s > sync[1].overlapped_host_s
    assert asy[1].overlap_fraction > sync[1].overlap_fraction


def test_async_cancel_of_running_defers_to_reconcile(lms):
    """A running request's cancel waits for the next reconcile; the
    others finish and the cache's accounting holds."""
    _, tm = lms
    sched, _, cache = build_scheduler(tm, ServeConfig(max_seqs=4, max_seq_len=32, serve_async=True,
                                                      debug_invariants=True))
    for i in range(4):
        sched.submit(Request(rid=i, prompt=list(_PROMPTS[i]), max_new_tokens=12))
    for _ in range(3):  # fill the pipeline
        sched.step()
    assert sched._inflight
    victim = next(iter(sched.running.values()))
    assert sched.cancel(victim.rid) is True
    assert victim.status == RequestStatus.RUNNING and victim.rid in sched._pending_cancels
    sched.run([])
    assert victim.status == RequestStatus.CANCELLED and victim.slot is None
    assert all(r.status in (RequestStatus.FINISHED, RequestStatus.CANCELLED) for r in sched.finished)
    assert sum(r.status == RequestStatus.FINISHED for r in sched.finished) == 3
    cache.check_invariants()


def test_serve_async_flag_and_builder_wiring(lms):
    """FFConfig.serve_async reaches ServeConfig and build_scheduler;
    generate() serves with it; the static scheduler refuses it."""
    _, tm = lms
    cfg = FFConfig(serve_async=True, serve_prefix_cache=True, serve_prefix_evict="lru")
    serve = ServeConfig.from_config(cfg)
    assert serve.serve_async is True and serve.prefix_evict == "lru"
    sched, _, cache = build_scheduler(tm, ServeConfig(max_seqs=4, max_seq_len=32, serve_async=True))
    assert isinstance(sched, AsyncContinuousBatchingScheduler)
    sched, _, _ = build_scheduler(tm, ServeConfig(max_seqs=4, max_seq_len=32))
    assert isinstance(sched, ContinuousBatchingScheduler)
    assert not isinstance(sched, AsyncContinuousBatchingScheduler)
    with pytest.raises(ValueError, match="continuous"):
        ServeConfig(scheduler="static", serve_async=True)
    with pytest.raises(ValueError, match="prefix_cache"):
        ServeConfig(prefix_evict="lru")
    prompts = [_PROMPTS[i % 5] for i in range(5)]
    kw = dict(max_seqs=4, max_seq_len=32)
    assert generate(tm, prompts, 6, ServeConfig(serve_async=True, **kw)) == generate(tm, prompts, 6, ServeConfig(**kw))


def test_inflight_step_snapshot_is_immutable_view(lms):
    """The record the reconcile reads holds host copies: a later write
    to cache.lengths or the input tokens cannot reach a dispatched
    step's snapshot or its result."""
    _, tm = lms

    def prefilled():
        _, engine, cache = build_scheduler(tm, ServeConfig(max_seqs=4, max_seq_len=32))
        slot = cache.alloc(2, 32)
        engine.prefill(tm.params, [[1, 2]], [slot])
        return engine, cache, slot

    engine, cache, slot = prefilled()
    tokens = np.zeros(4, dtype=np.int32)
    active = np.zeros(4, dtype=bool)
    active[slot] = True
    want, _ = prefilled()[0].decode(tm.params, tokens, active)
    step = engine.decode_dispatch(tm.params, tokens, active)
    assert isinstance(step, InflightStep) and step.kind == "decode"
    pre = int(step.lengths[slot])
    cache.lengths[slot] = 31  # a hostile write after the dispatch
    tokens[:] = 7
    assert int(step.lengths[slot]) == pre
    nxt, logits = engine.decode_reconcile(step)
    assert torch.isfinite(logits[slot]).all() and step.finite[slot]
    assert nxt.shape == (4,) and nxt[slot] == want[slot]


# -- in-flight page pinning, against the JAX package's PagedKVCache ---------------


def _caches(num_pages=12, page_size=4, max_seqs=3, max_len=16, **kw):
    """The same paged cache in both packages."""
    import jax.numpy as jnp

    geo = dict(layer_guids=(0,), max_seqs=max_seqs, max_len=max_len, num_heads=2, head_dim=4, buckets=(max_len,),
               page_size=page_size, num_pages=num_pages)
    return PagedKVCache(KVCacheSpec(**geo), torch.float32, "cpu", **kw), JPagedKVCache(JKVCacheSpec(**geo),
                                                                                      jnp.float32, **kw)


def _both(caches, op):
    """Apply `op` to both caches; they must return the same and then
    agree on pinned and free pages, and hold their invariants."""
    outs = [op(c) for c in caches]
    assert outs[0] == outs[1]
    ours, ref = caches
    assert (ours.pinned_pages, ours.num_free_pages) == (ref.pinned_pages, ref.num_free_pages)
    for c in caches:
        c.check_invariants()
    return outs[0]


def test_inflight_window_pins_released_pages():
    caches = _caches()
    slot = _both(caches, lambda c: c.alloc(8, 8))
    free_before = caches[0].num_free_pages
    _both(caches, lambda c: c.begin_inflight())
    _both(caches, lambda c: c.free(slot))
    # the window pins the released pages: not free, not allocatable
    assert caches[0].pinned_pages == 2 and caches[0].num_free_pages == free_before
    _both(caches, lambda c: c.end_inflight())
    assert caches[0].pinned_pages == 0 and caches[0].num_free_pages == free_before + 2


def test_inflight_release_waits_for_the_window_open_at_release():
    """Window 1 (step N) open, window 2 (step N + 1) opens, window 1
    closes, then pages release: they stay pinned until window 2 closes."""
    caches = _caches()
    s0 = _both(caches, lambda c: c.alloc(8, 8))
    for op in (lambda c: c.begin_inflight(), lambda c: c.begin_inflight(), lambda c: c.end_inflight(),
               lambda c: c.free(s0)):
        _both(caches, op)
    assert caches[0].pinned_pages == 2
    _both(caches, lambda c: c.end_inflight())
    assert caches[0].pinned_pages == 0


def test_inflight_window_balance_is_enforced():
    for cache in _caches():
        with pytest.raises(RuntimeError):
            cache.end_inflight()


def test_reserve_claim_inside_window_names_pinned_pages():
    """A reserve slot's claim that needs a pinned page back says so (the
    async scheduler's drain-then-retry keys off it) and succeeds once
    the window closes."""
    caches = _caches(num_pages=4, page_size=4, max_seqs=2)
    s0 = _both(caches, lambda c: c.alloc(4, 16))
    for op in (lambda c: c.ensure_position(s0, 4), lambda c: c.begin_inflight(), lambda c: c.truncate(s0, 4),
               lambda c: c.ensure_position(s0, 4), lambda c: c.ensure_position(s0, 8)):
        _both(caches, op)
    assert caches[0].pinned_pages == 1
    for cache, exc in zip(caches, (PagePoolExhausted, JPagePoolExhausted)):
        with pytest.raises(exc, match="pinned by an in-flight"):
            cache.ensure_position(s0, 12)
    _both(caches, lambda c: c.end_inflight())
    _both(caches, lambda c: c.ensure_position(s0, 12))


def test_lru_eviction_matches_jax_cache():
    """The same admissions, publications and releases on both caches
    under prefix_evict="lru": the same pages are retained and evicted in
    the same order (least recently released first), a retained page that
    a new admission matches is mapped again at no cost, and a page
    released inside an in-flight window is not evictable until the
    window closes."""
    caches = _caches(num_pages=8, page_size=4, max_seqs=3, max_len=16, prefix_cache=True, prefix_evict="lru")
    seqs = {n: [n * 10 + j for j in range(12)] for n in (1, 2, 3, 4)}

    def admit(c, n, pages=12):
        slot, cursor = c.alloc_shared(seqs[n], prompt_len=pages, total_len=16)
        c.lengths[slot] = pages  # as the prefill leaves it
        c.register_prefix(slot, seqs[n], pages)
        return slot, cursor

    def state(c):
        return (c.prefix_evictions, sorted(c._pub_only), c.block_tables.tolist(), c.num_free_pages)

    def evictable():
        return caches[0]._evictable_count(), caches[1]._evictable_count(0)

    a = _both(caches, lambda c: admit(c, 1))
    _both(caches, lambda c: c.free(a[0]))
    b = _both(caches, lambda c: admit(c, 2))
    _both(caches, lambda c: c.free(b[0]))
    assert state(caches[0]) == state(caches[1]) and len(caches[0]._pub_only) == 6
    # 2 free pages: the third page evicts the page released first
    c3 = _both(caches, lambda c: admit(c, 3))
    assert state(caches[0]) == state(caches[1]) and caches[0].prefix_evictions == 1
    # sequence 2 is still published: its admission maps its 3 pages again
    again = _both(caches, lambda c: c.alloc_shared(seqs[2], prompt_len=12, total_len=12))
    assert again[1] == 11 and state(caches[0]) == state(caches[1]) and evictable() == (2, 2)
    # released inside a window: retained, but not evictable until it closes
    _both(caches, lambda c: c.begin_inflight())
    _both(caches, lambda c: c.free(c3[0]))
    assert state(caches[0]) == state(caches[1]) and evictable() == (2, 2)
    _both(caches, lambda c: c.end_inflight())
    assert evictable() == (5, 5)
    _both(caches, lambda c: c.free(again[0]))
    d = _both(caches, lambda c: admit(c, 4))
    assert state(caches[0]) == state(caches[1]) and caches[0].prefix_evictions == 4
    _both(caches, lambda c: c.free(d[0]))
    assert state(caches[0]) == state(caches[1]) and evictable() == (8, 8)
