"""flexflow_tpu_torch's prefix cache (`ServeConfig(prefix_cache=True)`:
PagedKVCache.alloc_shared / register_prefix / copy-on-write, the
engine's prefill_suffix, the scheduler's shared admission) against the
port without it and against the JAX package's prefix cache, on fp32 and
int8 pools, monolithic and chunked, greedy and sampled. Every run checks
the allocator's invariants (refcounts re-derived from the block tables)
after each iteration. Tolerances: tokens exact; block tables,
refcounts, hit and copy counts equal the JAX cache's; suffix logits
within 1e-4 of the JAX engine's."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
from flexflow_tpu_torch.serving import ServeConfig
from torch_serving_models import ATOL, JAX, PAGE, PORT, SLOTS, build_lms, one_torch_thread, prompts, serve  # noqa: F401 (autouse)

pytestmark = pytest.mark.serving

SYSTEM = prompts(31, (19,))[0]  # a shared system prompt: 2 full pages and 3 tokens
TAILS = prompts(32, (2, 5, 0, 9, 3, 13, 1, 0))
PROMPTS = [SYSTEM + t for t in TAILS]
PROMPTS[7] = SYSTEM[:16]  # a whole-prompt match: its first write copies a shared page
MAX_NEW = [8, 6, 9, 5, 7, 4, 10, 6]
LEGS = {"paged": {}, "int8": dict(kv_dtype="int8")}


@pytest.fixture(scope="module")
def lms():
    return build_lms()


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_prefix_streams_match_unshared_and_jax(lms, leg, chunked):
    """Greedy streams with the prefix cache equal the streams without it
    (fp32; int8 shares pages quantized from the same rows, so equal there
    too) and the JAX scheduler's prefix-cache streams, with the same
    prefix hits and copy-on-write copies."""
    jm, tm = lms
    kw = dict(LEGS[leg], **(dict(token_budget=32, chunk_size=8) if chunked else {}))
    plain, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ours, stats, sched = serve(PORT, tm, PROMPTS, MAX_NEW, prefix_cache=True, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, prefix_cache=True, decode_kernel="dense", **kw)
    assert ours == ref
    assert ours == plain
    assert (stats.prefix_hits, stats.cow_copies) == (jstats.prefix_hits, jstats.cow_copies)
    assert stats.prefix_hits > 0 and stats.prefix_tokens_skipped > 0
    cache = sched.cache
    assert cache.num_free_pages == cache.spec.num_pages and not cache._prefix_index


def test_prefix_streams_match_jax_pallas_and_sampled(lms):
    """Sampled at temperature 0.8 with the prefix cache, against the JAX
    scheduler running its Pallas kernels in the interpreter."""
    jm, tm = lms
    kw = dict(prefix_cache=True, temperature=0.8, seed=21)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="pallas", **kw)
    assert ours == ref and stats.prefix_hits == jstats.prefix_hits > 0


def _cache_state(cache):
    return (np.asarray(cache.block_tables).tolist(), np.asarray(cache.lengths).tolist(),
            np.asarray(cache._refcounts).tolist(), np.asarray(cache._entry_shared).tolist(),
            sorted(cache._prefix_index.values()), cache.prefix_hits, cache.cow_copies)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_allocator_states_equal_the_jax_cache(lms, leg):
    """Step by step through the same iterations, the port's block tables,
    lengths, refcounts, shared flags, published pages and counters equal
    the JAX cache's, and both caches' invariants hold after each one."""
    jm, tm = lms
    from flexflow_tpu.serving import Request as JRequest
    from flexflow_tpu.serving import ServeConfig as JServeConfig
    from flexflow_tpu.serving import build_scheduler as jax_build_scheduler
    from flexflow_tpu_torch.serving import Request, build_scheduler

    cfg = dict(max_seqs=SLOTS, max_seq_len=64, kv_page_size=PAGE, prefix_cache=True, **LEGS[leg])
    port, _, pcache = build_scheduler(tm, ServeConfig(**cfg))
    ref, _, jcache = jax_build_scheduler(jm, JServeConfig(decode_kernel="dense", **cfg))
    for sched, req in ((port, Request), (ref, JRequest)):
        for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
            sched.submit(req(rid=i, prompt=list(p), max_new_tokens=n))
    steps = 0
    while port.work_pending() or ref.work_pending():
        port.step()
        ref.step()
        pcache.check_invariants()
        jcache.check_invariants()
        assert _cache_state(pcache) == _cache_state(jcache), f"iteration {steps}"
        steps += 1
    assert pcache.cow_copies > 0


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_copy_on_write_copies_rows_and_scales(lms, leg):
    """A whole-prompt match writes into its last shared page: the page is
    copied (K/V rows in every layer, and the per-head scales on int8
    pools) before the write, and the holder that stays keeps its page
    untouched."""
    _, tm = lms
    from flexflow_tpu_torch.serving import build_scheduler

    _, eng, cache = build_scheduler(tm, ServeConfig(max_seqs=SLOTS, max_seq_len=64, kv_page_size=PAGE,
                                                    prefix_cache=True, **LEGS[leg]))
    seq = SYSTEM[:16]
    a = cache.alloc(len(seq), 24)
    eng.prefill(tm.params, [seq], [a])
    cache.register_prefix(a, seq, len(seq))
    g = cache.spec.layer_guids[-1]
    page = int(cache.block_tables[a, 1])
    before = cache.k[g][page].clone()
    b, cursor = cache.alloc_shared(seq, len(seq), 24)
    assert cursor == 15 and int(cache.block_tables[b, 1]) == page and cache._refcounts[page] == 2
    nxt, _ = eng.prefill_suffix(tm.params, [seq], [b], [cursor])
    new = int(cache.block_tables[b, 1])
    assert new != page and cache.cow_copies == 1 and cache._refcounts[page] == 1
    assert torch.equal(cache.k[g][page], before)
    assert torch.equal(cache.k[g][new][:7], before[:7])
    if cache.quantized:
        assert torch.equal(cache.k_scale[g][new], cache.k_scale[g][page])
    cache.check_invariants()


def test_suffix_past_the_kernel_rows_runs_in_steps(lms, monkeypatch):
    """A suffix longer than the decode kernels' MAX_W rows (lowered to 8
    here) runs as successive chunk steps of at most MAX_W rows; its token
    equals the JAX engine's prefill_suffix (one step) and its logits lie
    within 1e-4 of it."""
    jm, tm = lms
    from flexflow_tpu.serving import ServeConfig as JServeConfig
    from flexflow_tpu.serving import build_scheduler as jax_build_scheduler
    from flexflow_tpu_torch.serving import build_scheduler
    from flexflow_tpu_torch.serving.engine import GenerationEngine

    monkeypatch.setattr(dk, "MAX_W", 8)
    widths = []
    real = GenerationEngine.prefill_chunk

    def spy(self, params, tokens, chunk_lens, final=None):
        widths.append(tokens.shape[1])
        return real(self, params, tokens, chunk_lens, final)

    monkeypatch.setattr(GenerationEngine, "prefill_chunk", spy)
    seq = PROMPTS[5]  # 19 + 13 tokens: a suffix of 16 past 2 shared pages
    out = {}
    for name, build, serve_cls, model, extra in (
        ("port", build_scheduler, ServeConfig, tm, {}),
        ("jax", jax_build_scheduler, JServeConfig, jm, dict(decode_kernel="dense")),
    ):
        _, e, c = build(model, serve_cls(max_seqs=SLOTS, max_seq_len=64, kv_page_size=PAGE,
                                         prefix_cache=True, **extra))
        a = c.alloc(len(SYSTEM), 40)
        e.prefill(model.params, [SYSTEM], [a])
        c.register_prefix(a, SYSTEM, len(SYSTEM))
        b, cursor = c.alloc_shared(seq, len(seq), 40)
        assert cursor == 16
        nxt, logits = e.prefill_suffix(model.params, [seq], [b], [cursor])
        out[name] = (int(nxt[0]), np.asarray(logits[0].cpu() if torch.is_tensor(logits) else logits[0]))
    assert widths == [8, 8]
    assert out["port"][0] == out["jax"][0]
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=ATOL, rtol=0)


def test_unported_prefix_and_swap_options_raise():
    """prefix_evict "cost" and kv_swap name their ROADMAP item; "lru" is
    taken."""
    for kw in (dict(prefix_evict="cost"), dict(kv_swap=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeConfig(prefix_cache=True, **kw)
    assert ServeConfig(prefix_cache=True, prefix_evict="lru").prefix_evict == "lru"
