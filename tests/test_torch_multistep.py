"""flexflow_tpu_torch's device-resident multi-step decode
(`ServeConfig(decode_multistep=True)`: scheduler._fusable_steps /
_decode_multi_step, engine.decode_multi over the decode core) against
the port's own one-at-a-time decode and against the JAX package's
multistep engine and scheduler, on the slot layout, fp32 pools and int8
pools. On the CPU the window runs the decode core eagerly k times (the
card replays a captured CUDA graph of the same core: tests/
test_torch_cuda.py). Tolerances: a window against sequential port steps
is exact (the same core, the same shapes); against the JAX engine,
tokens exactly and logits within atol 1e-4, the port's serving
tolerance."""

import types

import numpy as np
import pytest
import torch

import jax

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
from flexflow_tpu_torch.serving.engine import GenerationEngine, quant_plan

pytestmark = pytest.mark.serving

VOCAB = 64
MAX_LEN = 32
ATOL = 1e-4
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 3, 1, 2], [7], [11, 12], [3, 3, 3]]
MAX_NEW = [10, 6, 12, 9, 4, 11]

_LEGS = {
    "slot": dict(kv_layout="slot"),
    "paged": dict(kv_layout="paged"),
    "int8": dict(kv_layout="paged", kv_dtype="int8"),
}


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


def _requests(cls, **kw):
    return [cls(rid=i, prompt=list(p), max_new_tokens=n, **kw) for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]


def _run(build, serve_cls, req_cls, model, reqs=None, **kw):
    sched, _, cache = build(model, serve_cls(max_seqs=3, max_seq_len=MAX_LEN, **kw))
    done = sched.run(reqs if reqs is not None else _requests(req_cls))
    return {r.rid: (r.status, list(r.generated)) for r in done}, sched.stats, cache


def _prefilled(build, serve_cls, model, leg, prompts):
    """An engine with `prompts` admitted into slots 0.. and prefilled;
    returns (engine, cache, the first generated tokens [max_seqs])."""
    _, eng, cache = build(model, serve_cls(max_seqs=3, max_seq_len=MAX_LEN, **_LEGS[leg]))
    slots = [cache.alloc(len(p), MAX_LEN) for p in prompts]
    assert slots == list(range(len(prompts)))
    first, _ = eng.prefill(model.params, prompts, slots)
    cur = np.zeros(3, dtype=np.int32)
    cur[: len(prompts)] = np.asarray(first)
    return eng, cache, cur


WINDOW_PROMPTS = [[3, 1, 4, 1, 5], [9, 2]]


# -- the engine window --------------------------------------------------------------------


@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_window_equals_sequential_steps(lms, leg):
    """decode_multi over K = 4 reproduces 4 sequential port decode steps
    exactly, tokens and whole logit rows (the window runs the same core),
    and leaves the same lengths (reference tests/test_multistep.py
    test_multistep_engine_logit_identity)."""
    _, tm = lms
    K = 4
    active = np.array([True, True, False])
    seq_eng, seq_cache, cur = _prefilled(build_scheduler, ServeConfig, tm, leg, WINDOW_PROMPTS)
    seq_toks, seq_logits = [], []
    for _ in range(K):
        nxt, logits = seq_eng.decode(tm.params, cur, active)
        seq_toks.append(nxt.copy())
        seq_logits.append(logits.clone())
        cur = np.where(active, nxt, cur).astype(np.int32)
    eng, cache, start = _prefilled(build_scheduler, ServeConfig, tm, leg, WINDOW_PROMPTS)
    toks_ks, logits_ks, mask_ks = eng.decode_multi(tm.params, start, active, np.where(active, K, 0))
    assert toks_ks.shape == (K, 3) and logits_ks.shape == (K, 3, VOCAB) and mask_ks.shape == (K, 3)
    for i in range(K):
        np.testing.assert_array_equal(toks_ks[i][active], seq_toks[i][active], err_msg=f"step {i}")
        assert torch.equal(logits_ks[i][active], seq_logits[i][active]), f"step {i}"
    assert mask_ks[:, active].all() and not mask_ks[:, ~active].any()
    assert eng.window_finite[:, active].all()
    np.testing.assert_array_equal(cache.lengths, seq_cache.lengths)
    cache.check_invariants()
    if leg != "slot":
        np.testing.assert_array_equal(cache.block_tables, seq_cache.block_tables)
    for g in cache.spec.layer_guids:  # the live rows, not the scratch row
        assert torch.equal(cache.k[g], seq_cache.k[g]) and torch.equal(cache.v[g], seq_cache.v[g])
        if leg == "int8":
            assert torch.equal(cache.k_scale[g], seq_cache.k_scale[g])


@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_window_matches_jax_engine(lms, leg):
    """The port's decode_multi against the JAX engine's decode_multi on
    the same weights, prompts and per-slot limits (one slot stops early):
    tokens and masks exactly, logits within atol 1e-4, same lengths."""
    jm, tm = lms
    active = np.array([True, True, False])
    limits = np.array([4, 2, 0], dtype=np.int32)
    jeng, jcache, jcur = _prefilled(jax_build_scheduler, JServeConfig, jm, leg, WINDOW_PROMPTS)
    teng, tcache, tcur = _prefilled(build_scheduler, ServeConfig, tm, leg, WINDOW_PROMPTS)
    np.testing.assert_array_equal(tcur, jcur)
    jt, jl, jmask = jeng.decode_multi(jm.params, jcur, active, limits)
    tt, tl, tmask = teng.decode_multi(tm.params, tcur, active, limits)
    np.testing.assert_array_equal(tmask, np.asarray(jmask))
    taken = tmask
    np.testing.assert_array_equal(tt[taken], np.asarray(jt)[taken])
    np.testing.assert_allclose(tl.numpy()[taken], np.asarray(jl)[taken], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tcache.lengths, np.asarray(jcache.lengths))


def test_window_rejects_what_it_cannot_run(lms):
    _, tm = lms
    eng, _, cur = _prefilled(build_scheduler, ServeConfig, tm, "paged", WINDOW_PROMPTS)
    active = np.array([True, True, False])
    with pytest.raises(ValueError, match="at least one"):
        eng.decode_multi(tm.params, cur, active, np.zeros(3, dtype=np.int32))
    with pytest.raises(ValueError, match="max_fused_steps"):
        eng.decode_multi(tm.params, cur, active, np.full(3, 9, dtype=np.int32))
    eng.max_fused_steps = MAX_LEN
    with pytest.raises(ValueError, match="max_len"):
        eng.decode_multi(tm.params, cur, active, np.array([2, MAX_LEN - 1, 0], dtype=np.int32))


def test_device_int8_write_matches_the_host_plan():
    """The decode core's int8 write (_quant_write: every row re-derives
    its page's scale with torch.where, dead rows on the scratch page)
    gives the pool and scales that _quant_scatter's host plan gives for
    the live rows: fresh pages claimed from their first row, rows reusing
    a stored scale, a reallocated page re-deriving its stale scale."""
    rng = np.random.default_rng(0)
    P, ps, h, d = 6, 4, 2, 16
    spec = types.SimpleNamespace(page_size=ps, num_pages=P, num_heads=h, head_dim=d)
    stub = types.SimpleNamespace(cache=types.SimpleNamespace(spec=spec))
    host_pool, host_scale = torch.zeros(P, ps, h, d, dtype=torch.int8), torch.zeros(P, h)
    pool, scale = torch.zeros(P + 1, ps, h, d, dtype=torch.int8), torch.zeros(P + 1, h)
    scratch = P * ps
    for i, live in enumerate([[0, 8, 20], [3, 10, 13], [8, 21, 23]]):  # one row per page, as in decode
        rows = (rng.standard_normal((len(live) + 2, h, d)) * (1.0 + 3 * i)).astype(np.float32)
        parts = [torch.from_numpy(a) for a in quant_plan(np.asarray(live), ps)]
        GenerationEngine._quant_scatter(stub, host_pool, host_scale, torch.from_numpy(rows[: len(live)]), *parts)
        dest = torch.tensor(live + [scratch, scratch])
        GenerationEngine._quant_write(stub, pool, scale, torch.from_numpy(rows), dest)
        assert torch.equal(pool[:P], host_pool) and torch.equal(scale[:P], host_scale)


# -- the scheduler ------------------------------------------------------------------------


@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_multistep_streams_match_plain_and_jax(lms, leg):
    """6 requests through 3 slots with decode_multistep=True: the port's
    streams equal its plain streams and the JAX scheduler's multistep
    streams, with the same decode-step, window and fused-step counts as
    the JAX scheduler; the windows really fused, and with fewer host
    reads than plain decode (reference test_multistep_matches_plain_*)."""
    jm, tm = lms
    kw = dict(_LEGS[leg], decode_multistep=True)
    jstreams, jstats, _ = _run(jax_build_scheduler, JServeConfig, JRequest, jm, **kw)
    tstreams, tstats, cache = _run(build_scheduler, ServeConfig, Request, tm, debug_invariants=True, **kw)
    plain, pstats, _ = _run(build_scheduler, ServeConfig, Request, tm, **_LEGS[leg])
    assert tstreams == plain == jstreams
    assert all(status == RequestStatus.FINISHED for status, _ in tstreams.values())
    assert tstats.decode_steps == jstats.decode_steps
    assert tstats.multistep_windows == jstats.multistep_windows > 0
    assert tstats.multistep_steps == jstats.multistep_steps > tstats.multistep_windows
    assert tstats.tokens_generated == pstats.tokens_generated
    assert tstats.host_syncs < pstats.host_syncs
    assert tstats.host_syncs_per_token < pstats.host_syncs_per_token
    # prefill batches plus decode steps, one host read each
    assert pstats.host_syncs == pstats.prefill_batches + pstats.decode_steps
    assert tstats.multistep_cache_entries == 0  # no graph on the CPU
    cache.check_invariants()


@pytest.mark.parametrize("leg", ["slot", "paged"])
def test_eos_inside_window_retires_at_position(lms, leg):
    """A token the greedy continuation emits mid-stream, declared EOS:
    the window retires the slot at that position, emits nothing past it,
    and returns the rows (and pages) it reserved past it."""
    _, tm = lms
    reqs = lambda **kw: [Request(rid=0, prompt=list(PROMPTS[0]), max_new_tokens=14, **kw)]
    free, _, _ = _run(build_scheduler, ServeConfig, Request, tm, reqs=reqs(), **_LEGS[leg])
    stream = free[0][1]
    eos = int(stream[7])
    cut = stream.index(eos) + 1
    assert 1 < cut < len(stream)
    kw = dict(_LEGS[leg], debug_invariants=True)
    plain, _, _ = _run(build_scheduler, ServeConfig, Request, tm, reqs=reqs(eos_token=eos), **kw)
    fused, stats, cache = _run(build_scheduler, ServeConfig, Request, tm, reqs=reqs(eos_token=eos),
                               decode_multistep=True, **kw)
    assert plain[0] == fused[0] == (RequestStatus.FINISHED, stream[:cut])
    assert stats.multistep_windows > 0
    cache.check_invariants()


def test_page_boundary_truncates_window(lms):
    """With 4-token pages and 8-step windows every window stops at its
    slots' next page boundary (at most one fresh page per slot per
    window), and the streams stay those of plain decode."""
    jm, tm = lms
    kw = dict(kv_page_size=4, max_fused_steps=8)
    plain, _, _ = _run(build_scheduler, ServeConfig, Request, tm, **kw)
    fused, stats, cache = _run(build_scheduler, ServeConfig, Request, tm, decode_multistep=True,
                               debug_invariants=True, **kw)
    jfused, jstats, _ = _run(jax_build_scheduler, JServeConfig, JRequest, jm, decode_multistep=True, **kw)
    assert fused == plain == jfused
    assert stats.multistep_windows > 1
    assert stats.multistep_steps <= 4 * stats.multistep_windows
    assert (stats.multistep_windows, stats.multistep_steps) == (jstats.multistep_windows, jstats.multistep_steps)
    cache.check_invariants()


def test_speculative_serving_fuses_only_draft_free_iterations(lms):
    """Under n-gram speculation an iteration that drafted verifies and
    one where no slot drafted runs a fused window; the stream equals
    plain decode's and the JAX scheduler's, with its counts."""
    jm, tm = lms
    kw = dict(spec_draft="ngram", spec_k=3, kv_layout="slot", decode_multistep=True)
    jstreams, jstats, _ = _run(jax_build_scheduler, JServeConfig, JRequest, jm, **kw)
    sched, _, _ = build_scheduler(tm, ServeConfig(max_seqs=3, max_seq_len=MAX_LEN, **kw))
    fused_in = []
    window = sched._decode_multi_step

    def checked(k):
        kind, drafts = sched._cached_proposals
        fused_in.append(sum(len(d) for d in drafts.values()))
        return window(k)

    sched._decode_multi_step = checked
    done = sched.run(_requests(Request))
    streams = {r.rid: (r.status, list(r.generated)) for r in done}
    plain, _, _ = _run(build_scheduler, ServeConfig, Request, tm, kv_layout="slot")
    assert streams == plain == jstreams
    s = sched.stats
    assert s.verify_steps > 0 and s.multistep_windows > 0 and fused_in and not any(fused_in)
    assert (s.verify_steps, s.multistep_windows, s.multistep_steps) == (
        jstats.verify_steps, jstats.multistep_windows, jstats.multistep_steps
    )


def test_flags_wire_through_and_validate(lms):
    """FFConfig's serve_decode_multistep / serve_max_fused_steps reach the
    scheduler and the engine through ServeConfig.from_config and
    build_scheduler, generate() serves with them, and the reference's
    validation holds."""
    _, tm = lms
    cfg = FFConfig(serve_decode_multistep=True, serve_max_fused_steps=4, serve_max_seqs=3,
                   serve_max_seq_len=MAX_LEN)
    serve = ServeConfig.from_config(cfg)
    assert serve.decode_multistep is True and serve.max_fused_steps == 4
    sched, eng, _ = build_scheduler(tm, serve)
    assert sched.decode_multistep is True and sched.max_fused_steps == 4 and eng.max_fused_steps == 4
    assert ServeConfig.from_config(FFConfig()).decode_multistep is False
    assert ServeConfig().max_fused_steps == 8
    got = tm.generate(PROMPTS, max_new_tokens=7, serve_config=serve)
    assert got == tm.generate(PROMPTS, max_new_tokens=7, serve_config=ServeConfig(max_seqs=3, max_seq_len=MAX_LEN))
    with pytest.raises(ValueError):
        ServeConfig(decode_multistep=True, max_fused_steps=0)
    with pytest.raises(ValueError):
        ServeConfig(decode_multistep=True, scheduler="static")


def test_single_step_windows_do_not_fuse(lms):
    """max_fused_steps=1 keeps every iteration a plain decode step."""
    _, tm = lms
    plain, pstats, _ = _run(build_scheduler, ServeConfig, Request, tm)
    one, stats, _ = _run(build_scheduler, ServeConfig, Request, tm, decode_multistep=True, max_fused_steps=1)
    assert one == plain and stats.multistep_windows == 0
    assert stats.host_syncs == pstats.host_syncs
