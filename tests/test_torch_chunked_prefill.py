"""flexflow_tpu_torch's chunked prefill (`ServeConfig(token_budget,
chunk_size)`: scheduler._plan_chunks / _chunk_once, engine.prefill_chunk
through the verify core at the chunk's width) against the port's own
monolithic prefill and against the JAX scheduler's chunked prefill, on
the slot layout, fp32 pools and int8 pools, greedy and sampled. The
budgets here stay at or under 64 tokens, so the reference plans the same
grants whether its kernels are on or not. Tolerances: tokens exact;
chunk logits within 1e-4 of the monolithic prefill's and of the JAX
engine's chunk logits (the reference's own bit-equality test of chunk
against monolithic logits does not hold on this CPU either); on int8
pools within 1e-2 of the monolithic prefill's. Sampled streams compare
with the JAX scheduler's only: chunking changes which slot a later
request takes, and a draw is keyed by its slot."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
from flexflow_tpu_torch.serving import ServeConfig
from torch_serving_models import ATOL, JAX, LEGS, PORT, SLOTS, build_lms, one_torch_thread, prompts, serve  # noqa: F401 (autouse)

pytestmark = pytest.mark.serving

# long prompts interleaved with short ones, as phase 4e (b) of chip_smoke.py
PROMPTS = prompts(21, (30, 2, 44, 5, 17, 1, 38, 3))
MAX_NEW = [6, 12, 5, 10, 8, 12, 7, 9]
CHUNKED = dict(token_budget=32, chunk_size=16)
INT8_ATOL = 1e-2  # chip_smoke.py's near-tie gap on int8 pools


@pytest.fixture(scope="module")
def lms():
    return build_lms()


@pytest.fixture(scope="module")
def monolithic(lms):
    """The port's monolithic greedy streams of PROMPTS on each leg."""
    return {leg: serve(PORT, lms[1], PROMPTS, MAX_NEW, **kw)[0] for leg, kw in LEGS.items()}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_chunked_streams_match_monolithic_and_jax(lms, monolithic, leg, temperature):
    """Chunked streams equal the JAX scheduler's chunked streams (dense
    attention) and, greedy, the port's monolithic streams, with the same
    chunk steps, chunk tokens and budget deferrals."""
    jm, tm = lms
    kw = dict(LEGS[leg], temperature=temperature, seed=17)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **CHUNKED, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **CHUNKED, **kw)
    assert ours == ref
    if temperature == 0.0:
        # a sampled stream keys its draws by slot, and chunking moves
        # which slot a later request gets: only greedy streams compare
        assert ours == monolithic[leg]
    assert all(status == "finished" for status, _, _ in ours.values())
    assert (stats.chunk_steps, stats.chunk_tokens, stats.budget_deferrals) == (
        jstats.chunk_steps, jstats.chunk_tokens, jstats.budget_deferrals)
    assert stats.chunk_steps > 0 and stats.chunk_tokens == sum(len(p) for p in PROMPTS)
    assert stats.prefill_batches == 0


def test_chunked_streams_match_jax_pallas_scheduler(lms):
    """The same against the JAX scheduler running its Pallas kernels in
    the interpreter (paged fp32 pools, a budget of 48 in chunks of 16)."""
    jm, tm = lms
    kw = dict(token_budget=48, chunk_size=16)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="pallas", **kw)
    assert ours == ref and stats.chunk_steps == jstats.chunk_steps


def test_each_iteration_stays_inside_its_budget(lms):
    """Chunks plus the decode step's reservation never exceed
    token_budget in any iteration, iteration for iteration as the
    reference's budget gauge reads."""
    jm, tm = lms
    traces = ([], [])
    serve(PORT, tm, PROMPTS, MAX_NEW, budget_trace=traces[0], **CHUNKED)
    serve(JAX, jm, PROMPTS, MAX_NEW, budget_trace=traces[1], decode_kernel="dense", **CHUNKED)
    assert traces[0] == traces[1]
    assert 0 < max(traces[0]) <= CHUNKED["token_budget"]


def test_chunk_widths_stop_at_the_kernels_rows(lms, monolithic, monkeypatch):
    """A budget past the decode kernels' MAX_W rows: each grant stops at
    MAX_W (here lowered to 16) and the step's width, padded up to a
    multiple of chunk_size, never passes it; the streams stay those of the
    monolithic prefill."""
    _, tm = lms
    monkeypatch.setattr(dk, "MAX_W", 16)
    monkeypatch.setattr("flexflow_tpu_torch.serving.scheduler.MAX_W", 16)
    from flexflow_tpu_torch.serving.engine import GenerationEngine

    widths = []
    real = GenerationEngine.prefill_chunk_dispatch

    def spy(self, params, tokens, chunk_lens, final=None):
        widths.append((tokens.shape[1], int(np.max(chunk_lens))))
        return real(self, params, tokens, chunk_lens, final)

    # every chunk step, the scheduler's and prefill_suffix's, dispatches here
    monkeypatch.setattr(GenerationEngine, "prefill_chunk_dispatch", spy)
    ours, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, token_budget=64, chunk_size=8)
    assert ours == monolithic["paged"]
    assert widths and all(w <= 16 and c <= w for w, c in widths)
    assert any(c == 16 for _, c in widths)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_chunk_logits_match_monolithic_prefill_and_jax(lms, leg):
    """Engine level: a 29-token prompt streamed in chunks of 8, 16 and 5
    gives the monolithic prefill's first token, and its final chunk's
    logits lie within 1e-4 of the JAX engine's prefill_chunk logits on the
    same chunks and of the monolithic prefill's (on int8 pools within
    INT8_ATOL of it: a last-digit difference in a layer's K or V can move
    its int8 rounding by one step of the page's scale)."""
    jm, tm = lms
    from flexflow_tpu.serving import ServeConfig as JServeConfig
    from flexflow_tpu.serving import build_scheduler as jax_build_scheduler
    from flexflow_tpu_torch.serving import build_scheduler

    prompt = prompts(5, (29,))[0]
    cfg = dict(max_seqs=SLOTS, max_seq_len=64, kv_page_size=8, **LEGS[leg])
    _, eng, cache = build_scheduler(tm, ServeConfig(**cfg))
    slot = cache.alloc(len(prompt), 40)
    first, mono = eng.prefill(tm.params, [prompt], [slot])
    outs = {}
    for name, (build, serve_cls, model, extra) in {
        "port": (build_scheduler, ServeConfig, tm, {}),
        "jax": (jax_build_scheduler, JServeConfig, jm, dict(decode_kernel="dense")),
    }.items():
        _, e, c = build(model, serve_cls(**cfg, **extra))
        s = c.alloc(0, 40)
        start = 0
        for size in (8, 16, 5):
            tokens = np.zeros((SLOTS, 16), dtype=np.int32)
            lens = np.zeros(SLOTS, dtype=np.int32)
            tokens[s, :size] = prompt[start:start + size]
            lens[s] = size
            nxt, logits = e.prefill_chunk(model.params, tokens, lens)
            start += size
        assert int(c.lengths[s]) == len(prompt)
        outs[name] = (int(nxt[s]), np.asarray(logits[s].cpu() if torch.is_tensor(logits) else logits[s]))
    assert outs["port"][0] == outs["jax"][0] == int(first[0])
    np.testing.assert_allclose(outs["port"][1], mono[0].numpy(), atol=INT8_ATOL if leg == "int8" else ATOL, rtol=0)
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], atol=ATOL, rtol=0)


def test_no_fused_window_opens_while_a_chunk_streams(lms):
    """decode_multistep beside chunked prefill: windows open only once no
    prompt streams and no final chunk committed this iteration; streams
    equal the eager chunked run's and the JAX scheduler's."""
    jm, tm = lms
    kw = dict(CHUNKED, decode_multistep=True)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    eager, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **CHUNKED)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **kw)
    assert ours == eager == ref
    assert stats.multistep_windows == jstats.multistep_windows > 0


def test_chunked_speculation_matches_jax(lms):
    """Linear speculation beside chunked prefill: drafts fit in the budget
    the chunks leave; streams and draft counts equal the JAX scheduler's."""
    jm, tm = lms
    kw = dict(CHUNKED, spec_draft="ngram", spec_k=3)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **kw)
    assert ours == ref
    assert (stats.verify_steps, stats.draft_tokens_proposed) == (jstats.verify_steps, jstats.draft_tokens_proposed)
