"""flexflow_tpu_torch's small-model draft (`ServeConfig(spec_draft="model")`
with a `draft_model`: serving/spec.py ModelDraftProposer over its own
slot KVCache, slot-aligned with the target through KVCache.claim)
against the JAX package, on the CPU, on the shared tiny LM of
tests/torch_serving_models.py as the target and a second seeded LM (1
layer, hidden 32) as the draft.

Tolerances: exact. KVCache.claim's slot ledgers and errors equal the
reference's; greedy streams, verify steps, acceptance and the draft's
counters (draft steps, catch-up feeds, fresh draft tokens) equal the JAX
engine's, linear and tree, on the slot layout, fp32 and int8 pools, under
preemption too; a draft with the target's own weights accepts every
token; the async loop equals the sync one and pre-proposes nothing for
this stateful draft."""

import numpy as np
import pytest

from flexflow_tpu.serving.kv_cache import KVCache as JKVCache
from flexflow_tpu_torch.serving import KVCache, ServeConfig, build_scheduler
from torch_serving_models import JAX, LEGS, PORT, SLOTS, build_lms, one_torch_thread, prompts, serve  # noqa: F401 (autouse)

pytestmark = pytest.mark.serving

PROMPTS = prompts(5, (3, 9, 1, 14, 6, 2))
MAX_NEW = [10, 7, 12, 9, 11, 8]
SPEC = dict(spec_draft="model", spec_k=4)


@pytest.fixture(scope="module")
def lms():
    return build_lms()


@pytest.fixture(scope="module")
def drafts():
    """(jax draft, port draft): 1 layer, hidden 32, its own seed."""
    return build_lms(hidden=32, ff_dim=64, layers=1, seed=3)


def _counters(sched):
    p = sched.proposer
    return p.draft_steps, p.catchup_feeds, p.draft_tokens


def test_claim_matches_the_reference(lms):
    """The same claim / alloc / free sequence leaves the same free heap,
    active set and lengths, and refusals raise the reference's errors."""
    jm, tm = lms
    caches = (KVCache.from_model(tm, max_seqs=SLOTS, max_len=32), JKVCache.from_model(jm, max_seqs=SLOTS, max_len=32))
    ops = [("claim", 2), ("alloc",), ("claim", 2), ("claim", 0), ("claim", 9), ("free", 2), ("claim", 2),
           ("alloc",), ("alloc",), ("claim", 1), ("free", 1), ("claim", 1)]
    for op in ops:
        outcomes = []
        for cache in caches:
            try:
                outcomes.append(getattr(cache, op[0])(*op[1:]))
            except ValueError as e:
                outcomes.append(("ValueError", str(e)))
            cache.lengths[list(cache._active)] = 3
        assert outcomes[0] == outcomes[1], op
        assert caches[0]._free == caches[1]._free and caches[0]._active == caches[1]._active, op
        assert np.array_equal(caches[0].lengths, np.asarray(caches[1].lengths)), op
        caches[0].check_invariants()


@pytest.mark.parametrize("leg", ["slot", "paged"])
def test_self_draft_accepts_every_token(lms, leg):
    """The target as its own draft: acceptance exactly 1.0 and the plain
    greedy streams, through claim, prefill, catch-up feeds and rollback.
    (On int8 pools the target reads the int8 round trip of its rows and
    the draft its own fp32 cache: they may disagree there.)"""
    tm = lms[1]
    plain, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **LEGS[leg])
    ours, stats, sched = serve(PORT, tm, PROMPTS, MAX_NEW, draft_model=tm, **LEGS[leg], **SPEC)
    assert ours == plain
    assert stats.draft_tokens_proposed > 0 and stats.acceptance_rate == 1.0
    assert sched.proposer.catchup_feeds > 0


@pytest.mark.parametrize("branch", [1, 3])
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_model_draft_matches_jax(lms, drafts, leg, branch):
    """Linear (branch 1: #4/#5/#6 verify at w = 5) and tree (branch 3)
    speculation with the seeded draft: the streams, verify steps,
    accepted tokens and the draft's counters equal the JAX engine's, and
    the streams equal the port's plain ones."""
    (jm, tm), (jd, td) = lms, drafts
    kw = dict(LEGS[leg], spec_branch=branch, **SPEC)
    ours, stats, sched = serve(PORT, tm, PROMPTS, MAX_NEW, draft_model=td, **kw)
    ref, jstats, jsched = serve(JAX, jm, PROMPTS, MAX_NEW, draft_model=jd, decode_kernel="dense", **kw)
    assert ours == ref
    assert _counters(sched) == _counters(jsched)
    assert (stats.verify_steps, stats.draft_tokens_proposed, stats.draft_tokens_accepted) == (
        jstats.verify_steps, jstats.draft_tokens_proposed, jstats.draft_tokens_accepted)
    plain, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **LEGS[leg])
    assert ours == plain
    assert stats.verify_steps > 0 and sched.proposer.draft_tokens > 0


@pytest.mark.parametrize("branch", [1, 3])
def test_async_equals_sync_without_pre_proposals(lms, drafts, branch):
    """The async loop with the model draft gives the sync loop's streams,
    never pre-proposes for the stateful draft, and drafts as the JAX
    async loop does (the draft counters may differ from the sync loop's:
    the async loop admits before it commits the step in flight, so its
    batches differ)."""
    (jm, tm), (jd, td) = lms, drafts
    kw = dict(spec_branch=branch, **SPEC)
    sync, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, draft_model=td, **kw)
    asyn, stats, asched = serve(PORT, tm, PROMPTS, MAX_NEW, draft_model=td, serve_async=True, **kw)
    ref, _, jsched = serve(JAX, jm, PROMPTS, MAX_NEW, draft_model=jd, serve_async=True, decode_kernel="dense", **kw)
    assert asyn == sync == ref and _counters(asched) == _counters(jsched)
    assert stats.pre_proposal_hits == stats.pre_proposal_misses == 0


@pytest.mark.parametrize("leg", ["paged", "int8"])
def test_preemption_retires_and_reprefills_the_draft(lms, drafts, monkeypatch, leg):
    """Optimistic admission on eight pages with the model draft: each
    preemption retires the victim's draft slot and its re-admission
    prefills the draft with prompt + generated; streams, preemptions and
    the draft's counters equal the JAX engine's, every request finishes
    (a verify claims up to spec_k + 1 rows, so some request is preempted
    more often than the default bound of 3 allows) and the draft cache
    holds no slot at the end."""
    from flexflow_tpu_torch.serving import ModelDraftProposer

    (jm, tm), (jd, td) = lms, drafts
    admitted = []
    real = ModelDraftProposer.admit

    def spy(self, requests):
        admitted.extend((r.rid, len(r.generated)) for r in requests)
        return real(self, requests)

    monkeypatch.setattr(ModelDraftProposer, "admit", spy)
    pre = prompts(41, (3, 20, 9, 35, 1, 14, 27, 6))
    new = [10, 8, 12, 6, 9, 11, 7, 12]
    kw = dict(LEGS[leg], admission="optimistic", kv_pages=8, max_preemptions=10, **SPEC)
    ours, stats, sched = serve(PORT, tm, pre, new, draft_model=td, **kw)
    ref, jstats, jsched = serve(JAX, jm, pre, new, draft_model=jd, decode_kernel="dense", **kw)
    assert ours == ref and _counters(sched) == _counters(jsched)
    assert stats.preemptions == jstats.preemptions > 0
    assert all(status == "finished" for status, _, _ in ours.values())
    # a re-admission prefills the draft with what the request generated
    assert len(admitted) == len(pre) + stats.preemptions and any(n > 0 for _, n in admitted)
    assert sched.proposer.cache.num_free == SLOTS


def test_a_model_draft_needs_its_draft_model(lms, drafts):
    """Without a draft_model, spec_draft="model" raises the reference's
    ValueError; with one, FFModel.generate serves the plain streams."""
    tm = lms[1]
    with pytest.raises(ValueError, match="draft_model"):
        build_scheduler(tm, ServeConfig(spec_draft="model"))
    with pytest.raises(ValueError, match="draft_model"):
        tm.generate(PROMPTS, max_new_tokens=4, serve_config=ServeConfig(spec_draft="model", max_seq_len=64))
    cfg = dict(max_seqs=SLOTS, max_seq_len=64)
    plain = tm.generate(PROMPTS, max_new_tokens=6, serve_config=ServeConfig(**cfg))
    spec = tm.generate(PROMPTS, max_new_tokens=6, serve_config=ServeConfig(**cfg, **SPEC), draft_model=drafts[1])
    assert spec == plain
