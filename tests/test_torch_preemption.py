"""flexflow_tpu_torch's optimistic admission with preemption by recompute
(`ServeConfig(admission="optimistic", max_preemptions)`: PagedKVCache's
optimistic slots, scheduler._secure_pages / _pick_victim / _preempt and
the re-admission of prompt + generated) against the JAX scheduler, under
a page pool too small for every request's worst case, on fp32 and int8
pools, monolithic and chunked, greedy and sampled. Every run checks the
allocator's invariants after each iteration. Tolerance: tokens exact;
preemption counts, victims and statuses equal the JAX scheduler's."""

import pytest

from flexflow_tpu_torch.serving import ServeConfig
from torch_serving_models import JAX, PORT, build_lms, one_torch_thread, prompts, serve  # noqa: F401 (autouse)

pytestmark = pytest.mark.serving

PROMPTS = prompts(41, (3, 20, 9, 35, 1, 14, 27, 6))
MAX_NEW = [10, 8, 12, 6, 9, 11, 7, 12]
TIGHT = dict(kv_pages=8)  # 64 rows: one max_len sequence, far below the requests' worst cases
LEGS = {"paged": {}, "int8": dict(kv_dtype="int8")}


@pytest.fixture(scope="module")
def lms():
    return build_lms()


def _victims(monkeypatch, scheduler_cls):
    """Record the rid of every preemption victim of `scheduler_cls`."""
    seen = []
    real = scheduler_cls._preempt

    def spy(self, req, *a, **kw):
        seen.append(req.rid)
        return real(self, req, *a, **kw)

    monkeypatch.setattr(scheduler_cls, "_preempt", spy)
    return seen


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_optimistic_streams_and_victims_match_jax(lms, monkeypatch, leg, chunked):
    """The same victims in the same order, the same per-request
    preemption counts and the same streams as the JAX scheduler; every
    request finishes, and greedy streams equal a roomy pool's."""
    from flexflow_tpu.serving.scheduler import _SchedulerBase as JBase
    from flexflow_tpu_torch.serving.scheduler import _SchedulerBase

    jm, tm = lms
    # chunk streaming keeps more requests in flight on the small pool, so
    # some are preempted more often than the default bound allows
    kw = dict(LEGS[leg], admission="optimistic", **TIGHT,
              **(dict(token_budget=32, chunk_size=8, max_preemptions=10) if chunked else {}))
    ours_v, ref_v = _victims(monkeypatch, _SchedulerBase), _victims(monkeypatch, JBase)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **kw)
    assert ours == ref
    assert ours_v == ref_v and stats.preemptions == jstats.preemptions == len(ours_v) > 0
    assert all(status == "finished" for status, _, _ in ours.values())
    roomy, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **LEGS[leg])
    assert {r: s[1] for r, s in ours.items()} == {r: s[1] for r, s in roomy.items()}


def test_optimistic_sampled_streams_match_jax_pallas(lms):
    """Sampled at temperature 0.8, against the JAX scheduler running its
    Pallas kernels in the interpreter: a recomputed request samples its
    next token at the reference's position."""
    jm, tm = lms
    kw = dict(admission="optimistic", temperature=0.8, seed=4, **TIGHT)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="pallas", **kw)
    assert ours == ref and stats.preemptions == jstats.preemptions > 0


def test_reserve_admission_on_the_same_pool_never_preempts(lms):
    """The reserve policy on the same pool admits fewer requests at once
    and preempts none; its greedy streams equal the optimistic run's."""
    jm, tm = lms
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **TIGHT)
    opt, ostats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, admission="optimistic", **TIGHT)
    ref, _, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **TIGHT)
    assert ours == ref
    assert stats.preemptions == 0 < ostats.preemptions
    assert stats.peak_in_flight < ostats.peak_in_flight
    assert {r: s[1] for r, s in ours.items()} == {r: s[1] for r, s in opt.items()}


def test_preemption_bound_fails_with_its_cause(lms):
    """max_preemptions 0: a victim fails at its first preemption, naming
    the bound and the cause, exactly where the JAX scheduler's does; the
    rest finish."""
    jm, tm = lms
    kw = dict(admission="optimistic", max_preemptions=0, **TIGHT)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, _, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **kw)
    assert ours == ref
    failed = [r for r, (status, _, _) in ours.items() if status == "failed"]
    assert failed and stats.failed_requests == len(failed)
    from flexflow_tpu_torch.serving import Request, build_scheduler

    sched, _, _ = build_scheduler(tm, ServeConfig(max_seqs=4, max_seq_len=64, kv_page_size=8, **kw))
    done = sched.run([Request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))])
    errors = {r.error for r in done if r.status == "failed"}
    assert errors == {"preempted 1 times (max_preemptions 0; last cause=pool)"}


def test_optimistic_admission_holds_fused_windows(lms):
    """decode_multistep under optimistic admission never opens a window
    (a preemption must not meet one): the streams equal the eager run's."""
    _, tm = lms
    kw = dict(admission="optimistic", **TIGHT)
    fused, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, decode_multistep=True, **kw)
    eager, _, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    assert fused == eager and stats.multistep_windows == 0


def test_speculation_under_preemption_matches_jax(lms):
    """Linear n-gram speculation under optimistic admission: the proposer
    retires a preempted request; streams and counts equal the JAX
    scheduler's."""
    jm, tm = lms
    kw = dict(admission="optimistic", spec_draft="ngram", spec_k=3, **TIGHT)
    ours, stats, _ = serve(PORT, tm, PROMPTS, MAX_NEW, **kw)
    ref, jstats, _ = serve(JAX, jm, PROMPTS, MAX_NEW, decode_kernel="dense", **kw)
    assert ours == ref
    assert (stats.preemptions, stats.verify_steps) == (jstats.preemptions, jstats.verify_steps)


def test_kv_swap_raises_naming_its_item():
    """Swap-to-host needs the cost model's swap decider: not ported, so
    preemption under optimistic admission recomputes."""
    with pytest.raises(NotImplementedError, match="ROADMAP.*swap-to-host"):
        ServeConfig(admission="optimistic", max_preemptions=2, kv_swap=True)
