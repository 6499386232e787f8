"""flexflow_tpu_torch's multi-tenant serving (serving/tenancy/: the paged
multi-LoRA AdapterPool, lora_delta_qkv / lora_delta_out, the deficit
round-robin and priority classes; the scheduler's DRR admission, DRR
chunk grants and class-priced victims) against the JAX package, on the
CPU, on the shared tiny LM of tests/torch_serving_models.py.

Tolerances: the LoRA deltas within 1e-5 of the reference's on the same
seeded inputs; make_lora_weights, the pool's ledgers and device pools,
the DRR's selections and deficits and parse_classes exact; streams,
admission orders, chunk plans and victims equal the JAX scheduler's;
engine logits within the shared ATOL (1e-4) of the JAX engine's on the
slot layout, fp32 and int8 pools. An adapter must change a row's first
logits by more than 1e-3: a greedy token stream of this tiny LM is no
proof that an adapter bites (its rank-4 0.1-scaled factors may leave
every argmax where it was)."""

import numpy as np
import pytest
import torch

from flexflow_tpu.serving.tenancy import adapters as jad
from flexflow_tpu.serving.tenancy import fairness as jfair
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.serving.tenancy import adapters as tad
from flexflow_tpu_torch.serving.tenancy import fairness as tfair
from torch_serving_models import ATOL, JAX, LEGS, PORT, SLOTS, build_lms, one_torch_thread, prompts, serve  # noqa: F401 (autouse)

import jax.numpy as jnp

pytestmark = pytest.mark.serving

RANK = 8
TENANCY = dict(adapters=2, adapter_rank=RANK)
CLASSES = "gold:4,bronze:1"


@pytest.fixture(scope="module")
def lms():
    return build_lms()


@pytest.fixture(scope="module")
def loras(lms):
    """Adapters 0 and 1 (rank 8, seeds 0 and 1), as both pools take them."""
    pool = tad.AdapterPool.from_model(lms[1], max_seqs=SLOTS, max_adapters=2, max_rank=RANK)
    return {aid: tad.make_lora_weights(pool.spec, RANK, seed=aid) for aid in (0, 1)}


# -- the deltas and the weights --------------------------------------------------------


@pytest.mark.parametrize("page_rank", [1, 4])
def test_lora_deltas_match_jax(lms, page_rank):
    """The pool's step gather and lora_delta_qkv / lora_delta_out, on
    seeded pools (factors scaled by 0.1, as make_lora_weights draws
    them) and page tables (sentinel entries and a base-model row
    included), equal the reference's lora_delta_qkv / lora_delta_out on
    the same pools within 1e-5, layer by layer."""
    tm = lms[1]
    rng = np.random.default_rng(page_rank)
    pool = tad.AdapterPool.from_model(tm, max_seqs=SLOTS, max_adapters=2, max_rank=8, page_rank=page_rank,
                                      num_pages=6 * 8 // page_rank)
    NP, P = pool.spec.num_pages, pool.spec.pages_per_adapter
    for views in pool.device_pools.values():
        for k, t in views.items():
            t[:NP] = torch.from_numpy((rng.standard_normal(t[:NP].shape) * 0.1).astype(np.float32))
    b, s = 3, 5
    e, h, d = pool.spec.embed_dim, pool.spec.num_heads, pool.spec.head_dim
    tbl = rng.integers(0, NP + 1, (b, P)).astype(np.int32)
    tbl[0] = NP  # a base-model row: the sentinel throughout
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    attn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    gat = pool.gather(torch.from_numpy(tbl), torch.ones(b, dtype=torch.bool))
    for g, views in pool.device_pools.items():
        i = gat.layer[g]
        p = {k: jnp.asarray(v.numpy()) for k, v in views.items()}
        ours = tattn.lora_delta_qkv(torch.from_numpy(x), gat.a_qkv[i], gat.b_qkv[i])
        ref = jattn.lora_delta_qkv(jnp.asarray(x), jnp.asarray(tbl), p["a_q"], p["b_q"], p["a_k"], p["b_k"],
                                   p["a_v"], p["b_v"])
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy().reshape(b, s, h, d), np.asarray(r), atol=1e-5, rtol=0)
            assert float(o[0].abs().max()) == 0.0
        out = tattn.lora_delta_out(torch.from_numpy(attn), gat.a_o[i], gat.b_o[i])
        ref = jattn.lora_delta_out(jnp.asarray(attn), jnp.asarray(tbl), p["a_o"], p["b_o"])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_make_lora_weights_is_the_reference_bit_for_bit(lms):
    jm, tm = lms
    ours = tad.AdapterPool.from_model(tm, max_seqs=SLOTS, max_adapters=3, max_rank=6)
    ref = jad.AdapterPool.from_model(jm, max_seqs=SLOTS, max_adapters=3, max_rank=6)
    assert ours.spec.layer_guids == ref.spec.layer_guids
    for rank, seed in ((6, 0), (3, 11)):
        a, b = tad.make_lora_weights(ours.spec, rank, seed), jad.make_lora_weights(ref.spec, rank, seed)
        assert a.keys() == b.keys()
        for g in a:
            for k in a[g]:
                assert a[g][k].dtype == b[g][k].dtype and np.array_equal(a[g][k], b[g][k])


# -- the pool's ledgers ------------------------------------------------------------------


def _ledgers(pool):
    pools = {g: {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in p.items()}
             for g, p in pool.device_pools.items()}
    return (pool.adapter_tables.copy(), pool._adapter_refcounts.copy(), list(pool._free_adapter_pages),
            pool.slot_adapter.copy(), pool.loaded, pools, pool.slot_tables(), pool.row_tables([2, 0, 3], 5),
            pool.telemetry_gauges(), pool.telemetry_counters())


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def test_pool_ledgers_match_jax(lms):
    """The same load / attach / detach / unload sequence (mixed ranks, a
    page heap too small for every adapter, refusals and exhaustion
    included) leaves the port's tables, refcounts, free heap, slot map,
    counters and device pools equal to the JAX pool's after every call,
    and every refusal raises the reference's error."""
    jm, tm = lms
    kw = dict(max_seqs=SLOTS, max_adapters=4, max_rank=8, num_pages=5)
    pools = (tad.AdapterPool.from_model(tm, **kw), jad.AdapterPool.from_model(jm, **kw))
    w = {aid: tad.make_lora_weights(pools[0].spec, rank, seed=aid) for aid, rank in ((0, 8), (1, 3), (2, 5), (3, 2))}
    ops = [("load", 0), ("load", 1), ("attach", 0, 0), ("attach", 1, 1), ("attach", 3, 0),
           ("load", 2),  # 2 of 5 pages free, rank 5 needs 2: fits
           ("load", 3),  # the pool is dry
           ("unload", 0),  # attached
           ("attach", 0, 1),  # slot 0 is attached
           ("attach", 2, 3),  # not loaded
           ("unload", 3),  # not loaded
           ("detach", 0), ("detach", 0), ("detach", 3), ("unload", 0), ("load", 3),
           ("attach", 2, -1), ("attach", 2, 3), ("load", 1), ("detach", 1), ("detach", 2), ("unload", 1)]
    for op in ops:
        outcomes = []
        for pool in pools:
            try:
                if op[0] == "load":
                    pool.load(op[1], w[op[1]], scale=0.5 if op[1] == 2 else 1.0)
                else:
                    getattr(pool, op[0])(*op[1:])
                outcomes.append(None)
            except Exception as e:  # noqa: BLE001 (the error is the outcome)
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1], op
        assert _same(_ledgers(pools[0]), _ledgers(pools[1])), op
        pools[0].check_invariants()
    assert (pools[0].loads, pools[0].unloads) == (4, 2)


# -- the deficit round-robin -------------------------------------------------------------


def test_drr_sequences_match_jax():
    """Seeded select / charge / settle sequences over three classes and
    mixed costs: every selection and every deficit equals the
    reference's, and the invariants hold throughout."""
    rng = np.random.default_rng(7)
    weights = {"gold": 4.0, "silver": 2.5, "bronze": 1.0}
    for unit in (1.0, 16.0):
        ours, ref = tfair.DeficitRoundRobin(weights, unit), jfair.DeficitRoundRobin(weights, unit)
        for _ in range(300):
            names = [n for n in weights if rng.random() < 0.7]
            if rng.random() < 0.2:
                ours.settle(names)
                ref.settle(names)
                continue
            costs = {n: float(rng.integers(1, 17)) for n in names}
            pick = ours.select(costs)
            assert pick == ref.select(costs)
            if pick is not None:
                ours.charge(pick[0], pick[1], list(costs), cost=costs[pick[0]])
                ref.charge(pick[0], pick[1], list(costs), cost=costs[pick[0]])
            assert ours.deficit == ref.deficit and ours._cursor == ref._cursor
            ours.check_invariants(max_cost=16.0)


@pytest.mark.parametrize("spec", [
    "gold:4:200:50,bronze:1", "gold:4,bronze:1", "a", " a : 3 ,b", "a:2:,b:1::7", "x:0.5,y:1.5,z:2",
    "a:1:2:3:4", "a,a", "a:x", "", ",", ":1", "a:0", "a:-1", "a:1:-5", "a:1:1:-1",
])
def test_parse_classes_matches_jax(spec):
    """The grammar name:weight[:ttft_ms[:itl_ms]]: the same classes, or
    the same ValueError."""
    def parse(mod):
        try:
            return {n: (c.name, c.weight, c.slo_ttft_ms, c.slo_itl_ms) for n, c in mod.parse_classes(spec).items()}
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(tfair) == parse(jfair)


# -- the engine: identity, isolation, parity ---------------------------------------------

IDENTITY = {
    "slot": dict(kv_layout="slot"),
    "paged": {},
    "int8": dict(kv_dtype="int8"),
    "async": dict(serve_async=True),
    "ngram_spec": dict(spec_draft="ngram", spec_k=3),
    "chunked": dict(token_budget=32, chunk_size=8),
    "multistep": dict(decode_multistep=True, max_fused_steps=4),
}
ID_PROMPTS = prompts(31, (3, 12, 1, 7, 20, 5))
ID_NEW = [6, 9, 4, 8, 5, 7]


@pytest.fixture(scope="module")
def mixed_lms():
    return build_lms(mixed=True)


@pytest.mark.parametrize("leg", sorted(IDENTITY) + ["mixed_precision"])
def test_pool_with_base_requests_is_identity(lms, mixed_lms, loras, monkeypatch, leg):
    """An engine carrying a pool with two loaded adapters, serving only
    adapter_id -1, gives exactly the streams of an engine with no pool,
    over the slot layout, fp32 and int8 pools, the async loop, n-gram
    speculation, chunked prefill, multi-step windows and a model under
    mixed precision; without a pool no LoRA delta is computed at all."""
    model = mixed_lms[1] if leg == "mixed_precision" else lms[1]
    kw = IDENTITY.get(leg, {})
    pooled, _, _ = serve(PORT, model, ID_PROMPTS, ID_NEW, loras=loras, **TENANCY, **kw)

    def no_delta(*a, **k):
        raise AssertionError("a LoRA delta ran without an adapter pool")

    monkeypatch.setattr(tad, "lora_delta_qkv", no_delta)
    monkeypatch.setattr(tad, "lora_delta_out", no_delta)
    base, _, _ = serve(PORT, model, ID_PROMPTS, ID_NEW, **kw)
    assert pooled == base
    assert all(status == "finished" for status, _, _ in base.values())


MIX_PROMPT = [7, 3, 5, 9, 2]
MIX_KW = [dict(adapter_id=0), dict(adapter_id=1), dict(adapter_id=-1)]


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_mixed_adapters_match_isolated_runs_and_jax(lms, loras, leg):
    """Adapters 0, 1 and none in one batch (one prompt for all three):
    each stream equals its isolated run and the JAX scheduler's stream;
    the base row equals a pool-free engine's."""
    jm, tm = lms
    kw = dict(LEGS[leg], **TENANCY)
    n = len(MIX_KW)
    ours, _, _ = serve(PORT, tm, [MIX_PROMPT] * n, [8] * n, loras=loras, req_kw=MIX_KW, **kw)
    ref, _, _ = serve(JAX, jm, [MIX_PROMPT] * n, [8] * n, loras=loras, req_kw=MIX_KW, decode_kernel="dense", **kw)
    assert ours == ref
    for i, rk in enumerate(MIX_KW):
        alone, _, _ = serve(PORT, tm, [MIX_PROMPT], [8], loras=loras, req_kw=[rk], **kw)
        assert alone[0][1] == ours[i][1]
    base, _, _ = serve(PORT, tm, [MIX_PROMPT], [8], **LEGS[leg])
    assert base[0][1] == ours[2][1]


def _engine_logits(side, model, loras, leg, steps=3):
    """Prefill MIX_PROMPT into three slots attached to adapters 0, 1 and
    none, then `steps` greedy decode steps: each step's logits [3, V] as
    float32 on the host."""
    build, serve_cls, _ = side
    _, eng, cache = build(model, serve_cls(max_seqs=SLOTS, max_seq_len=32, kv_page_size=8, **LEGS[leg], **TENANCY))
    for aid, w in loras.items():
        eng.adapters.load(aid, w)
    slots = [cache.alloc(len(MIX_PROMPT), 32) for _ in MIX_KW]
    for s, rk in zip(slots, MIX_KW):
        eng.adapters.attach(s, rk["adapter_id"])
    as_np = lambda t: t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))
    nxt, last = eng.prefill(model.params, [MIX_PROMPT] * len(slots), slots)
    out = [as_np(last)]
    tokens = np.zeros(SLOTS, dtype=np.int32)
    active = np.zeros(SLOTS, dtype=bool)
    tokens[slots], active[slots] = np.asarray(nxt), True
    for _ in range(steps):
        nxt, logits = eng.decode(model.params, tokens, active)
        out.append(as_np(logits)[slots])
        tokens[slots] = np.asarray(nxt)[slots]
    return out


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_adapter_logits_match_jax_and_bite(lms, loras, leg):
    """Prefill and decode logits of rows on adapters 0, 1 and none are
    within ATOL of the JAX engine's, and each adapter moves its row's
    first logits by more than 1e-3 from the base row's."""
    jm, tm = lms
    ours, ref = _engine_logits(PORT, tm, loras, leg), _engine_logits(JAX, jm, loras, leg)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    first = ours[0]
    for row in (0, 1):
        assert float(np.abs(first[row] - first[2]).max()) > 1e-3
    assert float(np.abs(first[0] - first[1]).max()) > 1e-3


def test_mixed_precision_adapter_streams_match_jax(mixed_lms, loras):
    """A model under allow_mixed_precision (bf16 projections, the delta
    added in float32 and cast back) serves adapters 0, 1 and none in one
    batch with the JAX mixed engine's streams."""
    jm, tm = mixed_lms
    n = len(MIX_KW)
    ours, _, _ = serve(PORT, tm, [MIX_PROMPT] * n, [8] * n, loras=loras, req_kw=MIX_KW, **TENANCY)
    ref, _, _ = serve(JAX, jm, [MIX_PROMPT] * n, [8] * n, loras=loras, req_kw=MIX_KW, decode_kernel="dense",
                      **TENANCY)
    assert ours == ref


# -- weighted-fair scheduling ------------------------------------------------------------

FAIR_PROMPTS = prompts(61, (30, 9, 44, 3, 17, 25, 2, 38, 12, 6))
FAIR_NEW = [6, 9, 5, 10, 8, 7, 9, 4, 6, 8]
FAIR_KW = [dict(priority_class="gold" if i % 2 else "bronze", adapter_id=(-1, 0, 1)[i % 3])
           for i in range(len(FAIR_PROMPTS))]


def _spy(monkeypatch, cls, name, log):
    real = getattr(cls, name)

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        log.append(dict(out) if isinstance(out, dict) else [r.rid for r in out])
        return out

    monkeypatch.setattr(cls, name, spy)


@pytest.mark.parametrize("leg", ["paged", "slot"])
def test_drr_admission_and_chunk_grants_match_jax(lms, loras, monkeypatch, leg):
    """classes="gold:4,bronze:1" with chunked prefill and adapters: every
    iteration's admissions and chunk plan, the budget each iteration
    used, and the streams equal the JAX scheduler's; every request
    finishes; the streams equal a single-class run's (fairness moves
    when work is granted, never what is computed)."""
    from flexflow_tpu.serving.scheduler import _SchedulerBase as JBase
    from flexflow_tpu_torch.serving.scheduler import _SchedulerBase

    jm, tm = lms
    kw = dict(LEGS[leg], classes=CLASSES, token_budget=32, chunk_size=8, **TENANCY)
    logs = {}
    for side, model, base in ((PORT, tm, _SchedulerBase), (JAX, jm, JBase)):
        logs[side] = dict(admit=[], plan=[], budget=[])
        _spy(monkeypatch, base, "_admit", logs[side]["admit"])
        _spy(monkeypatch, base, "_plan_chunks", logs[side]["plan"])
        out = serve(side, model, FAIR_PROMPTS, FAIR_NEW, loras=loras, req_kw=FAIR_KW,
                    budget_trace=logs[side]["budget"], **kw)
        logs[side]["streams"] = out[0]
        monkeypatch.undo()
    assert logs[PORT] == logs[JAX]
    assert all(status == "finished" for status, _, _ in logs[PORT]["streams"].values())
    # bronze requests wait behind gold ones: the order is not FIFO
    order = [rid for batch in logs[PORT]["admit"] for rid in batch]
    assert order != sorted(order)
    fifo, _, _ = serve(PORT, tm, FAIR_PROMPTS, FAIR_NEW, loras=loras,
                       req_kw=[dict(adapter_id=k["adapter_id"]) for k in FAIR_KW],
                       **dict(kw, classes=""))
    assert fifo == logs[PORT]["streams"]


# test_torch_preemption.py's traffic: eight pages preempt three times
VICTIM_PROMPTS = prompts(41, (3, 20, 9, 35, 1, 14, 27, 6))
VICTIM_NEW = [10, 8, 12, 6, 9, 11, 7, 12]


def _victims(monkeypatch, scheduler_cls):
    """Record the rid of every preemption victim of `scheduler_cls`."""
    seen = []
    real = scheduler_cls._preempt

    def spy(self, req, *a, **kw):
        seen.append(req.rid)
        return real(self, req, *a, **kw)

    monkeypatch.setattr(scheduler_cls, "_preempt", spy)
    return seen


@pytest.mark.parametrize("leg", ["paged", "int8"])
def test_class_priced_victims_match_jax(lms, loras, monkeypatch, leg):
    """Optimistic admission on a pool too small for the requests' worst
    cases under classes="gold:4,bronze:1": the same victims in the same
    order, preemption counts and streams as the JAX scheduler pricing
    victims by resident tokens (its cost-model pricer replaced by None,
    as the port has no cost model yet)."""
    import flexflow_tpu.serving.api as japi
    from flexflow_tpu.serving.scheduler import _SchedulerBase as JBase
    from flexflow_tpu_torch.serving.scheduler import _SchedulerBase

    jm, tm = lms
    monkeypatch.setattr(japi, "build_victim_pricer", lambda model: None)
    kw = dict(LEGS[leg], classes=CLASSES, admission="optimistic", kv_pages=8, **TENANCY)
    req_kw = FAIR_KW[: len(VICTIM_PROMPTS)]
    ours_v, ref_v = _victims(monkeypatch, _SchedulerBase), _victims(monkeypatch, JBase)
    ours, stats, _ = serve(PORT, tm, VICTIM_PROMPTS, VICTIM_NEW, loras=loras, req_kw=req_kw, **kw)
    ref, jstats, _ = serve(JAX, jm, VICTIM_PROMPTS, VICTIM_NEW, loras=loras, req_kw=req_kw, decode_kernel="dense",
                           **kw)
    assert ours == ref
    assert ours_v == ref_v and stats.preemptions == jstats.preemptions == len(ours_v) > 0
    assert all(status == "finished" for status, _, _ in ours.values())
    # one class: youngest-first victims, another choice on this traffic
    del ours_v[:]
    serve(PORT, tm, VICTIM_PROMPTS, VICTIM_NEW, loras=loras, req_kw=[dict(adapter_id=k["adapter_id"]) for k in req_kw],
          **dict(kw, classes="gold:4"))
    assert ours_v and ours_v != ref_v


def test_victim_ties_break_youngest_first(lms):
    """Equal class-priced costs fall back to youngest first by
    (admit_iter, rid); a heavier class breaks the tie on price."""
    from flexflow_tpu_torch.serving import PriorityClass, Request, RequestStatus, ServeConfig, build_scheduler

    sched, _, _ = build_scheduler(lms[1], ServeConfig(max_seqs=4, max_seq_len=32, classes="gold:2,bronze:2"))
    reqs = [Request(rid=i, prompt=[2, 3, 5], max_new_tokens=4, priority_class="gold" if i % 2 else "bronze")
            for i in range(4)]
    for i, r in enumerate(reqs):
        r.slot, r.status, r.admit_iter = i, RequestStatus.RUNNING, i // 2
        sched.running[i] = r
    assert len({sched._victim_cost(r) for r in reqs}) == 1
    assert sched._pick_victim().rid == 3
    del sched.running[3]
    assert sched._pick_victim().rid == 2
    sched.classes["gold"] = PriorityClass("gold", 8.0)
    assert sched._pick_victim().rid == 2


def test_requests_naming_an_unknown_class_or_adapter_fail(lms, loras):
    """An unknown class, an adapter that is not loaded and an adapter_id
    without a pool raise the reference's ValueError under strict submit
    and fail only that request otherwise."""
    from flexflow_tpu_torch.serving import Request, ServeConfig, build_scheduler

    tm = lms[1]
    sched, eng, _ = build_scheduler(tm, ServeConfig(max_seqs=2, max_seq_len=32, classes=CLASSES, **TENANCY))
    eng.adapters.load(0, loras[0])
    for rk, match in ((dict(priority_class="platinum"), "unknown priority class"),
                      (dict(adapter_id=1), "adapter 1 is not loaded")):
        with pytest.raises(ValueError, match=match):
            sched.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2, **rk))
    assert not sched.submit(Request(rid=1, prompt=[1, 2], max_new_tokens=2, adapter_id=1), strict=False)
    assert sched.submit(Request(rid=2, prompt=[1, 2], max_new_tokens=3, adapter_id=0, priority_class="bronze"))
    done = {r.rid: r for r in sched.run()}
    assert done[1].status == "failed" and done[2].ok and len(done[2].generated) == 3
    bare, _, _ = build_scheduler(tm, ServeConfig(max_seqs=2, max_seq_len=32))
    with pytest.raises(ValueError, match="no adapter pool"):
        bare.submit(Request(rid=0, prompt=[1], max_new_tokens=1, adapter_id=0))
