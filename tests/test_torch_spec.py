"""flexflow_tpu_torch speculative decoding and int8 KV pools against the
JAX package, on the CPU (the kernel wrappers take their plain versions
here): the token-tree ancestor matrix and mask (exact), the int8 pool
write `_quant_scatter` (scales at rtol 1e-6, bytes exact but for ±1 at
a rounding boundary), `truncate` / `_compact_rows` on both layouts and
both pool types (pools, scales and allocator state exact, invariants
after every call), the acceptance rules, DraftTree and the n-gram
proposer (exact), and end to end: the reference's tiny decoder LM
(hidden 32, 2 layers, 4 heads, vocab 50) with its weights carried
across serves the same prompts with linear and tree speculation on the
slot layout, fp32 pools and int8 pools, and the port's greedy streams
equal the JAX engine's under the same ServeConfig and the port's own
plain streams. int8 is held against the reference's int8 path, never
against fp32."""

import types

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
from flexflow_tpu.ops.attention import tree_allowed_mask as jax_tree_allowed_mask
from flexflow_tpu.ops.attention import tree_ancestor_matrix as jax_tree_ancestor_matrix
from flexflow_tpu.serving import ServeConfig as JServeConfig
from flexflow_tpu.serving import build_scheduler as jax_build_scheduler
from flexflow_tpu.serving import spec as jspec
from flexflow_tpu.serving.engine import GenerationEngine as JEngine
from flexflow_tpu.serving.kv_cache import KVCache as JKVCache
from flexflow_tpu.serving.kv_cache import KVCacheSpec as JSpec
from flexflow_tpu.serving.kv_cache import PagedKVCache as JPaged
from flexflow_tpu_torch import DataType, FFConfig, FFModel
from flexflow_tpu_torch.models import build_decoder_lm
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.runtime.interop import params_from_host
from flexflow_tpu_torch.serving import (
    DraftTree,
    KVCache,
    KVCacheSpec,
    NGramDraftProposer,
    PagedKVCache,
    Request,
    ServeConfig,
    accept_drafts,
    accept_tree,
    build_scheduler,
)
from flexflow_tpu_torch.serving import spec as tspec
from flexflow_tpu_torch.serving.engine import GenerationEngine, quant_plan

pytestmark = pytest.mark.serving

VOCAB = 50
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 3, 1, 2], [7], [11, 12]]


def _parents(rng, b, w):
    par = np.full((b, w), -1, dtype=np.int32)
    for j in range(1, w):
        par[:, j] = rng.integers(0, j, size=b)
    return par


# -- the tree mask ---------------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 2, 5, 13, 33, 64])
def test_tree_mask_matches_jax_exactly(w):
    rng = np.random.default_rng(w)
    par = _parents(rng, 4, w)
    lens = np.asarray([0, 3, 17, 40], dtype=np.int32)
    klen = 112
    anc = tattn.tree_ancestor_matrix(torch.from_numpy(par)).numpy()
    np.testing.assert_array_equal(anc, np.asarray(jax_tree_ancestor_matrix(jnp.asarray(par))))
    mask = tattn.tree_allowed_mask(torch.from_numpy(par), torch.from_numpy(lens), w, klen).numpy()
    ref = np.asarray(jax_tree_allowed_mask(jnp.asarray(par), jnp.asarray(lens), w, klen))
    np.testing.assert_array_equal(mask, ref)
    chain = np.tile(np.arange(-1, w - 1, dtype=np.int32), (4, 1))
    stair = np.arange(klen)[None, None, :] <= lens[:, None, None] + np.arange(w)[None, :, None]
    np.testing.assert_array_equal(
        tattn.tree_allowed_mask(torch.from_numpy(chain), torch.from_numpy(lens), w, klen).numpy(), stair
    )


# -- int8 pool writes ------------------------------------------------------------------


def test_quant_scatter_matches_jax():
    """Three batches into one int8 pool: fresh pages claimed from their
    first row, rows reusing a stored scale (and clipping past it), and a
    reallocated page re-deriving its stale scale. The JAX side also gets
    out-of-bounds rows, which it drops and the port never sees."""
    rng = np.random.default_rng(0)
    P, ps, h, d = 6, 4, 2, 16
    stub_spec = types.SimpleNamespace(page_size=ps, num_pages=P, num_heads=h, head_dim=d)
    stub = types.SimpleNamespace(cache=types.SimpleNamespace(spec=stub_spec))
    jpool, jscale = jnp.zeros((P, ps, h, d), jnp.int8), jnp.zeros((P, h), jnp.float32)
    tpool, tscale = torch.zeros(P, ps, h, d, dtype=torch.int8), torch.zeros(P, h)
    batches = [
        [0, 1, 2, 8, 9, 20],  # pages 0 and 2 claimed; page 5 row 0
        [3, 10, 11, 12],  # reuse page 0 and 2's scales, claim page 3
        [8, 21, 22],  # page 2 re-derived from its first row
    ]
    for i, dest in enumerate(batches):
        rows = (rng.standard_normal((len(dest), h, d)) * (1.0 + 3 * i)).astype(np.float32)
        jdest = np.asarray(dest + [P * ps + 1], dtype=np.int32)
        jrows = np.concatenate([rows, rows[:1]])
        jpool, jscale, jdeq = JEngine._quant_scatter(stub, jpool, jscale, jnp.asarray(jrows), jnp.asarray(jdest))
        parts = [torch.from_numpy(a) for a in quant_plan(np.asarray(dest), ps)]
        tdeq = GenerationEngine._quant_scatter(stub, tpool, tscale, torch.from_numpy(rows), *parts, round_trip=True)
        np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-6, atol=0)
        got, want = tpool.numpy().astype(np.int32), np.asarray(jpool).astype(np.int32)
        off = got != want
        if off.any():  # only ±1, and only at a rounding boundary
            assert np.abs(got - want).max() == 1
            s = tscale.numpy()[np.asarray(dest) // ps]
            x = rows / np.where(s > 0, s, 1.0)[:, :, None]
            frac = np.abs(np.abs(x) % 1.0 - 0.5)
            flat = got.reshape(-1, h, d)[dest] != want.reshape(-1, h, d)[dest]
            assert (frac[flat] < 1e-5).all()
        np.testing.assert_allclose(tdeq.numpy(), np.asarray(jdeq)[: len(dest)], rtol=1e-6, atol=1e-6)


# -- rollback ----------------------------------------------------------------------------


def _geo(**kw):
    return dict(dict(layer_guids=(100, 101), max_seqs=3, max_len=32, num_heads=2, head_dim=16,
                     buckets=(16, 32)), **kw)


def _fill(tcache, jcache, rng, quant):
    """The same random pools (and scales) in both caches."""
    for g in tcache.spec.layer_guids:
        for name in ("k", "v"):
            arr = getattr(tcache, name)[g]
            if quant:
                data = rng.integers(-127, 128, size=tuple(arr.shape)).astype(np.int8)
                scale = rng.uniform(0.01, 0.1, size=(arr.shape[0], arr.shape[2])).astype(np.float32)
                getattr(tcache, name + "_scale")[g].copy_(torch.from_numpy(scale))
                getattr(jcache, name + "_scale")[g] = jnp.asarray(scale)
            else:
                data = rng.standard_normal(tuple(arr.shape)).astype(np.float32)
            arr.copy_(torch.from_numpy(data))
            getattr(jcache, name)[g] = jnp.asarray(data)


def _same(tcache, jcache):
    for g in tcache.spec.layer_guids:
        for name in ("k", "v") + (("k_scale", "v_scale") if getattr(tcache, "quantized", False) else ()):
            np.testing.assert_array_equal(
                getattr(tcache, name)[g].numpy(), np.asarray(getattr(jcache, name)[g]), err_msg=name
            )
    np.testing.assert_array_equal(tcache.lengths, jcache.lengths)
    if tcache.paged:
        np.testing.assert_array_equal(tcache.block_tables, jcache.block_tables)
        assert tcache.num_free_pages == jcache.num_free_pages
        assert tcache._reserved == int(np.sum(jcache._reserved_h))
    tcache.check_invariants()
    jcache.check_invariants()


@pytest.mark.parametrize("layout", ["slot", "paged", "int8"])
def test_truncate_and_compaction_match_jax(layout):
    """A sequence of verify-style rollbacks (linear, tree paths with
    scattered rows, a page-initial destination, growth past the current
    length) on both caches: identical pools, scales, tables and reserve
    ledgers, and both caches' invariants after every call."""
    rng = np.random.default_rng(7)
    if layout == "slot":
        t = KVCache(KVCacheSpec(**_geo()), torch.float32, "cpu")
        j = JKVCache(JSpec(**_geo()), jnp.float32)
    else:
        kv = "int8" if layout == "int8" else "fp32"
        geo = _geo(page_size=4, num_pages=16, kv_dtype=kv)
        t = PagedKVCache(KVCacheSpec(**geo), torch.float32, "cpu")
        j = JPaged(JSpec(**geo), jnp.float32)
    _fill(t, j, rng, layout == "int8")
    for c in (t, j):
        assert c.alloc(5, 30) == 0 and c.alloc(2, 20) == 1
    _same(t, j)
    # (slot, current length, verify rows, new length, src_rows)
    steps = [
        (0, 5, 6, 7, None),  # linear: 1 accepted of 5 drafts
        (0, 7, 9, 10, [8, 10]),  # tree path: rows 8, 10 -> 8, 9
        (1, 2, 7, 6, [3, 5, 6]),  # dest 4 opens page 1 (a page-initial row)
        (0, 10, 7, 14, [11, 13, 15]),  # crosses into page 3
        (1, 6, 4, 6, [6]),  # in place: no device work
        (0, 14, 9, 15, [15]),
    ]
    for slot, cur, width, new_len, src in steps:
        for c in (t, j):
            c.truncate(slot, cur)
            if c.paged:
                for p in range(cur, cur + width):
                    c.ensure_position(slot, p)
            c.truncate(slot, new_len, src_rows=src)
        _same(t, j)
    for c in (t, j):
        c.free(0)
    _same(t, j)


# -- acceptance rules, trees, the n-gram proposer ---------------------------------------


def test_acceptance_rules_match_jax():
    rng = np.random.default_rng(3)
    for trial in range(40):
        logits = rng.standard_normal((9, 12)).astype(np.float32) * 3
        drafts = list(rng.integers(0, 12, size=int(rng.integers(0, 8))))
        greedy = np.argmax(logits, axis=-1)
        drafts[: trial % 4] = greedy[: min(trial % 4, len(drafts))]  # some accepts
        for temp in (0.0, 0.7):
            kw = dict(temperature=temp, seed=trial, slot=trial % 3, base_len=5 + trial)
            assert accept_drafts(logits, drafts, **kw) == jspec.accept_drafts(logits, drafts, **kw)
        chains = [list(rng.integers(0, 12, size=int(rng.integers(1, 4)))) for _ in range(3)]
        chains[0][:1] = greedy[:1]
        tree, jtree = DraftTree.from_chains(chains), jspec.DraftTree.from_chains(chains)
        assert (tree.tokens, tree.parents) == (jtree.tokens, jtree.parents)
        assert tree.depth() == jtree.depth() and tree.chains() == jtree.chains()
        assert tree.row_parents(tree.nodes + 3) == jtree.row_parents(tree.nodes + 3)
        for cap in ((2, None), (None, 1), (4, 2)):
            pt, pj = tree.prune(*cap), jtree.prune(*cap)
            assert (pt.tokens, pt.parents) == (pj.tokens, pj.parents)
        for temp in (0.0, 0.7):
            kw = dict(temperature=temp, seed=trial, slot=1, base_len=3)
            assert accept_tree(logits, tree, **kw) == jspec.accept_tree(logits, jtree, **kw)


def test_ngram_proposer_matches_jax():
    rng = np.random.default_rng(4)
    seqs = {s: list(rng.integers(0, 4, size=30)) for s in range(4)}
    seqs[4] = [1, 2]
    ours, ref = NGramDraftProposer(n=2), jspec.NGramDraftProposer(n=2)
    for k in (1, 3, 5):
        assert ours.propose_sequences(seqs, k) == ref.propose_sequences(seqs, k)
        for branch in (1, 3):
            a = ours.propose_tree_sequences(seqs, k, branch)
            b = ref.propose_tree_sequences(seqs, k, branch)
            assert {s: (t.tokens, t.parents) for s, t in a.items()} == {
                s: (t.tokens, t.parents) for s, t in b.items()
            }
    assert (ours.lookups, ours.lookup_hits) == (ref.lookups, ref.lookup_hits)
    assert tspec.DraftProposer.stateless is False and NGramDraftProposer.stateless


# -- end to end ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lms():
    """The reference's tiny decoder LM and the port's, same weights."""
    jm = JFFModel(JFFConfig(batch_size=4, seed=0))
    tok = jm.create_tensor([4, 32], dtype=JDataType.INT32, name="tokens")
    jax_build_decoder_lm(jm, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=2, ff_dim=64)
    jm.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[],
        devices=jax.devices()[:1],
    )
    tm = FFModel(FFConfig(batch_size=4, seed=0))
    tok = tm.create_tensor([4, 32], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(tm, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=2, ff_dim=64)
    tm.compile(device="cpu")
    host = jm.executor.export_host_params(jm.params)
    params_from_host(tm, {g: [np.asarray(w) for w in ws] for g, ws in host.items()})
    return jm, tm


_LEGS = {
    "slot": dict(kv_layout="slot"),
    "paged": dict(kv_layout="paged"),
    "int8": dict(kv_layout="paged", kv_dtype="int8"),
}


@pytest.mark.parametrize("branch", [1, 2])
@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_spec_streams_match_jax_engine(lms, leg, branch):
    """Greedy speculative streams (linear for branch 1, token trees for
    branch 2) equal the JAX engine's under the same ServeConfig and the
    port's own plain streams, with the same verify and acceptance
    counts; the allocator's invariants hold after every iteration."""
    jm, tm = lms
    kw = dict(max_seqs=2, max_seq_len=32, spec_draft="ngram", spec_k=3, spec_branch=branch, **_LEGS[leg])
    ref = jm.generate(PROMPTS, max_new_tokens=8, serve_config=JServeConfig(**kw))
    ours = tm.generate(PROMPTS, max_new_tokens=8, serve_config=ServeConfig(debug_invariants=True, **kw))
    assert ours == ref
    plain = tm.generate(PROMPTS, max_new_tokens=8, serve_config=ServeConfig(max_seqs=2, max_seq_len=32, **_LEGS[leg]))
    assert ours == plain
    sched, _, _ = build_scheduler(tm, ServeConfig(**kw))
    sched.run([Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(PROMPTS)])
    s = sched.stats
    assert s.verify_steps > 0 and s.decode_steps == 0 and s.draft_faults == 0
    assert s.tree_verify_steps == (s.verify_steps if branch > 1 else 0)
    assert 0.0 <= s.acceptance_rate <= 1.0 and s.draft_tokens_accepted > 0


def test_verify_logits_match_jax_engine(lms):
    """One tree verify step on each layout: the port's logits against
    the JAX engine's on the same cache contents (atol 1e-4), and lengths
    unmoved."""
    jm, tm = lms
    rng = np.random.default_rng(9)
    for leg in sorted(_LEGS):
        kw = dict(max_seqs=2, max_seq_len=32, **_LEGS[leg])
        _, jeng, jcache = jax_build_scheduler(jm, JServeConfig(**kw))
        _, teng, tcache = build_scheduler(tm, ServeConfig(**kw))
        prompts = [[3, 1, 4, 1, 5], [9, 2]]
        for c in (jcache, tcache):
            assert [c.alloc(len(p), 30) for p in prompts] == [0, 1]
        jeng.prefill(jm.params, prompts, [0, 1])
        teng.prefill(tm.params, prompts, [0, 1])
        w = 7
        tokens = rng.integers(0, VOCAB, size=(2, w)).astype(np.int32)
        parents = _parents(rng, 2, w)
        draft_lens = np.asarray([w, 4], dtype=np.int32)
        ref = np.asarray(jeng.verify_tree(jm.params, tokens, draft_lens, parents))
        got = teng.verify_tree(tm.params, tokens, draft_lens, parents)
        np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
        np.testing.assert_allclose(got[1, :4], ref[1, :4], atol=1e-4)
        np.testing.assert_array_equal(tcache.lengths, [5, 2])
        lin_ref = np.asarray(jeng.verify(jm.params, tokens[:, :4], np.asarray([4, 2], np.int32)))
        lin = teng.verify(tm.params, tokens[:, :4], np.asarray([4, 2], np.int32))
        np.testing.assert_allclose(lin[0], lin_ref[0], atol=1e-4)
        np.testing.assert_allclose(lin[1, :2], lin_ref[1, :2], atol=1e-4)
