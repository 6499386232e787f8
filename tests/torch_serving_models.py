"""Shared setup of the port's serving-feature tests (sampling, chunked
prefill, prefix cache, preemption): a tiny decoder LM built in both
packages with the same weights (carried across by guid through
flexflow_tpu_torch/runtime/interop.py), and a runner that serves the same
requests through either package's build_scheduler."""

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
from flexflow_tpu_torch.serving import Request, ServeConfig, build_scheduler

VOCAB = 64
MAX_LEN = 64
PAGE = 8
SLOTS = 4
ATOL = 1e-4  # logits: the port's serving tolerance against the JAX engine

LEGS = {
    "slot": dict(kv_layout="slot"),
    "paged": dict(kv_layout="paged"),
    "int8": dict(kv_layout="paged", kv_dtype="int8"),
}

PORT = (build_scheduler, ServeConfig, Request)
JAX = (jax_build_scheduler, JServeConfig, JRequest)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny model's steps are many small torch ops; where test
    processes share the cores, intra-op threads wait at each op's barrier
    for threads that are not running, so these modules run on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build_lms(vocab=VOCAB, hidden=64, ff_dim=128, layers=2, seed=0, mixed=False):
    """(jax model, port model): 4 heads, by default 2 layers, hidden 64
    and vocab 64, weights from `seed`; `mixed` compiles both with
    allow_mixed_precision."""
    arch = dict(vocab_size=vocab, hidden=hidden, num_heads=4, num_layers=layers, ff_dim=ff_dim)
    jm = JFFModel(JFFConfig(batch_size=2, seed=seed, allow_mixed_precision=mixed))
    tok = jm.create_tensor([2, MAX_LEN], dtype=JDataType.INT32, name="tokens")
    jax_build_decoder_lm(jm, tok, **arch)
    jm.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[],
        devices=jax.devices()[:1],
    )
    tm = FFModel(FFConfig(batch_size=2, seed=seed, allow_mixed_precision=mixed))
    tok = tm.create_tensor([2, MAX_LEN], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(tm, tok, **arch)
    tm.compile(device="cpu")
    host = jm.executor.export_host_params(jm.params)
    params_from_host(tm, {g: [np.asarray(w) for w in ws] for g, ws in host.items()})
    return jm, tm


def prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, VOCAB, size=n)] for n in lengths]


def serve(side, model, prompts, max_new, max_seq_len=MAX_LEN, budget_trace=None, loras=None, req_kw=None,
          draft_model=None, **kw):
    """Serve `prompts` (max_new tokens each) through one package's
    continuous scheduler, the port's with its cache invariants checked
    after every iteration. `budget_trace`, a list, takes each
    iteration's budget used. `loras` ({adapter_id: weights}) are loaded
    into the engine's adapter pool first; `req_kw[i]` are request i's
    further fields (adapter_id, priority_class); `draft_model` is the
    draft LM of spec_draft="model". Returns ({rid: (status, generated,
    preemptions)}, stats, scheduler)."""
    build, serve_cls, req_cls = side
    kw = dict(dict(max_seqs=SLOTS, max_seq_len=max_seq_len, kv_page_size=PAGE, debug_invariants=side is PORT), **kw)
    sched, engine, _ = build(model, serve_cls(**kw), **({"draft_model": draft_model} if draft_model else {}))
    for aid, weights in (loras or {}).items():
        engine.adapters.load(aid, weights)
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        sched.submit(req_cls(rid=i, prompt=list(p), max_new_tokens=n, **(req_kw[i] if req_kw else {})))
    while sched.work_pending():
        sched.step()
        if budget_trace is not None:
            budget_trace.append(sched.stats.budget_used)
    return {r.rid: (r.status, list(r.generated), r.preemptions) for r in sched.finished}, sched.stats, sched
