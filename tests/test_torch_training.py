"""flexflow_tpu_torch training against the JAX package, on the CPU (where
the flash kernel wrappers take their plain versions): losses, metrics,
optimizers and the data loader on the same numpy inputs; then the slice
as a whole — a tiny flagship Transformer encoder and a tiny decoder LM
with carried weights take the same train steps as the JAX executor, and
compute_gradients, evaluate and fit agree. Tolerances: 1e-6 absolute for
the elementwise pieces, and for whole steps loss 1e-5 relative and
params 1e-5 absolute (fp32 through a few layers, summed in another
order)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.core.types import LossType as JLoss
from flexflow_tpu.core.types import MetricsType as JMetrics
from flexflow_tpu.models import build_decoder_lm as jax_build_decoder_lm
from flexflow_tpu.models.nlp import build_transformer_encoder as jax_build_encoder
from flexflow_tpu.runtime.dataloader import SingleDataLoader as JLoader
from flexflow_tpu.runtime.dataloader import synthetic_dataset as jax_synthetic
from flexflow_tpu.runtime.loss import compute_loss as jax_loss
from flexflow_tpu.runtime.metrics import compute_metrics as jax_metrics
from flexflow_tpu_torch import AdamOptimizer, DataType, FFConfig, FFModel, LossType, MetricsType, SGDOptimizer
from flexflow_tpu_torch.models import build_decoder_lm, build_transformer_encoder
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk
from flexflow_tpu_torch.runtime import model as model_mod
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader, synthetic_dataset
from flexflow_tpu_torch.runtime.interop import opt_state_from_host, params_from_host
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import PerfMetrics, compute_metrics

ATOL = 1e-6
STEP_RTOL = STEP_ATOL = 1e-5
B, S, HID, HEADS, LAYERS = 2, 16, 32, 4, 2
VOCAB = 64


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- losses and metrics ------------------------------------------------------------


def _logits_and_labels(kind, rng):
    logits = rng.standard_normal((4, 3, 5)).astype(np.float32)
    if kind == "sparse":
        return logits, rng.integers(0, 5, (4, 3)).astype(np.int32)
    if kind == "sparse_col":  # the reference's [batch, 1] label layout
        return logits[:, 0], rng.integers(0, 5, (4, 1)).astype(np.int32)
    if kind == "probs":
        e = np.exp(logits)
        return (e / e.sum(-1, keepdims=True)).astype(np.float32), np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 3))]
    return logits, rng.standard_normal((4, 3, 5)).astype(np.float32)


@pytest.mark.parametrize(
    "loss,kind,from_logits",
    [
        ("SPARSE_CATEGORICAL_CROSSENTROPY", "sparse", True),
        ("SPARSE_CATEGORICAL_CROSSENTROPY", "sparse_col", True),
        ("SPARSE_CATEGORICAL_CROSSENTROPY", "probs", False),
        ("CATEGORICAL_CROSSENTROPY", "probs", True),
        ("CATEGORICAL_CROSSENTROPY", "probs", False),
        ("MEAN_SQUARED_ERROR_AVG_REDUCE", "dense", True),
        ("MEAN_SQUARED_ERROR_SUM_REDUCE", "dense", True),
        ("IDENTITY", "dense", True),
    ],
)
def test_loss_matches_jax(loss, kind, from_logits):
    logits, labels = _logits_and_labels(kind, np.random.default_rng(0))
    if loss == "SPARSE_CATEGORICAL_CROSSENTROPY" and kind == "probs":
        labels = labels.argmax(-1).astype(np.int32)
    ours = compute_loss(LossType[loss], _t(logits), _t(labels), from_logits=from_logits)
    ref = jax_loss(JLoss[loss], jnp.asarray(logits), jnp.asarray(labels), from_logits=from_logits)
    assert ours.shape == ()
    np.testing.assert_allclose(float(ours), float(ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kind,from_logits", [("sparse", True), ("sparse_col", False), ("probs", False), ("dense", True)])
def test_metrics_match_jax(kind, from_logits):
    logits, labels = _logits_and_labels(kind, np.random.default_rng(1))
    if kind in ("sparse", "sparse_col"):
        kinds = ["ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY"]
    elif kind == "probs":
        kinds = ["ACCURACY", "CATEGORICAL_CROSSENTROPY", "MEAN_SQUARED_ERROR"]
    else:
        kinds = ["MEAN_SQUARED_ERROR", "ROOT_MEAN_SQUARED_ERROR", "MEAN_ABSOLUTE_ERROR"]
    ours = compute_metrics([MetricsType[k] for k in kinds], _t(logits), _t(labels), from_logits)
    ref = jax_metrics([JMetrics[k] for k in kinds], jnp.asarray(logits), jnp.asarray(labels), from_logits)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(float(ours[key]), float(ref[key]), atol=1e-5, rtol=1e-6)
    perf = PerfMetrics()
    perf.update({k: float(v) for k, v in ours.items()}, 0.5)
    assert perf.train_all == logits.shape[0] and perf.iterations == 1


# -- optimizers ---------------------------------------------------------------------


def _tree(rng):
    return {100: [rng.standard_normal((3, 4)).astype(np.float32)], 103: [rng.standard_normal(5).astype(np.float32), rng.standard_normal((2, 2)).astype(np.float32)]}


@pytest.mark.parametrize(
    "name,kw",
    [
        ("sgd", {}),
        ("sgd", {"momentum": 0.9}),
        ("sgd", {"momentum": 0.9, "nesterov": True}),
        ("sgd", {"momentum": 0.5, "weight_decay": 0.01}),
        ("adam", {}),
        ("adam", {"weight_decay": 0.01, "beta1": 0.8}),
    ],
)
def test_optimizer_updates_match_jax(name, kw):
    rng = np.random.default_rng(2)
    params = _tree(rng)
    ours_opt = (SGDOptimizer(lr=0.1, **kw) if name == "sgd" else AdamOptimizer(alpha=0.01, **kw))
    ref_opt = (JSGD(lr=0.1, **kw) if name == "sgd" else JAdam(alpha=0.01, **kw))
    ours = {g: [_t(w.copy()) for w in ws] for g, ws in params.items()}
    ref = {g: [jnp.asarray(w) for w in ws] for g, ws in params.items()}
    ostate, rstate = ours_opt.init_state(ours), ref_opt.init_state(ref)
    for _ in range(3):
        grads = _tree(rng)
        ours, ostate = ours_opt.update(ours, {g: [_t(x) for x in gs] for g, gs in grads.items()}, ostate)
        ref, rstate = ref_opt.update(ref, {g: [jnp.asarray(x) for x in gs] for g, gs in grads.items()}, rstate)
    assert ostate["step"] == int(rstate["step"]) == 3
    for g in params:
        for a, b in zip(ours[g], ref[g]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    for key in set(rstate) - {"step"}:
        for g in params:
            for a, b in zip(ostate[key][g], rstate[key][g]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_dataloader_matches_jax():
    specs = {"x": ((3,), np.float32, 0), "ids": ((2,), np.int32, 7)}
    data = synthetic_dataset(specs, 10, seed=3)
    ref_data = jax_synthetic(specs, 10, seed=3)
    for k in data:
        np.testing.assert_array_equal(data[k], ref_data[k])
    ours = SingleDataLoader(data, 4, shuffle=True, seed=5)
    ref = JLoader(ref_data, 4, shuffle=True, seed=5, use_native=False)
    assert ours.num_batches == ref.num_batches == 2
    for _ in range(2):  # two epochs: the permutation advances the same way
        for a, b in zip(ours, ref):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# -- the slice: tiny flagship Transformer ---------------------------------------------


def _flagship_pair(optimizer="sgd", use_flash="auto"):
    """(jax model, port model) of the flagship encoder at tiny widths,
    compiled for MSE, the port carrying the JAX model's weights."""
    jopt, topt = {
        "sgd": (JSGD(lr=0.01, momentum=0.9), SGDOptimizer(lr=0.01, momentum=0.9)),
        "adam": (JAdam(alpha=0.01), AdamOptimizer(alpha=0.01)),
    }[optimizer]
    jm = JFFModel(JFFConfig(batch_size=B, seed=0))
    jax_build_encoder(jm, jm.create_tensor([B, S, HID], name="x"), hidden=HID, num_heads=HEADS, num_layers=LAYERS)
    jm.compile(optimizer=jopt, loss_type=JLoss.MEAN_SQUARED_ERROR_AVG_REDUCE, metrics=[], devices=jax.devices()[:1])
    tm = FFModel(FFConfig(batch_size=B, seed=0))
    build_transformer_encoder(tm, tm.create_tensor([B, S, HID], name="x"), hidden=HID, num_heads=HEADS, num_layers=LAYERS)
    for n in tm.graph.nodes.values():
        if n.op_type.name == "MULTIHEAD_ATTENTION":
            n.params["use_flash"] = use_flash
    tm.compile(topt, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [MetricsType.MEAN_SQUARED_ERROR], device="cpu")
    params_from_host(tm, jm.executor.export_host_params(jm.params))
    return jm, tm


def _batch(seed, n=B):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, S, HID).astype(np.float32), "label": rng.randn(n, S, 1).astype(np.float32)}


def _assert_params_close(tm, jparams):
    for g, ws in tm.params.items():
        for a, b in zip(ws, jparams[g]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=STEP_ATOL)


def test_flagship_graph_matches_guid_for_guid():
    jm, tm = _flagship_pair()
    assert sorted(tm.graph.nodes) == sorted(jm.graph.nodes)
    for g, n in tm.graph.nodes.items():
        jn = jm.graph.nodes[g]
        assert n.op_type.name == jn.op_type.name and n.name == jn.name
        assert [s.logical_sizes for s in n.weight_shapes] == [s.logical_sizes for s in jn.weight_shapes]
    assert tm.executor.label_shape.logical_sizes == jm.executor.label_shape.logical_sizes
    assert tm.executor.label_shape.dtype.value == jm.executor.label_shape.dtype.value


@pytest.mark.parametrize("optimizer,use_flash", [("sgd", "auto"), ("sgd", False), ("adam", "auto")])
def test_flagship_train_steps_match_jax(optimizer, use_flash):
    """Loss and params after 1 and 3 train steps of the port match the
    JAX executor's, through the plain flash path ("auto": head_dim 8) and
    the dense core (False); the optimizer state round-trips through the
    host layout both ways."""
    jm, tm = _flagship_pair(optimizer, use_flash)
    jstep, tstep = jm.executor.train_step(), tm.executor.train_step()
    jparams, jstate = jm.params, jm.opt_state
    fk.reset_launches()
    for i in range(3):
        batch = _batch(10 + i)
        jparams, jstate, jloss, _ = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
        tm.params, tm.opt_state, tloss, mets = tstep(tm.params, tm.opt_state, tm.executor.shard_batch(batch), i)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=STEP_RTOL)
        assert set(mets) == {"num_samples", "mse_sum"}
        if i in (0, 2):
            _assert_params_close(tm, jparams)
        if i == 0:
            # carry the JAX state over: the port's steps continue from it
            opt_state_from_host(tm, jm.executor.export_host_opt_state(jstate))
    assert fk.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}  # the CPU runs plain versions
    ours = tm.executor.export_host_opt_state(tm.opt_state)
    ref = jm.executor.export_host_opt_state(jstate)
    assert int(ours["step"]) == int(np.asarray(ref["step"])) == 3
    for key in set(ref) - {"step"}:
        for g in ref[key]:
            for a, b in zip(ours[key][g], ref[key][g]):
                np.testing.assert_allclose(a, np.asarray(b), atol=STEP_ATOL)


def test_flagship_gradients_and_evaluate_match_jax():
    jm, tm = _flagship_pair()
    batch = _batch(20, n=2 * B)
    tg = tm.compute_gradients(batch["x"][:B], batch["label"][:B])
    jg = jm.compute_gradients(batch["x"][:B], batch["label"][:B])
    assert sorted(tg) == sorted(jg)
    for g in jg:
        for a, b in zip(tg[g], jg[g]):
            np.testing.assert_allclose(a, b, atol=STEP_ATOL)
    tperf = tm.evaluate(batch["x"], batch["label"])
    jperf = jm.evaluate(batch["x"], batch["label"])
    assert tperf.train_all == jperf.train_all == 2 * B and tperf.iterations == 2
    np.testing.assert_allclose(tperf.loss_sum, jperf.loss_sum, rtol=STEP_RTOL)
    assert tm.get_perf_metrics() is tperf


def test_fit_equals_a_hand_loop_and_times_after_warm_up(monkeypatch):
    """fit() over 3 batches leaves the params a hand loop of train_step
    leaves, reports the same mean loss, and its throughput counts the
    batches after the first (the warm-up)."""
    _, fitted = _flagship_pair()
    _, looped = _flagship_pair()
    data = _batch(30, n=3 * B)
    clock = types.SimpleNamespace(now=0.0)
    monkeypatch.setattr(model_mod, "time", types.SimpleNamespace(perf_counter=lambda: clock.now))
    real = fitted.executor.train_step

    def timed_train_step():
        step = real()

        def run(*a):
            # the warm-up step "takes" 100 s, the others 1 s each
            clock.now += 100.0 if fitted._steps == 1 else 1.0
            return step(*a)

        return run

    fitted.executor.train_step = timed_train_step
    hist = fitted.fit(data["x"], data["label"], verbose=False)
    assert len(hist) == 1 and hist[0]["iterations"] == 3 and hist[0]["train_all"] == 3 * B
    assert hist[0]["throughput"] == pytest.approx(2 * B / 2.0)  # 2 timed batches over 2 s
    step = looped.executor.train_step()
    losses = []
    for i in range(3):
        batch = {k: v[i * B:(i + 1) * B] for k, v in data.items()}
        looped.params, looped.opt_state, loss, _ = step(looped.params, looped.opt_state, looped.executor.shard_batch(batch), i + 1)
        losses.append(float(loss))
    np.testing.assert_allclose(hist[0]["loss_sum"] / (3 * B), np.mean(losses), rtol=1e-6)
    for g, ws in fitted.params.items():
        for a, b in zip(ws, looped.params[g]):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_compile_takes_the_reference_argument_order():
    """compile(optimizer, loss_type, metrics, comp_mode, logits) as the
    reference's examples call it, plus device=; one device in devices=
    is the device, more raise."""
    tm = FFModel(FFConfig(batch_size=B))
    out = build_transformer_encoder(tm, tm.create_tensor([B, S, HID], name="x"), hidden=HID, num_heads=HEADS, num_layers=1)
    opt = SGDOptimizer(lr=0.5)
    tm.compile(opt, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [], None, out, devices=["cpu"])
    assert tm.optimizer is opt and tm.device.type == "cpu" and tm.executor.logits_ref == out.ref
    assert tm.opt_state == {"step": 0}
    with pytest.raises(NotImplementedError, match="one device"):
        tm.compile(opt, devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="strategies"):
        tm.compile(opt, device="cpu", strategy=object())
    bf16 = FFModel(FFConfig(allow_mixed_precision=True))
    build_transformer_encoder(bf16, bf16.create_tensor([B, S, HID], name="x"), hidden=HID, num_heads=HEADS, num_layers=1)
    with pytest.raises(NotImplementedError, match="bf16"):
        bf16.compile(device="cpu")
    default = FFModel(FFConfig(batch_size=B, learning_rate=0.3))
    build_transformer_encoder(default, default.create_tensor([B, S, HID], name="x"), hidden=HID, num_heads=HEADS, num_layers=1)
    default.compile(device="cpu")
    assert default.optimizer == SGDOptimizer(lr=0.3, weight_decay=0.0001)


# -- the causal path: tiny decoder LM --------------------------------------------------


def test_decoder_lm_takes_one_plain_sgd_step_like_jax():
    """Causal flash (plain version), embeddings, layer norm and sparse CE
    through one plain-SGD step; the reference updates the table's touched
    rows only, which for plain SGD is the dense update."""
    jm = JFFModel(JFFConfig(batch_size=B, seed=0))
    jax_build_decoder_lm(jm, jm.create_tensor([B, S], dtype=JDataType.INT32, name="tokens"), vocab_size=VOCAB, hidden=HID, num_heads=HEADS, num_layers=2, ff_dim=64)
    jm.compile(optimizer=JSGD(lr=0.1), loss_type=JLoss.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[JMetrics.ACCURACY], devices=jax.devices()[:1])
    tm = FFModel(FFConfig(batch_size=B, seed=0))
    build_decoder_lm(tm, tm.create_tensor([B, S], dtype=DataType.INT32, name="tokens"), vocab_size=VOCAB, hidden=HID, num_heads=HEADS, num_layers=2, ff_dim=64)
    tm.compile(SGDOptimizer(lr=0.1), LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.ACCURACY], device="cpu")
    params_from_host(tm, jm.executor.export_host_params(jm.params))
    assert tm.executor.sparse_embedding_guids() == [101]
    rng = np.random.RandomState(40)
    batch = {"tokens": rng.randint(0, VOCAB, (B, S)).astype(np.int32), "label": rng.randint(0, VOCAB, (B, S)).astype(np.int32)}
    jparams, _, jloss, jmets = jm.executor.train_step()(jm.params, jm.opt_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    tm.params, tm.opt_state, tloss, tmets = tm.executor.train_step()(tm.params, tm.opt_state, tm.executor.shard_batch(batch), 0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=STEP_RTOL)
    assert float(tmets["accuracy_sum"]) == float(jmets["accuracy_sum"])
    _assert_params_close(tm, jparams)


def test_node_generator_is_made_on_first_read_and_is_seeded_per_node():
    """A seeded forward gives each node a LowerCtx carrying its seed; the
    torch.Generator behind ctx.rng exists only once a lowering reads it,
    and the same (rng, guid) draws the same numbers."""
    from flexflow_tpu_torch.ops.registry import LowerCtx
    from flexflow_tpu_torch.runtime.executor import node_seed

    assert LowerCtx().rng is None
    ctx = LowerCtx(train=True, seed=node_seed(3, 101), device=torch.device("cpu"))
    assert "rng" not in vars(ctx)
    first = torch.rand(4, generator=ctx.rng)
    assert "rng" in vars(ctx) and ctx.rng is ctx.rng
    again = LowerCtx(train=True, seed=node_seed(3, 101), device=torch.device("cpu"))
    torch.testing.assert_close(torch.rand(4, generator=again.rng), first, atol=0, rtol=0)
    other = LowerCtx(train=True, seed=node_seed(3, 102), device=torch.device("cpu"))
    assert not torch.equal(torch.rand(4, generator=other.rng), first)
