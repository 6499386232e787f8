"""flexflow_tpu_torch's mixed precision (FFConfig.allow_mixed_precision)
against the JAX package's, on the CPU, from seeded numpy inputs:
mm_operands and mm_out_dtype, the lowerings it touches (LINEAR,
LAYERNORM, EW_ADD, the MHA projections and dense core), the losses under
bf16 logits, the executor's flag, the reference's own criterion (a mixed
run trains close to the fp32 run, tests/test_precision.py) and
generate() of such a model against the JAX package's
(tests/test_torch_mixed_serving.py holds the whole serving stack).

Tolerances: LINEAR and LAYERNORM are bit-identical (torch's CPU bf16
matmul rounds its f32 sum once, as JAX's preferred_element_type=f32 then
astype does; layer norm is computed in f32 in both), but for a GELU on
the bf16 output (2e-2, see the test). The MHA projections
and the dense core differ only where a sum rounds to bf16 in another
order: within one bf16 ulp (2^-8 relative, atol 1e-2 on O(1) values).
Losses of bf16 logits are computed in f32 in both: 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.core.types import ActiMode as JActiMode
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import OperatorType as JOperatorType
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops.registry import LowerCtx as JLowerCtx
from flexflow_tpu.ops.registry import _ensure_registered as jax_register
from flexflow_tpu.ops.registry import lower_op as jax_lower
from flexflow_tpu.ops.registry import mm_operands as jax_mm_operands
from flexflow_tpu.ops.registry import mm_out_dtype as jax_mm_out_dtype
from flexflow_tpu.runtime.loss import compute_loss as jax_loss
from flexflow_tpu_torch import ActiMode, DataType, FFConfig, FFModel, LossType, SGDOptimizer
from flexflow_tpu_torch.core.types import OperatorType
from flexflow_tpu_torch.models import build_decoder_lm
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops.registry import LowerCtx, _ensure_registered, lower_op, mm_operands, mm_out_dtype
from flexflow_tpu_torch.runtime.loss import compute_loss

_ensure_registered()
jax_register()

ON, OFF = LowerCtx(bf16_matmul=True), LowerCtx()
JON = JLowerCtx(bf16_matmul=True)
PROJ_ATOL = 1e-2
GELU_ATOL = 2e-2
LOSS_TOL = 1e-6


def _np(x):
    """A torch or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def test_mm_operands_casts_only_when_enabled():
    """As the reference's (tests/test_precision.py): float32 tensors
    become bf16 with the flag on, other dtypes stay, and the cast rounds
    as JAX's astype does (to nearest even), bit for bit."""
    x = torch.ones(4, 4)
    i = torch.ones(4, dtype=torch.int32)
    assert mm_operands(OFF, x)[0].dtype == torch.float32
    assert mm_operands(None, x)[0] is x
    a, b = mm_operands(ON, x, i)
    assert a.dtype == torch.bfloat16 and b.dtype == torch.int32
    ja, jb = jax_mm_operands(JON, jnp.ones((4, 4), jnp.float32), jnp.ones((4,), jnp.int32))
    assert ja.dtype == jnp.bfloat16 and jb.dtype == jnp.int32
    vals = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 10.0
    (ours,) = mm_operands(ON, torch.from_numpy(vals))
    (ref,) = jax_mm_operands(JON, jnp.asarray(vals))
    np.testing.assert_array_equal(_np(ours), _np(ref))


def test_mm_out_dtype_follows_the_flag():
    assert mm_out_dtype(ON, torch.float32) == torch.bfloat16
    assert mm_out_dtype(OFF, torch.float32) == torch.float32
    assert mm_out_dtype(None, torch.float64) == torch.float64
    assert jax_mm_out_dtype(JON, jnp.float32) == jnp.bfloat16


@pytest.mark.parametrize("use_bias,act", [(True, "RELU"), (False, "NONE"), (True, "GELU")])
def test_linear_matches_jax_bit_for_bit(use_bias, act):
    """bf16 operands, f32 accumulation, one rounding to bf16, the bias
    cast to bf16 before the add and the activation on bf16. GELU is the
    one step that is not bit for bit: torch evaluates the erf form of a
    bf16 input in f32 and rounds once, JAX in bf16 steps; they stay
    within GELU_ATOL (about 2 bf16 ulps of the largest outputs)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal((64, 48))).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    ws = [w, b] if use_bias else [w]
    p = {"out_features": 48, "activation": getattr(ActiMode, act), "use_bias": use_bias}
    jp = dict(p, activation=getattr(JActiMode, act))
    (ours,) = lower_op(OperatorType.LINEAR, p)([torch.from_numpy(x)], [torch.from_numpy(a) for a in ws], ON)
    (ref,) = jax_lower(JOperatorType.LINEAR, jp)([jnp.asarray(x)], [jnp.asarray(a) for a in ws], JON)
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    if act == "GELU":
        np.testing.assert_allclose(_np(ours), _np(ref), atol=GELU_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(_np(ours), _np(ref))
    # the flag off leaves the fp32 path as it was
    (f32,) = lower_op(OperatorType.LINEAR, p)([torch.from_numpy(x)], [torch.from_numpy(a) for a in ws], OFF)
    assert f32.dtype == torch.float32


def test_layernorm_keeps_f32_statistics_under_bf16():
    """A bf16 input is normalised in f32 with the f32 affine and rounded
    back to bf16, bit for bit with the reference; an f32 input stays f32."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    g, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    xb = torch.from_numpy(x).bfloat16()
    (ours,) = lower_op(OperatorType.LAYERNORM, {})([xb], [torch.from_numpy(g), torch.from_numpy(b)], ON)
    (ref,) = jax_lower(JOperatorType.LAYERNORM, {})(
        [jnp.asarray(x).astype(jnp.bfloat16)], [jnp.asarray(g), jnp.asarray(b)], JON
    )
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(ours), _np(ref))
    (f32,) = lower_op(OperatorType.LAYERNORM, {})([torch.from_numpy(x)], [torch.from_numpy(g), torch.from_numpy(b)], ON)
    assert f32.dtype == torch.float32


def test_residual_add_promotes_bf16_to_f32_as_jax_does():
    """EW_ADD takes no cast: an f32 residual stream (an embedding's
    output) plus a bf16 matmul output stays f32 in both packages."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 8, 16)).astype(np.float32)
    b = rng.standard_normal((2, 8, 16)).astype(np.float32)
    (ours,) = lower_op(OperatorType.EW_ADD, {})([torch.from_numpy(a), torch.from_numpy(b).bfloat16()], [], ON)
    (ref,) = jax_lower(JOperatorType.EW_ADD, {})([jnp.asarray(a), jnp.asarray(b).astype(jnp.bfloat16)], [], JON)
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_array_equal(_np(ours), _np(ref))


def test_embedding_output_stays_f32():
    """EMBEDDING under mixed precision: the f32 table's rows, uncast."""
    table = np.random.default_rng(4).standard_normal((10, 8)).astype(np.float32)
    ids = torch.tensor([[1, 2], [9, 0]], dtype=torch.int32)
    p = {"num_entries": 10, "out_dim": 8}
    (ours,) = lower_op(OperatorType.EMBEDDING, p)([ids], [torch.from_numpy(table)], ON)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), table[ids.numpy()])


def _mha_inputs(seed, e=32, h=2, d=16, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, e)).astype(np.float32)
    ws = [(0.2 * rng.standard_normal(s)).astype(np.float32) for s in ((e, h, d),) * 3 + ((h, d, e),)]
    if bias:
        ws += [rng.standard_normal((h, d)).astype(np.float32) for _ in range(3)]
        ws.append(rng.standard_normal(e).astype(np.float32))
    return x, ws


def test_mha_projections_match_jax():
    """mha_project_qkv gives bf16 q, k, v with bf16 biases, and
    mha_project_out a bf16 output, as the reference's."""
    x, ws = _mha_inputs(5)
    tw = [torch.from_numpy(w) for w in ws]
    jw = [jnp.asarray(w) for w in ws]
    ours = tattn.mha_project_qkv([torch.from_numpy(x)] * 3, tw, ON)
    ref = jattn.mha_project_qkv([jnp.asarray(x)] * 3, jw, JON)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np(a), _np(b), atol=PROJ_ATOL, rtol=2**-8)
    out = tattn.mha_project_out(ours[0], tw, ON)
    jout = jattn.mha_project_out(ref[0], jw, JON, jnp.float32)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), atol=PROJ_ATOL, rtol=2**-8)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_core_forms_f32_logits_from_bf16_operands(causal):
    """The dense core on bf16 q, k, v: logits in f32, f32 softmax,
    probabilities rounded to bf16 before P V, a bf16 output."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32) for _ in range(3))
    ours = tattn.scaled_dot_product_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal)
    ref = jattn.scaled_dot_product_attention(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), causal=causal)
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(ours), _np(ref), atol=PROJ_ATOL, rtol=2**-8)


@pytest.mark.parametrize(
    "loss,labels",
    [("SPARSE_CATEGORICAL_CROSSENTROPY", "ids"), ("CATEGORICAL_CROSSENTROPY", "onehot"),
     ("MEAN_SQUARED_ERROR_AVG_REDUCE", "dense"), ("MEAN_SQUARED_ERROR_SUM_REDUCE", "dense"),
     ("IDENTITY", "dense")],
)
def test_losses_upcast_bf16_logits_as_the_reference(loss, labels):
    """Each loss on bf16 logits (float32 or int labels) equals the
    reference's, both computed in f32."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 3, 5)).astype(np.float32)
    lab = {
        "ids": rng.integers(0, 5, (4, 3)).astype(np.int32),
        "onehot": np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 3))],
        "dense": rng.standard_normal((4, 3, 5)).astype(np.float32),
    }[labels]
    ours = compute_loss(getattr(LossType, loss), torch.from_numpy(logits).bfloat16(), torch.from_numpy(lab))
    ref = jax_loss(getattr(JLossType, loss), jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(lab))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(ref), rtol=LOSS_TOL, atol=LOSS_TOL)


def _dense_model(mixed):
    cfg = FFConfig(batch_size=16, learning_rate=0.05, allow_mixed_precision=mixed)
    model = FFModel(cfg)
    x = model.create_tensor([16, 8], name="x")
    t = model.dense(x, 32, activation=ActiMode.RELU)
    t = model.dense(t, 1, use_bias=False)
    model.compile(SGDOptimizer(lr=0.05), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [], device="cpu")
    return model


def test_mixed_precision_model_trains_close_to_f32():
    """The reference's own criterion (tests/test_precision.py): bf16
    operands lose mantissa, not trainability; the weights stay float32
    masters and the executor carries the flag into every LowerCtx."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x @ rng.randn(8, 1)).astype(np.float32)
    losses = {}
    for mixed in (False, True):
        model = _dense_model(mixed)
        assert model.executor.mixed_precision is mixed
        hist = model.fit(x, y, epochs=3, verbose=False)
        losses[mixed] = hist[-1]["loss_sum"] / hist[-1]["train_all"]
        assert all(w.dtype == torch.float32 for ws in model.params.values() for w in ws)
    assert np.isfinite(losses[True])
    assert abs(losses[True] - losses[False]) < 0.25 * abs(losses[False]) + 0.05


def test_executor_threads_the_flag_into_every_lowering():
    """Every LowerCtx forward_values builds, seeded or not, carries
    bf16_matmul = executor.mixed_precision; the logits come out bf16."""
    model = _dense_model(True)
    seen = []
    real = dict(model.executor._lowered)
    for guid, fn in real.items():
        model.executor._lowered[guid] = lambda ins, ws, ctx, fn=fn: seen.append(ctx.bf16_matmul) or fn(ins, ws, ctx)
    batch = {"x": np.ones((16, 8), np.float32)}
    assert model.executor.logits(model.params, batch).dtype == torch.bfloat16
    model.executor.forward_values(model.params, batch, rng=3, train=True)
    assert seen and all(seen)


def test_serving_a_mixed_precision_model_raises():
    """Serving a model compiled with allow_mixed_precision no longer
    raises: generate() and build_scheduler() serve it with bf16 q against
    the fp32 pools of kernels #4-#9, and its generate() equals the JAX
    package's generate() of the same model (weights carried by guid)."""
    import jax

    from flexflow_tpu import DataType as JDataType
    from flexflow_tpu import FFConfig as JFFConfig
    from flexflow_tpu import FFModel as JFFModel
    from flexflow_tpu import SGDOptimizer as JSGD
    from flexflow_tpu.models import build_decoder_lm as jax_build_decoder_lm
    from flexflow_tpu.serving import ServeConfig as JServeConfig
    from flexflow_tpu_torch.runtime.interop import params_from_host
    from flexflow_tpu_torch.serving import ServeConfig
    from flexflow_tpu_torch.serving.api import build_scheduler

    geo = dict(vocab_size=32, hidden=16, num_heads=2, num_layers=1, ff_dim=32)
    jm = JFFModel(JFFConfig(batch_size=2, seed=0, allow_mixed_precision=True))
    jax_build_decoder_lm(jm, jm.create_tensor([2, 16], name="tokens", dtype=JDataType.INT32), **geo)
    jm.compile(optimizer=JSGD(lr=0.1), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
               devices=jax.devices()[:1])
    mixed = FFModel(FFConfig(batch_size=2, seed=0, allow_mixed_precision=True))
    build_decoder_lm(mixed, mixed.create_tensor([2, 16], name="tokens", dtype=DataType.INT32), **geo)
    mixed.compile(SGDOptimizer(lr=0.1), LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [], device="cpu")
    host = jm.executor.export_host_params(jm.params)
    params_from_host(mixed, {g: [np.asarray(w) for w in ws] for g, ws in host.items()})
    serve = dict(max_seqs=2, max_seq_len=32)
    prompts = [[1, 2, 3], [4, 5], [6]]
    ours = mixed.generate(prompts, max_new_tokens=6, serve_config=ServeConfig(**serve))
    assert ours == jm.generate(prompts, max_new_tokens=6, serve_config=JServeConfig(**serve))
    assert all(len(s) == 6 for s in ours)
    _, engine, _ = build_scheduler(mixed, ServeConfig(**serve))
    assert engine.executor.mixed_precision
