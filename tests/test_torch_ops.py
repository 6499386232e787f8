"""flexflow_tpu_torch operators, graph and weights against the JAX
package: per-op shape inference and lowering parity on the same numpy
inputs (atol 1e-5), the decoder LM's graph guid for guid, weight
carry-over (runtime/interop.py) giving full-forward logits within 1e-4,
compile()'s device rule, and the port's import hygiene (no jax, nothing
of flexflow_tpu)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import LossType, SGDOptimizer
from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.core.parallel_tensor import ParallelTensorShape as JShape
from flexflow_tpu.core.types import ActiMode as JActi
from flexflow_tpu.core.types import OperatorType as JOp
from flexflow_tpu.models import build_decoder_lm as jax_build_decoder_lm
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops.registry import LowerCtx as JCtx
from flexflow_tpu.ops.registry import _ensure_registered as jax_registered
from flexflow_tpu.ops.registry import infer_shapes as jinfer
from flexflow_tpu.ops.registry import lower_op as jlower
from flexflow_tpu_torch import DataType, FFConfig, FFModel
from flexflow_tpu_torch import SGDOptimizer as TSGD
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.core.types import ActiMode, OperatorType
from flexflow_tpu_torch.models import build_decoder_lm
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops.registry import LowerCtx, _ensure_registered, infer_shapes, lower_op
from flexflow_tpu_torch.runtime.interop import params_from_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
VOCAB = 64

jax_registered()
_ensure_registered()


def _lower_both(op, params, jparams, shapes, ins, ws):
    """Run one op through both registries on the same numpy operands;
    returns (port output, jax output, port weight shapes, jax weight
    shapes)."""
    tshapes = [ParallelTensorShape.make(s, dt) for s, dt in shapes]
    jshapes = [JShape.make(s, JDataType(dt.value)) for s, dt in shapes]
    (tout,), tw = infer_shapes(op, tshapes, params)
    (jout,), jw = jinfer(JOp[op.name], jshapes, jparams)
    assert tout.logical_sizes == jout.logical_sizes
    t = lower_op(op, params)([torch.from_numpy(x) for x in ins], [torch.from_numpy(w) for w in ws], LowerCtx())
    j = jlower(JOp[op.name], jparams)([jax.numpy.asarray(x) for x in ins], [jax.numpy.asarray(w) for w in ws], JCtx(train=False))
    return t[0].numpy(), np.asarray(j[0]), [s.logical_sizes for s in tw], [s.logical_sizes for s in jw]


@pytest.mark.parametrize(
    "act,use_bias", [(ActiMode.NONE, False), (ActiMode.GELU, False), (ActiMode.GELU, True), (ActiMode.RELU, True)]
)
def test_linear_parity(act, use_bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    ws = [rng.standard_normal((12, 7)).astype(np.float32)]
    if use_bias:
        ws.append(rng.standard_normal(7).astype(np.float32))
    p = {"out_features": 7, "activation": act, "use_bias": use_bias}
    jp = dict(p, activation=JActi[act.name])
    t, j, tw, jw = _lower_both(OperatorType.LINEAR, p, jp, [((2, 5, 12), DataType.FLOAT)], [x], ws)
    assert tw == jw
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_layernorm_parity():
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 5, 12)) + 1).astype(np.float32)
    ws = [rng.standard_normal(12).astype(np.float32), rng.standard_normal(12).astype(np.float32)]
    p = {"axes": (2,), "elementwise_affine": True, "eps": 1e-5}
    t, j, tw, jw = _lower_both(OperatorType.LAYERNORM, p, p, [((2, 5, 12), DataType.FLOAT)], [x], ws)
    assert tw == jw
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_embedding_parity():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, VOCAB, (3, 6)).astype(np.int32)
    table = rng.standard_normal((VOCAB, 10)).astype(np.float32)
    p = {"num_entries": VOCAB, "out_dim": 10}
    t, j, tw, jw = _lower_both(OperatorType.EMBEDDING, p, p, [((3, 6), DataType.INT32)], [ids], [table])
    assert tw == jw
    np.testing.assert_allclose(t, j, atol=0)


def test_add_parity():
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((2, 4, 8)).astype(np.float32) for _ in range(2))
    shapes = [((2, 4, 8), DataType.FLOAT)] * 2
    t, j, _, _ = _lower_both(OperatorType.EW_ADD, {}, {}, shapes, [a, b], [])
    np.testing.assert_allclose(t, j, atol=0)


@pytest.mark.parametrize("causal,bias", [(True, False), (False, True)])
def test_mha_parity(causal, bias):
    """The dense MHA lowering: projections, masked softmax, output
    projection, with the reference's weight layouts."""
    rng = np.random.default_rng(4)
    e, h = 16, 4
    x = rng.standard_normal((2, 7, e)).astype(np.float32)
    p = {"embed_dim": e, "num_heads": h, "kdim": e, "vdim": e, "dropout": 0.0, "bias": bias, "causal": causal}
    shapes = [((2, 7, e), DataType.FLOAT)] * 3
    tshapes = [ParallelTensorShape.make(s, dt) for s, dt in shapes]
    _, tw = infer_shapes(OperatorType.MULTIHEAD_ATTENTION, tshapes, p)
    ws = [rng.standard_normal(s.logical_sizes).astype(np.float32) * 0.3 for s in tw]
    t, j, tws, jws = _lower_both(OperatorType.MULTIHEAD_ATTENTION, p, p, shapes, [x, x, x], ws)
    assert tws == jws
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_sdpa_and_projection_helpers_parity():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 9, 3, 8)).astype(np.float32) for _ in range(3))
    for causal in (False, True):
        t = tattn.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
        j = jattn.scaled_dot_product_attention(*map(jax.numpy.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    ws = [rng.standard_normal((24, 3, 8)).astype(np.float32) for _ in range(3)]
    ws.append(rng.standard_normal((3, 8, 24)).astype(np.float32))
    ws += [rng.standard_normal((3, 8)).astype(np.float32) for _ in range(3)]
    ws.append(rng.standard_normal(24).astype(np.float32))
    tw, jw = [torch.from_numpy(w) for w in ws], [jax.numpy.asarray(w) for w in ws]
    tq = tattn.mha_project_qkv([torch.from_numpy(x)] * 3, tw)
    jq = jattn.mha_project_qkv([jax.numpy.asarray(x)] * 3, jw, None)
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    attn = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    to = tattn.mha_project_out(torch.from_numpy(attn), tw)
    jo = jattn.mha_project_out(jax.numpy.asarray(attn), jw, None, jax.numpy.float32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)


def test_datatype_maps_match_the_reference():
    assert [d.value for d in DataType] == [d.value for d in JDataType]
    for d in DataType:
        assert d.to_torch() == getattr(torch, d.value)
        assert DataType.from_torch(d.to_torch()) is d


@pytest.mark.parametrize("view", [(0, (4,), (1,)), (2, (2, 3), (3, 1)), (1, (2, 2), (1, 4))])
def test_machine_view_parity(view):
    ours, ref = MachineView(*view), JView(*view)
    assert ours.device_ids() == ref.device_ids()
    assert ours.num_devices == ref.num_devices and ours.hash() == ref.hash()
    assert MachineView.dp_view(4).hash() == JView.dp_view(4).hash()
    with pytest.raises(ValueError):
        MachineView(0, (2, 0), (1, 1))


# -- whole graph + weight carry-over --------------------------------------------


def _jax_lm(layers=2):
    model = JFFModel(JFFConfig(batch_size=2, seed=0))
    tok = model.create_tensor([2, 16], dtype=JDataType.INT32, name="tokens")
    jax_build_decoder_lm(model, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=layers, ff_dim=64)
    model.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[],
        devices=jax.devices()[:1],
    )
    return model


def _torch_lm(layers=2, seed=0):
    model = FFModel(FFConfig(batch_size=2, seed=seed))
    tok = model.create_tensor([2, 16], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(model, tok, vocab_size=VOCAB, hidden=32, num_heads=4, num_layers=layers, ff_dim=64)
    model.compile(device="cpu")
    return model


@pytest.fixture(scope="module")
def jax_lm():
    return _jax_lm()


def test_decoder_graph_matches_guid_for_guid(jax_lm):
    ours = _torch_lm()
    assert sorted(ours.graph.nodes) == sorted(jax_lm.graph.nodes)
    assert min(ours.graph.nodes) == 100
    for g, n in ours.graph.nodes.items():
        jn = jax_lm.graph.nodes[g]
        assert n.op_type.name == jn.op_type.name and n.name == jn.name
        assert [s.logical_sizes for s in n.weight_shapes] == [s.logical_sizes for s in jn.weight_shapes]
        assert [s.logical_sizes for s in n.output_shapes] == [s.logical_sizes for s in jn.output_shapes]
        assert n.machine_view is None and jn.machine_view is None
    assert ours.executor.topo == jax_lm.executor.topo


def test_carried_weights_give_full_forward_logits(jax_lm):
    ours = _torch_lm()
    host = jax_lm.executor.export_host_params(jax_lm.params)
    params_from_host(
        ours,
        {g: [np.asarray(w) for w in ws] for g, ws in host.items()},
        op_types={g: n.op_type.name for g, n in jax_lm.graph.nodes.items()},
    )
    tokens = np.random.default_rng(6).integers(0, VOCAB, (2, 11)).astype(np.int32)
    ref = np.asarray(jax_lm.forward({"tokens": tokens}))
    got = ours.forward({"tokens": tokens}).numpy()
    assert got.shape == ref.shape == (2, 11, VOCAB)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_carry_over_rejects_mismatches(jax_lm):
    ours = _torch_lm()
    host = {g: [np.asarray(w) for w in ws] for g, ws in jax_lm.executor.export_host_params(jax_lm.params).items()}
    g0 = min(host)
    bad_shape = {**host, g0: [host[g0][0][:, :-1]]}
    with pytest.raises(ValueError, match="shape"):
        params_from_host(ours, bad_shape)
    with pytest.raises(KeyError, match="missing"):
        params_from_host(ours, {g: ws for g, ws in host.items() if g != g0})
    with pytest.raises(ValueError, match="lacks"):
        params_from_host(ours, {**host, 999: [np.zeros(3, np.float32)]})
    types = {g: n.op_type.name for g, n in jax_lm.graph.nodes.items()}
    types[g0] = "LINEAR"
    with pytest.raises(ValueError, match="source graph"):
        params_from_host(ours, host, op_types=types)


def test_seeded_init_is_deterministic_and_glorot_bounded():
    a, b, c = _torch_lm(seed=0), _torch_lm(seed=0), _torch_lm(seed=1)
    for g, ws in a.params.items():
        for i, w in enumerate(ws):
            torch.testing.assert_close(w, b.params[g][i], atol=0, rtol=0)
            shape = a.graph.nodes[g].weight_shapes[i].logical_sizes
            if len(shape) >= 2:
                limit = np.sqrt(6.0 / (np.prod(shape[:-1]) + shape[-1]))
                assert float(w.abs().max()) <= limit
                assert not torch.equal(w, c.params[g][i])


def test_compile_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: compile() places the model there")
    model = FFModel(FFConfig(batch_size=2))
    tok = model.create_tensor([2, 8], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(model, tok, vocab_size=VOCAB, hidden=16, num_heads=2, num_layers=1, ff_dim=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.compile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.compile(device="cuda")
    assert model.executor is None


def test_training_compile_is_not_ported():
    """Training compiles now; what is not ported is the reference's lazy
    touched-rows update of embedding tables: an embedding model with a
    stateful optimizer under sparse_embedding_update=True raises rather
    than train to other numbers."""
    model = FFModel(FFConfig(batch_size=2))
    assert model.config.sparse_embedding_update
    tok = model.create_tensor([2, 8], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(model, tok, vocab_size=VOCAB, hidden=16, num_heads=2, num_layers=1, ff_dim=32)
    model.compile(TSGD(lr=0.01, momentum=0.9), device="cpu")
    assert model.executor.sparse_embedding_guids() == [min(model.graph.nodes) + 1]
    with pytest.raises(NotImplementedError, match="sparse-embedding"):
        model.executor.train_step()
    x = np.zeros((2, 8), np.int32)
    with pytest.raises(NotImplementedError, match="sparse-embedding"):
        model.fit(x, x, verbose=False)


# -- import hygiene ----------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|flexflow_tpu)\b", re.M)


def test_port_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "flexflow_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    offenders = [f for f in files if _FORBIDDEN.search(open(f).read())]
    assert not offenders


def test_port_modules_load_without_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import chip_smoke, flexflow_tpu_torch, flexflow_tpu_torch.serving,"
        " flexflow_tpu_torch.models, flexflow_tpu_torch.runtime.interop,"
        " flexflow_tpu_torch.ops.cuda.decode_kernel,"
        " flexflow_tpu_torch.ops.cuda.flash_kernel,"
        " flexflow_tpu_torch.runtime.loss, flexflow_tpu_torch.runtime.metrics,"
        " flexflow_tpu_torch.runtime.optimizer, flexflow_tpu_torch.runtime.dataloader;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flexflow_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
