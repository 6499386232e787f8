"""FFModel: the layer builder, compile(), fit()/evaluate() and generate()
(port of the single-device part of flexflow_tpu/runtime/model.py).

The builder records PCG nodes exactly as the reference does — same op
types, params and guids in build order — so the same builder calls give
the same graph in both packages. `compile()` takes the reference's
arguments plus `device=`, places the model on one `torch.device` (CUDA
unless the caller asks for the CPU), initialises its weights from the
config's seed and its optimizer state. `fit()` trains through the
executor's eager train step. Strategies, search, callbacks, telemetry
and checkpoints are not ported yet (ROADMAP, Port queue).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.core.pcg import PCGGraph, TensorRef
from flexflow_tpu_torch.core.types import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
)
from flexflow_tpu_torch.ops.registry import _ensure_registered, infer_shapes
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader
from flexflow_tpu_torch.runtime.executor import Executor
from flexflow_tpu_torch.runtime.initializer import ConstantInitializer, ZeroInitializer
from flexflow_tpu_torch.runtime.metrics import PerfMetrics
from flexflow_tpu_torch.runtime.optimizer import Optimizer, SGDOptimizer


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the current CUDA device when
    `device` is None, else `device`. Asking for CUDA on a machine without
    a card raises — nothing falls back to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Tensor:
    """Handle to one PCG tensor."""

    def __init__(self, model: "FFModel", ref: TensorRef):
        self.model = model
        self.ref = ref

    @property
    def shape(self) -> ParallelTensorShape:
        return self.model.graph.shape_of(self.ref)

    @property
    def dims(self):
        return self.shape.logical_sizes

    @property
    def dtype(self) -> DataType:
        return self.shape.dtype

    def __repr__(self):
        return f"Tensor(guid={self.ref.guid}, {self.shape})"


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        _ensure_registered()
        self.config = config or FFConfig()
        self.graph = PCGGraph()
        self._name_counts: Dict[str, int] = {}
        self.executor: Optional[Executor] = None
        self.params: Optional[Dict[int, List[torch.Tensor]]] = None
        self.device: Optional[torch.device] = None
        self.optimizer: Optional[Optimizer] = None
        self.opt_state = None
        self._input_order: List[str] = []
        self._perf_metrics: Optional[PerfMetrics] = None
        self._steps = 0  # train steps taken: seeds each step's generators

    # ------------------------------------------------------------------ util

    def _unique_name(self, base: str, name: Optional[str]) -> str:
        if name:
            return name
        n = self._name_counts.get(base, 0)
        self._name_counts[base] = n + 1
        return f"{base}_{n}" if n else base

    def _add(self, op_type, name_base, inputs, params, name=None) -> List[Tensor]:
        name = self._unique_name(name_base, name)
        in_shapes = [self.graph.shape_of(t.ref) for t in inputs]
        outs, weights = infer_shapes(op_type, in_shapes, params)
        node = self.graph.add_node(
            op_type, name, [t.ref for t in inputs], params, outs, weights
        )
        return [Tensor(self, TensorRef(node.guid, i)) for i in range(len(outs))]

    # ----------------------------------------------------------- builders

    def create_tensor(
        self,
        dims: Sequence[int],
        dtype: DataType = DataType.FLOAT,
        name: Optional[str] = None,
    ) -> Tensor:
        """dims in numpy order with dims[0] = batch."""
        name = self._unique_name("input", name)
        shape = ParallelTensorShape.make(tuple(dims), dtype)
        node = self.graph.add_node(
            OperatorType.INPUT, name, [], {"shape": shape}, [shape]
        )
        self._input_order.append(name)
        return Tensor(self, TensorRef(node.guid, 0))

    def dense(
        self,
        input: Tensor,
        out_dim: int,
        activation: ActiMode = ActiMode.NONE,
        use_bias: bool = True,
        kernel_initializer=None,
        bias_initializer=None,
        name: Optional[str] = None,
    ) -> Tensor:
        params = {
            "out_features": out_dim,
            "activation": activation,
            "use_bias": use_bias,
            "initializers": [kernel_initializer, bias_initializer]
            if use_bias
            else [kernel_initializer],
        }
        return self._add(OperatorType.LINEAR, "dense", [input], params, name)[0]

    def layer_norm(
        self,
        input: Tensor,
        axes: Optional[Sequence[int]] = None,
        elementwise_affine: bool = True,
        eps: float = 1e-5,
        name: Optional[str] = None,
    ) -> Tensor:
        ndim = len(input.dims)
        axes = tuple(a % ndim for a in (axes or (ndim - 1,)))
        params = {
            "axes": axes,
            "elementwise_affine": elementwise_affine,
            "eps": eps,
            "initializers": [ConstantInitializer(1.0), None]
            if elementwise_affine
            else None,
        }
        return self._add(OperatorType.LAYERNORM, "layer_norm", [input], params, name)[0]

    def embedding(
        self,
        input: Tensor,
        num_entries: int,
        out_dim: int,
        aggr: AggrMode = AggrMode.NONE,
        dtype: DataType = DataType.FLOAT,
        kernel_initializer=None,
        name: Optional[str] = None,
    ) -> Tensor:
        params = {
            "num_entries": num_entries,
            "out_dim": out_dim,
            "aggr": aggr,
            "dtype": dtype,
            "initializers": [kernel_initializer],
        }
        return self._add(OperatorType.EMBEDDING, "embedding", [input], params, name)[0]

    def multihead_attention(
        self,
        query: Tensor,
        key: Tensor,
        value: Tensor,
        embed_dim: int,
        num_heads: int,
        kdim: int = 0,
        vdim: int = 0,
        dropout: float = 0.0,
        bias: bool = True,
        causal: bool = False,
        name: Optional[str] = None,
    ) -> Tensor:
        params = {
            "embed_dim": embed_dim,
            "num_heads": num_heads,
            "kdim": kdim or embed_dim,
            "vdim": vdim or embed_dim,
            "dropout": dropout,
            "bias": bias,
            "causal": causal,
            # 4 projection kernels (Glorot default) + optional 4 zero biases
            "initializers": [None] * 4 + ([ZeroInitializer()] * 4 if bias else []),
        }
        return self._add(
            OperatorType.MULTIHEAD_ATTENTION,
            "multihead_attention",
            [query, key, value],
            params,
            name,
        )[0]

    def add(self, a: Tensor, b: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add(OperatorType.EW_ADD, "add", [a, b], {}, name)[0]

    # ------------------------------------------------------------- compile

    def compile(
        self,
        optimizer: Optional[Optimizer] = None,
        loss_type: LossType = LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics: Sequence[MetricsType] = (MetricsType.ACCURACY,),
        comp_mode: CompMode = CompMode.TRAINING,
        logits: Optional[Tensor] = None,
        devices=None,
        strategy=None,
        device=None,
    ):
        """Build the executor on one device, initialise the weights and the
        optimizer state (reference: FFModel::compile, the arguments in its
        order, plus `device`). `device=None` means the current CUDA device
        (or the one device of `devices`); without a card that raises (pass
        device='cpu' for the plain PyTorch path). The weights are fp32, so
        TF32 matmuls are switched off on CUDA. With the config's
        allow_mixed_precision the matmuls take bf16 operands with f32
        accumulation (and bf16 outputs), as the reference's; on CUDA
        cuBLAS is then kept from reducing in bf16. Without an optimizer
        it is SGD with the config's learning rate and weight decay, as in
        the reference; `comp_mode` is taken and unused, as there."""
        if strategy is not None:
            raise NotImplementedError(
                "compile(strategy=...): parallel strategies are not ported "
                "yet (ROADMAP, Port queue: multi-GPU training)"
            )
        if devices is not None:
            devices = list(devices)
            if len(devices) != 1:
                raise NotImplementedError(
                    f"compile(devices=...) with {len(devices)} devices: the "
                    "port runs on one device (ROADMAP, Port queue: multi-GPU "
                    "training)"
                )
            if device is None:
                device = devices[0]
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            if self.config.allow_mixed_precision:
                # its default lets cuBLAS reduce a bf16 GEMM in bf16; the
                # reference accumulates in f32
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.optimizer = optimizer or self.optimizer or SGDOptimizer(
            lr=self.config.learning_rate,
            weight_decay=self.config.weight_decay,
        )
        self.loss_type = loss_type
        self.metric_types = tuple(metrics)
        if logits is None:
            sinks = self.graph.sinks()
            if len(sinks) != 1:
                raise ValueError("model has multiple sinks; pass logits= to compile()")
            logits = Tensor(self, TensorRef(sinks[0], 0))
        # the label tensor (reference: model.cc:3072-3110): class indices
        # for the sparse CE loss, else the logits' shape
        logits_shape = self.graph.shape_of(logits.ref)
        dims = [d for d in logits_shape.dims if not d.is_replica_dim]
        if loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            label_shape = ParallelTensorShape(tuple(dims[:-1]), DataType.INT32)
        else:
            label_shape = ParallelTensorShape(tuple(dims), DataType.FLOAT)
        from_logits = self.graph.nodes[logits.ref.guid].op_type != OperatorType.SOFTMAX
        self.device = dev
        self.executor = Executor(
            self.graph,
            logits.ref,
            dev,
            label_shape=label_shape,
            loss_type=loss_type,
            metrics=self.metric_types,
            optimizer=self.optimizer,
            logits_from_logits=from_logits,
            sparse_embedding_update=self.config.sparse_embedding_update,
            mixed_precision=self.config.allow_mixed_precision,
        )
        self.params = self.executor.init_params(self.config.seed)
        self.opt_state = self.optimizer.init_state(self.params)

    # ------------------------------------------------------------- training

    def _next_rng(self) -> int:
        """Seed of the next train step's per-node generators (the
        reference splits its PRNG key once per step)."""
        self._steps += 1
        return self.config.seed * 1_000_003 + self._steps

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(
        self,
        x: Union[Dict[str, np.ndarray], Sequence[np.ndarray], np.ndarray],
        y: np.ndarray,
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        shuffle: bool = False,
        verbose: bool = True,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        callbacks=None,
        telemetry=None,
    ):
        """Training loop (reference: FFModel.fit, flexflow_cffi.py:1916-1958):
        per epoch, every full batch of the loader goes through one train
        step (forward, backward, optimizer update). The first step of the
        run is a warm-up excluded from the throughput (kernel builds, the
        allocator); losses and metrics stay on the device until the
        epoch's end. Prints `epoch N: ...` and `THROUGHPUT = x samples/s`
        per epoch and returns the per-epoch history."""
        if self.executor is None:
            raise RuntimeError("call compile() before fit()")
        for name, arg in (
            ("callbacks", callbacks),
            ("telemetry", telemetry),
            ("checkpoint_dir", checkpoint_dir),
        ):
            if arg:
                raise NotImplementedError(
                    f"fit({name}=...) is not ported yet (ROADMAP, Port queue: "
                    "training op breadth)"
                )
        epochs = epochs or self.config.epochs
        batch_size = batch_size or self.config.batch_size
        loader = SingleDataLoader(self._pack_dataset(x, y), batch_size, shuffle=shuffle)
        step = self.executor.train_step()
        history = []
        warm = False
        for epoch in range(epochs):
            perf = PerfMetrics()
            loader.reset()
            t0 = time.perf_counter()
            samples = 0
            step_results = []
            for it in range(loader.num_batches):
                np_batch = loader.next_batch()
                batch = self.executor.shard_batch(np_batch)
                self.params, self.opt_state, loss, mets = step(
                    self.params, self.opt_state, batch, self._next_rng()
                )
                if not warm:
                    self._sync()
                    t0 = time.perf_counter()
                    warm = True
                else:
                    samples += len(next(iter(np_batch.values())))
                step_results.append((loss, mets))
                pf = self.config.print_freq
                if verbose and pf > 0 and (it + 1) % pf == 0:
                    print(f"iter {it + 1}/{loader.num_batches}: loss = {float(loss):.4f}")
            self._sync()
            elapsed = time.perf_counter() - t0
            for loss, mets in step_results:
                perf.update({k: float(v) for k, v in mets.items()}, float(loss))
            self._perf_metrics = perf
            thpt = samples / elapsed if elapsed > 0 else 0.0
            history.append({"epoch": epoch, "throughput": thpt, **perf.__dict__})
            if verbose:
                print(f"epoch {epoch}: {perf.report()}")
                print(f"THROUGHPUT = {thpt:.2f} samples/s")
        return history

    def evaluate(self, x, y, batch_size: Optional[int] = None, callbacks=None):
        """Loss and metrics over every full batch, no update."""
        if self.executor is None:
            raise RuntimeError("call compile() before evaluate()")
        if callbacks:
            raise NotImplementedError("evaluate(callbacks=...) is not ported yet")
        loader = SingleDataLoader(
            self._pack_dataset(x, y), batch_size or self.config.batch_size
        )
        estep = self.executor.eval_step()
        perf = PerfMetrics()
        for batch in loader:
            loss, mets = estep(self.params, self.executor.shard_batch(batch))
            perf.update({k: float(v) for k, v in mets.items()}, float(loss))
        self._perf_metrics = perf
        return perf

    def get_perf_metrics(self) -> PerfMetrics:
        """Most recent epoch's (or evaluation's) accumulated metrics."""
        return self._perf_metrics if self._perf_metrics is not None else PerfMetrics()

    def compute_gradients(self, x, y) -> Dict[int, list]:
        """Per-parameter loss gradients for one batch, as host arrays keyed
        like `params` ({guid: [grad per weight]}); rng-free, train=False."""
        if self.executor is None:
            raise RuntimeError("call compile() before compute_gradients()")
        batch = self.executor.shard_batch(self._pack_dataset(x, y))
        grads = self.executor.grad_fn()(self.params, batch)
        return {g: [t.detach().cpu().numpy() for t in gs] for g, gs in grads.items()}

    def _pack_dataset(self, x, y) -> Dict[str, np.ndarray]:
        """{input name: array} plus "label", each input cast to its
        declared dtype."""
        if isinstance(x, dict):
            arrays = dict(x)
        else:
            xs = list(x) if isinstance(x, (list, tuple)) else [x]
            if len(xs) != len(self._input_order):
                raise ValueError(
                    f"model has {len(self._input_order)} inputs, got {len(xs)}"
                )
            arrays = dict(zip(self._input_order, xs))
        shapes = self.executor.input_shapes()
        for name, arr in arrays.items():
            want = shapes.get(name)
            if want is None or want.dtype.value not in (
                "float32", "int32", "int64", "float64", "bool",
            ):
                continue
            np_dt = np.dtype(want.dtype.value)
            if getattr(arr, "dtype", None) != np_dt:
                arrays[name] = np.asarray(arr).astype(np_dt)
        arrays["label"] = y
        return arrays

    # ----------------------------------------------------------- inference

    def forward(self, batch) -> torch.Tensor:
        """Full forward of the compiled graph: {input name: array} ->
        logits on the model's device (no cache; the serving oracle)."""
        if self.executor is None:
            raise RuntimeError("call compile() before forward()")
        with torch.inference_mode():
            return self.executor.logits(self.params, batch)

    def generate(
        self,
        prompts,
        max_new_tokens: int = 16,
        serve_config=None,
        eos_token=None,
        draft_model=None,
    ):
        """Greedy autoregressive generation with continuous batching over
        a paged KV cache (serving/api.py): token-id prompts in, generated
        token lists out. The model must be compiled, take a single int
        token input and use causal self-attention. `draft_model` supplies
        the small draft LM when serve_config.spec_draft is "model"."""
        from flexflow_tpu_torch.serving.api import ServeConfig, generate

        if self.executor is None:
            raise RuntimeError("call compile() before generate()")
        if serve_config is None:
            serve_config = ServeConfig.from_config(self.config)
        return generate(
            self,
            prompts,
            max_new_tokens=max_new_tokens,
            serve=serve_config,
            eos_token=eos_token,
            draft_model=draft_model,
        )
