"""FFModel: the layer builder, compile() and generate() (port of the
serving-path part of flexflow_tpu/runtime/model.py).

The builder records PCG nodes exactly as the reference does — same op
types, params and guids in build order — so the same builder calls give
the same graph in both packages. `compile()` places the model on one
`torch.device` (CUDA unless the caller asks for the CPU) and initialises
its weights from the config's seed. Training (`fit`, optimizers,
losses), strategies and search are not ported yet (ROADMAP, Port queue).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.core.pcg import PCGGraph, TensorRef
from flexflow_tpu_torch.core.types import ActiMode, AggrMode, DataType, OperatorType
from flexflow_tpu_torch.ops.registry import _ensure_registered, infer_shapes
from flexflow_tpu_torch.runtime.executor import Executor
from flexflow_tpu_torch.runtime.initializer import ConstantInitializer, ZeroInitializer


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
        logits: Optional[Tensor] = None,
        device=None,
        optimizer=None,
        loss_type=None,
    ):
        """Place the model on one device and initialise its weights.
        `device=None` means the current CUDA device; without a card that
        raises (pass device='cpu' for the plain PyTorch path). The model
        is fp32 end to end, so TF32 matmuls are switched off on CUDA."""
        if optimizer is not None or loss_type is not None:
            raise NotImplementedError(
                "compile() for training is not ported yet (ROADMAP, Port "
                "queue: slice 2, training)"
            )
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if logits is None:
            sinks = self.graph.sinks()
            if len(sinks) != 1:
                raise ValueError("model has multiple sinks; pass logits= to compile()")
            logits = Tensor(self, TensorRef(sinks[0], 0))
        self.device = dev
        self.executor = Executor(self.graph, logits.ref, dev)
        self.params = self.executor.init_params(self.config.seed)

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
    ):
        """Greedy autoregressive generation with continuous batching over
        a paged KV cache (serving/api.py): token-id prompts in, generated
        token lists out. The model must be compiled, take a single int
        token input and use causal self-attention."""
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
        )
