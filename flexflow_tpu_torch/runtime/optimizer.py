"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam (port of
the dense half of flexflow_tpu/runtime/optimizer.py; reference:
src/runtime/optimizer.cc, optimizer_kernel.cu:88,196).

The update rules are the reference's exactly:
  SGD   g' = g + wd*w; v = momentum*v + g';
        w -= lr * (nesterov ? g' + momentum*v : v)   (v = g' without momentum)
  Adam  alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t);
        m = beta1*m + (1-beta1)*g'; v = beta2*v + (1-beta2)*g'^2;
        w -= alpha_t * m / (sqrt(v) + eps)

Parameters and state are `{guid: [tensor, ...]}` trees, with the state's
scalar "step" a Python int. Unlike the reference's pure functions,
`update` writes the new weights and moments IN PLACE under
`torch.no_grad()` (no second copy of the model per step) and returns the
same objects. The touched-rows update for embedding tables
(`sparse_row_update`) is not ported (ROADMAP, lazy sparse-embedding
update).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _zeros_like_tree(params):
    return {g: [torch.zeros_like(w, requires_grad=False) for w in ws] for g, ws in params.items()}


def _triples(params, grads, *states):
    for g, ws in params.items():
        for i, w in enumerate(ws):
            yield (w, grads[g][i]) + tuple(s[g][i] for s in states)


class Optimizer:
    def init_state(self, params):
        raise NotImplementedError

    def update(self, params, grads, state):
        """Apply one step in place; returns (params, state)."""
        raise NotImplementedError

    def has_state(self) -> bool:
        """Whether the update keeps per-weight state (moments) or decays
        weights: then a dense update of an embedding table differs from
        the reference's lazy touched-rows update."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SGDOptimizer(Optimizer):
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init_state(self, params):
        if self.momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "velocity": _zeros_like_tree(params)}

    def has_state(self) -> bool:
        return self.momentum != 0.0 or self.weight_decay != 0.0

    @torch.no_grad()
    def update(self, params, grads, state):
        wd = self.weight_decay
        if self.momentum == 0.0:
            for w, g in _triples(params, grads):
                w.sub_(self.lr * (g + wd * w))
            return params, {"step": state["step"] + 1}
        for w, g, v in _triples(params, grads, state["velocity"]):
            g = g + wd * w
            v.mul_(self.momentum).add_(g)
            step = g + self.momentum * v if self.nesterov else v
            w.sub_(self.lr * step)
        return params, {"step": state["step"] + 1, "velocity": state["velocity"]}


@dataclasses.dataclass(frozen=True)
class AdamOptimizer(Optimizer):
    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"step": 0, "m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}

    def has_state(self) -> bool:
        return True

    @torch.no_grad()
    def update(self, params, grads, state):
        step = state["step"] + 1
        alpha_t = (
            self.alpha
            * math.sqrt(1.0 - self.beta2 ** step)
            / (1.0 - self.beta1 ** step)
        )
        for w, g, m, v in _triples(params, grads, state["m"], state["v"]):
            g = g + self.weight_decay * w
            m.mul_(self.beta1).add_((1 - self.beta1) * g)
            v.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
            w.sub_(alpha_t * m / (torch.sqrt(v) + self.epsilon))
        return params, {"step": step, "m": state["m"], "v": state["v"]}
