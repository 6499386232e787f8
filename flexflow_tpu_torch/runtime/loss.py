"""Loss functions (port of flexflow_tpu/runtime/loss.py; reference:
src/loss_functions/loss_functions.cc:39-100). Losses are scalar functions
of (logits, labels) and torch.autograd produces the gradient seeds."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.core.types import LossType


def _log_probs(logits, from_logits):
    x = logits.float()
    if from_logits:
        return torch.log_softmax(x, dim=-1)
    return torch.log(torch.clamp(x, 1e-12, 1.0))


def compute_loss(loss_type: LossType, logits, labels, from_logits=True):
    """`from_logits=False` when the graph's final op is already a Softmax
    (the reference's CE losses consume softmax probabilities)."""
    if loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        logp = _log_probs(logits, from_logits)
        if labels.dim() == logits.dim() and labels.shape[-1] == 1:
            # the reference's label tensor is [batch, 1]: squeeze to
            # index form
            labels = labels[..., 0]
        ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        return -ll.mean()
    if loss_type == LossType.CATEGORICAL_CROSSENTROPY:
        return -(labels * _log_probs(logits, from_logits)).sum(dim=-1).mean()
    if loss_type == LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
        return torch.square(logits.float() - labels).mean()
    if loss_type == LossType.MEAN_SQUARED_ERROR_SUM_REDUCE:
        # the reference scales grads by 2/volume but sums over the class dim
        return torch.square(logits.float() - labels).sum(dim=-1).mean()
    if loss_type == LossType.IDENTITY:
        return logits.float().mean()
    raise ValueError(f"unknown loss {loss_type}")
