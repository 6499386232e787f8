"""Training metrics (port of flexflow_tpu/runtime/metrics.py; reference:
src/metrics_functions/). Per-batch metrics are summed on the device and
the host accumulates them in a PerfMetrics counter."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from flexflow_tpu_torch.core.types import MetricsType


def compute_metrics(
    metric_types: Sequence[MetricsType], logits, labels, from_logits: bool = False
) -> Dict[str, torch.Tensor]:
    """Summed (not averaged) per-batch metric values and the sample count,
    so the host accumulates exactly like PerfMetrics
    (metrics_functions.h:12-28). from_logits: CE metrics go through
    log_softmax instead of log(probs), as compute_loss does."""
    out = {}
    n = logits.shape[0] if logits.dim() > 0 else 1
    out["num_samples"] = torch.tensor(float(n), device=logits.device)

    if labels.dim() == logits.dim() and labels.shape[-1] == 1 and logits.shape[-1] != 1:
        # reference label tensors are [batch, 1] sparse class indices
        labels = labels[..., 0]

    def _logp():
        x = logits.float()
        if from_logits:
            return torch.log_softmax(x, dim=-1)
        return torch.log(torch.clamp(x, 1e-12, 1.0))

    for mt in metric_types:
        if mt == MetricsType.ACCURACY:
            if labels.dim() == logits.dim():  # one-hot
                correct = logits.argmax(-1) == labels.argmax(-1)
            else:
                correct = logits.argmax(-1) == labels.long()
            out["accuracy_sum"] = correct.float().sum()
        elif mt == MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
            logp = torch.gather(_logp(), -1, labels.long()[..., None])
            out["ce_sum"] = out.get("ce_sum", 0.0) + (-logp.sum())
        elif mt == MetricsType.CATEGORICAL_CROSSENTROPY:
            out["ce_sum"] = out.get("ce_sum", 0.0) + (-(labels * _logp()).sum())
        elif mt == MetricsType.MEAN_SQUARED_ERROR:
            out["mse_sum"] = torch.square(logits.float() - labels).sum()
        elif mt == MetricsType.ROOT_MEAN_SQUARED_ERROR:
            out["rmse_sum"] = torch.sqrt(torch.square(logits.float() - labels).mean()) * n
        elif mt == MetricsType.MEAN_ABSOLUTE_ERROR:
            out["mae_sum"] = torch.abs(logits.float() - labels).sum()
    return out


@dataclasses.dataclass
class PerfMetrics:
    """Host-side accumulator (reference: metrics_functions.h:12-28)."""

    train_all: int = 0
    train_correct: float = 0.0
    ce_loss: float = 0.0
    mse_loss: float = 0.0
    mae_loss: float = 0.0
    loss_sum: float = 0.0
    iterations: int = 0

    def update(self, step_metrics: Dict[str, float], loss: float):
        n = int(step_metrics.get("num_samples", 0))
        self.train_all += n
        self.train_correct += float(step_metrics.get("accuracy_sum", 0.0))
        self.ce_loss += float(step_metrics.get("ce_sum", 0.0))
        self.mse_loss += float(step_metrics.get("mse_sum", 0.0))
        self.mae_loss += float(step_metrics.get("mae_sum", 0.0))
        self.loss_sum += float(loss) * max(n, 1)
        self.iterations += 1

    def get_accuracy(self) -> float:
        """Training accuracy in percent."""
        return 100.0 * self.train_correct / max(self.train_all, 1)

    def report(self) -> str:
        n = max(self.train_all, 1)
        parts = [f"loss: {self.loss_sum / n:.4f}"]
        if self.train_correct:
            parts.append(
                f"accuracy: {self.get_accuracy():.2f}%"
                f" ({int(self.train_correct)} / {n})"
            )
        if self.ce_loss:
            parts.append(f"ce: {self.ce_loss / n:.4f}")
        if self.mse_loss:
            parts.append(f"mse: {self.mse_loss / n:.4f}")
        return " ".join(parts)
