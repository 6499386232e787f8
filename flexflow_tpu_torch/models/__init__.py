"""Model builders."""

from flexflow_tpu_torch.models.nlp import build_decoder_lm

__all__ = ["build_decoder_lm"]
