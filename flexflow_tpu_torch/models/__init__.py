"""Model builders."""

from flexflow_tpu_torch.models.nlp import build_decoder_lm, build_transformer_encoder

__all__ = ["build_decoder_lm", "build_transformer_encoder"]
