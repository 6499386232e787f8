"""NLP workloads (port of flexflow_tpu/models/nlp.py: the Transformer
encoder the flagship benchmark trains and the decoder LM the serving
path runs)."""

from __future__ import annotations

from flexflow_tpu_torch.core.types import ActiMode


def build_transformer_encoder(
    ff,
    input_tensor,
    hidden: int = 1024,
    num_heads: int = 16,
    num_layers: int = 12,
    dropout: float = 0.0,
):
    """reference: examples/cpp/Transformer/transformer.cc:33-45 — per layer:
    MHA then dense(relu)+dense, no residuals/LN in the reference benchmark;
    final dense(1). The same calls as the reference builder, so both
    packages give the same graph and guids."""
    t = input_tensor
    for _ in range(num_layers):
        t = ff.multihead_attention(t, t, t, hidden, num_heads, dropout=dropout,
                                   bias=False)
        t = ff.dense(t, hidden, activation=ActiMode.RELU, use_bias=False)
        t = ff.dense(t, hidden, use_bias=False)
    return ff.dense(t, 1, use_bias=False)


def build_decoder_lm(
    ff,
    token_ids,
    vocab_size: int = 256,
    hidden: int = 64,
    num_heads: int = 4,
    num_layers: int = 2,
    ff_dim: int = 128,
):
    """Decoder-only LM: GPT-style pre-LN blocks with causal
    self-attention, ending in vocab logits (no softmax). The same calls
    as the reference builder, so both packages give the same graph and
    guids."""
    t = ff.embedding(token_ids, vocab_size, hidden)
    for _ in range(num_layers):
        h = ff.layer_norm(t)
        a = ff.multihead_attention(
            h, h, h, hidden, num_heads, bias=False, causal=True
        )
        t = ff.add(t, a)
        h = ff.layer_norm(t)
        m = ff.dense(h, ff_dim, activation=ActiMode.GELU, use_bias=False)
        m = ff.dense(m, hidden, use_bias=False)
        t = ff.add(t, m)
    return ff.dense(ff.layer_norm(t), vocab_size, use_bias=False)
