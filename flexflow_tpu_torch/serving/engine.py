"""Prefill + single-token decode over a compiled FFModel (port of the
prefill/decode part of flexflow_tpu/serving/engine.py).

The engine re-executes the model's PCG through `Executor.forward_values`
with one op hook, MULTIHEAD_ATTENTION. The hook computes the exact
projections of the full forward (ops/attention.mha_project_qkv /
mha_project_out) and swaps only the attention core:

  * **prefill**: causal attention over the (bucket-padded) prompts,
    exactly the full forward, writing each layer's K/V rows into the
    admitted slots' cache rows. The last prompt position's logits give
    the first generated token.
  * **decode**: one query position per slot. The new K/V row is written
    at `lengths[slot]` for active slots only, then the decode kernel
    (ops/attention.decode_attention / paged_decode_attention, which
    reach the CUDA kernels of ops/cuda/decode_kernel.py) attends over
    the cache.

Both cache layouts are served by the same hooks: the paged steps route
rows through the slot's block table, and `decode()` claims a sequence's
next page before the step when it is about to cross a page boundary.
Every write destination is computed and masked on the host — torch
raises on an out-of-bounds index, where the reference relied on JAX
dropping out-of-bounds scatter rows. All host-built index tensors of a
step travel to the device in one int32 copy.

Greedy argmax picks tokens. The reference's kernel-failure handler,
which switched the engine to dense attention for good after any kernel
error, is deliberately absent: a failing kernel raises. Speculative
verify, chunked prefill, multi-step decode, token trees, adapters and
int8 pools are not ported yet (ROADMAP, Port queue: serving features).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.core.types import OperatorType
from flexflow_tpu_torch.ops.attention import (
    check_mode,
    decode_attention,
    mha_project_out,
    mha_project_qkv,
    paged_decode_attention,
    scaled_dot_product_attention,
)


def _to_device(device, parts: Sequence[np.ndarray]):
    """Copy host int arrays to `device` in one int32 transfer; returns a
    device view per part, shaped like it."""
    flat = np.concatenate([np.asarray(p, dtype=np.int32).ravel() for p in parts])
    buf = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for p in parts:
        n = int(np.prod(np.shape(p), dtype=np.int64))
        out.append(buf[off:off + n].view(np.shape(p)))
        off += n
    return out


class GenerationEngine:
    """Step functions over (params, cache); scheduling lives in
    serving.scheduler."""

    def __init__(self, model, cache, decode_kernel: str = "auto"):
        if model.executor is None:
            raise RuntimeError("compile() the model before serving")
        check_mode(decode_kernel)
        self.model = model
        self.executor = model.executor
        self.cache = cache
        self.device = model.device
        self.decode_kernel = decode_kernel
        graph = model.graph
        inputs = self.executor.input_nodes()
        if len(inputs) != 1:
            raise ValueError(
                "serving needs a single token-id input tensor, model has "
                f"{len(inputs)} inputs"
            )
        self.input_name = graph.nodes[inputs[0]].name
        for g in cache.spec.layer_guids:
            node = graph.nodes[g]
            if not node.params.get("causal", False):
                raise ValueError(
                    f"attention node '{node.name}' is not causal; "
                    "autoregressive serving needs causal=True"
                )
            if len({(r.guid, r.out_idx) for r in node.inputs}) != 1:
                raise ValueError(
                    f"attention node '{node.name}' is cross-attention; "
                    "the KV-cache engine supports self-attention only"
                )
        self.paged = bool(getattr(cache, "paged", False))

    def _forward_logits(self, params, tokens, hook) -> torch.Tensor:
        return self.executor.logits(
            params,
            {self.input_name: tokens},
            op_hooks={OperatorType.MULTIHEAD_ATTENTION: hook},
        )

    @staticmethod
    def _pick(logits: torch.Tensor) -> np.ndarray:
        """Greedy: logits [n, vocab] -> token ids [n] on the host."""
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    # -- prefill -------------------------------------------------------------

    @torch.no_grad()
    def prefill(
        self,
        params,
        prompts: Sequence[Sequence[int]],
        slots: Sequence[int],
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Run one admission batch: write the prompts' K/V rows into their
        slots and set the slots' lengths. Returns (next_tokens [n] on the
        host, last-position logits [n, V] on the device)."""
        spec = self.cache.spec
        n = len(prompts)
        if n == 0:
            raise ValueError("prefill needs at least one prompt")
        if n > spec.max_seqs:
            raise ValueError(f"{n} prompts > max_seqs {spec.max_seqs}")
        bucket = spec.bucket(max(len(p) for p in prompts))
        tokens = np.zeros((n, bucket), dtype=np.int32)
        plens = np.zeros(n, dtype=np.int32)
        for i, p in enumerate(prompts):
            if not 0 < len(p) <= spec.max_len:
                raise ValueError(f"prompt length {len(p)} outside (0, {spec.max_len}]")
            tokens[i, : len(p)] = np.asarray(p, dtype=np.int32)
            plens[i] = len(p)
        slots_np = np.asarray(slots, dtype=np.int32)
        if self.paged:
            ps = spec.page_size
            pos = np.arange(bucket)
            pages = self.cache.block_tables[slots_np][:, pos // ps]  # [n, bucket]
            # bucket padding past a prompt's allocated pages is not written
            real = pages != spec.num_pages
            dest = (pages * ps + pos % ps)[real]
            tok_t, last_t, real_t, dest_t = _to_device(
                self.device, [tokens, plens - 1, real, dest]
            )
            real_t = real_t.bool()
        else:
            tok_t, last_t, slots_t, pos_t = _to_device(
                self.device, [tokens, plens - 1, slots_np, np.arange(bucket)]
            )
        cache = self.cache

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            if self.paged:
                cache.commit(g, dest_t, k[real_t], v[real_t])
            else:
                cache.commit(g, slots_t[:, None], pos_t[None, :], k, v)
            attn = scaled_dot_product_attention(q, k, v, causal=True)
            return [mha_project_out(attn, ws, ctx, use_bias=use_bias)]

        logits = self._forward_logits(params, tok_t, hook)
        last = logits[torch.arange(n, device=self.device), last_t.long()]
        nxt = self._pick(last)
        for p, s in zip(prompts, slots):
            cache.lengths[s] = len(p)
        return nxt, last

    # -- decode --------------------------------------------------------------

    @torch.no_grad()
    def decode(
        self,
        params,
        tokens: np.ndarray,
        active_mask: np.ndarray,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """One decode iteration over every slot: writes each active
        slot's new K/V row at its length, bumps active lengths. tokens
        [max_seqs] is the last emitted token per slot (free slots carry
        anything). Returns (next_tokens [max_seqs] on the host, logits
        [max_seqs, V] on the device)."""
        spec = self.cache.spec
        cache = self.cache
        active = np.asarray(active_mask, dtype=bool)
        idx = np.nonzero(active)[0]
        if self.paged:
            # claim the next page for any sequence about to cross a page
            # boundary BEFORE the step (the admission reserve guarantees it)
            for slot in idx:
                cache.ensure_position(int(slot), int(cache.lengths[slot]))
        lengths = cache.lengths.copy()
        host = [np.asarray(tokens, dtype=np.int32)[:, None], lengths, idx]
        if self.paged:
            ps = spec.page_size
            pos = lengths[idx]
            host += [cache.block_tables[idx, pos // ps] * ps + pos % ps, cache.block_tables]
            tok_t, len_t, idx_t, dest_t, tables_t = _to_device(self.device, host)
        else:
            tok_t, len_t, idx_t, pos_t = _to_device(self.device, host + [lengths[idx]])

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            if self.paged:
                cache.commit(g, dest_t, k[idx_t, 0], v[idx_t, 0])
                attn = paged_decode_attention(
                    q, cache.k[g], cache.v[g], tables_t, len_t, kernel=self.decode_kernel
                )
            else:
                cache.commit(g, idx_t, pos_t, k[idx_t, 0], v[idx_t, 0])
                attn = decode_attention(
                    q, cache.k[g], cache.v[g], len_t, kernel=self.decode_kernel
                )
            return [mha_project_out(attn, ws, ctx, use_bias=use_bias)]

        logits = self._forward_logits(params, tok_t, hook)[:, -1, :]
        nxt = self._pick(logits)
        cache.lengths[active] += 1
        return nxt, logits
