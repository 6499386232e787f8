"""Prefill, single-token decode and speculative verify over a compiled
FFModel (port of the synchronous step functions of
flexflow_tpu/serving/engine.py).

The engine re-executes the model's PCG through `Executor.forward_values`
with one op hook, MULTIHEAD_ATTENTION. The hook computes the exact
projections of the full forward (ops/attention.mha_project_qkv /
mha_project_out) and swaps only the attention core:

  * **prefill**: causal attention over the (bucket-padded) prompts,
    exactly the full forward, writing each layer's K/V rows into the
    admitted slots' cache rows. The last prompt position's logits give
    the first generated token. On int8 pools the prompts attend over
    the int8 round trip of their own rows, which is what later steps
    read back from the pool.
  * **decode**: one query position per slot, through `_decode_core`, a
    fixed-shape [max_seqs, 1] step whose inputs all live on the device
    (tokens, lengths, alive, per-slot step limits, EOS ids, a step
    index and a block-table snapshot). It computes each slot's write
    destination from the carried lengths on the device (dead and masked
    rows go to the cache's scratch row), writes the K/V rows (int8
    included), runs the layers with the decode kernel
    (ops/attention.decode_attention / paged_decode_attention, which
    reach the CUDA kernels of ops/cuda/decode_kernel.py), takes the
    greedy argmax and carries lengths / tokens / alive forward as the
    reference's scan body does, writing tokens, logits, mask and a
    finite flag into per-step stacks. `decode` runs it once; the
    multi-step window `decode_multi` runs it k times and reads the host
    once, so fused and one-at-a-time decode are identical by
    construction. On the card a window is replays of one captured CUDA
    graph of the core (`_GraphWindow`); on the CPU the core runs
    eagerly k times.
  * **verify** / **verify_tree**: w query positions per slot (the last
    emitted token and its draft, a chain or a token tree), all w K/V
    rows written at lengths[slot] + j, attention under the staircase or
    the tree mask (built once per step from the parent table). Lengths
    do not move: the scheduler accepts a prefix and commits it with
    cache.truncate.

Under allow_mixed_precision the projections hand the hooks bf16 q, k
and v, and the logits come out bf16: the K/V rows go into the fp32 pools
cast to the pool's dtype (int8 pools quantize their f32 values), the
decode kernels take bf16 q against the fp32 or int8 pools and return
bf16 (ops/cuda/decode_kernel.py), greedy argmax takes the first maximal
bf16 logit, as jnp.argmax does, and verify logits reach the host as
float32.

Both cache layouts are served by the same hooks: the paged steps route
rows through the slot's block table and claim a sequence's pages before
the step. int8 paged pools are written by `_quant_scatter` (prefill and
verify, with a host plan) or `_quant_write` (the decode core, on the
device): one fp32 scale per page and head, claimed from the page's
first row. Prefill and verify compute and mask every write destination
on the host — torch raises on an out-of-bounds index, where the
reference relied on JAX dropping out-of-bounds scatter rows — and the
decode core routes what the reference dropped to the scratch row. All
host-built index tensors of a step travel to the device in one int32
copy.

Greedy argmax picks tokens. The reference's kernel-failure handler,
which switched the engine to dense attention for good after any kernel
error, is deliberately absent: a failing kernel, capture or replay
raises, and nothing on the card falls back to eager steps. Sampling,
chunked prefill, adapters and the async dispatch / reconcile split are
not ported yet (ROADMAP, Port queue: serving features).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.core.types import OperatorType
from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
from flexflow_tpu_torch.ops.attention import (
    check_mode,
    decode_attention,
    mha_project_out,
    mha_project_qkv,
    paged_decode_attention,
    paged_verify_attention,
    scaled_dot_product_attention,
    tree_allowed_mask,
    verify_attention,
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


def quant_plan(dest: np.ndarray, page_size: int):
    """Host half of an int8 write to flat pool rows `dest` [N]: (dest,
    each row's page, the indices of the rows that land on a page's first
    row, and those rows' pages) — the operands of _quant_scatter."""
    dest = np.asarray(dest, dtype=np.int64)
    first = np.nonzero(dest % page_size == 0)[0]
    return [dest, dest // page_size, first, dest[first] // page_size]


class _CoreState:
    """The decode core's device tensors. The inputs are views of one
    int32 buffer `inp`, [tokens | lengths | alive | limits | eos | step |
    block tables], so a window's host inputs reach the device in one
    copy; the per-step stacks tokens / mask / finite are views of one
    int32 buffer `out` [steps, 3, max_seqs], so the host reads them in
    one copy, and `logits` [steps, max_seqs, V] stays on the device."""

    def __init__(self, max_seqs: int, table_cols: int, steps: int, device):
        S = max_seqs
        self.steps = steps
        # every run loads all of `inp` first and reads `out` only at the
        # steps it ran, so neither needs zeroing
        self.inp = torch.empty(5 * S + 1 + S * table_cols, dtype=torch.int32, device=device)
        self.tokens, self.lengths, self.alive, self.limits, self.eos = self.inp[: 5 * S].view(5, S)
        self.step = self.inp[5 * S]
        self.tables = self.inp[5 * S + 1:].view(S, table_cols) if table_cols else None
        self.out = torch.empty((steps, 3, S), dtype=torch.int32, device=device)
        self.logits: Optional[torch.Tensor] = None  # made at the first step, when V is known


@dataclasses.dataclass
class _GraphWindow:
    """One captured CUDA graph of the decode core over static state, and
    the decode-kernel launches one replay makes (counted into
    decode_kernel.LAUNCHES after each replay: the wrappers count only
    when their Python runs, which for a graph is once, at capture).
    `weights` are the parameters' addresses the graph was captured
    over; other weights are captured anew in its place."""

    state: _CoreState
    stream: "torch.cuda.Stream"
    weights: Tuple[int, ...]
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Optional[Dict[str, int]] = None


class GenerationEngine:
    """Step functions over (params, cache); scheduling lives in
    serving.scheduler. `max_fused_steps` is the deepest decode_multi
    window (the depth of the captured graph's per-step stacks)."""

    def __init__(self, model, cache, decode_kernel: str = "auto", max_fused_steps: int = 8):
        if model.executor is None:
            raise RuntimeError("compile() the model before serving")
        check_mode(decode_kernel)
        if max_fused_steps < 1:
            raise ValueError(f"max_fused_steps must be >= 1, got {max_fused_steps}")
        self.model = model
        self.executor = model.executor
        self.cache = cache
        self.device = model.device
        self.decode_kernel = decode_kernel
        self.max_fused_steps = int(max_fused_steps)
        # captured windows by (layout, kv_dtype, max_seqs): one engine
        # serves one cache, so at most one entry
        self._graphs: Dict[tuple, _GraphWindow] = {}
        # [k, max_seqs] bool: the last window's finite-logits flags, read
        # in the same host copy as its tokens and mask
        self.window_finite: Optional[np.ndarray] = None
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
        self.quantized = bool(getattr(cache, "quantized", False))

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

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """[..., heads, head_dim] -> [N, heads, head_dim]."""
        spec = self.cache.spec
        return t.reshape(-1, spec.num_heads, spec.head_dim)

    # -- int8 pool writes ----------------------------------------------------

    def _quant_scatter(self, pool, scale, rows, dest, page, claim_rows, claim_pages, round_trip=False):
        """Quantize `rows` [N, heads, head_dim] into the int8 `pool` at
        flat rows `dest` [N] (every one a real page), in place, with the
        host-built operands of quant_plan. A page's fp32 scale comes from
        the abs-max of its FIRST row / 127 and is re-derived whenever a
        batch writes that row (a freed page keeps a stale scale on the
        device, and a reallocated page must quantize from its new
        content); other rows reuse the stored scale and clip at
        ±127·scale. torch.round rounds half to even, as jnp.round does.
        With `round_trip`, returns the dequantized rows (scales are never
        negative, so a scale-0 page gives zeros): what a later pool
        reader will see, for callers (prefill) whose attention must read
        the same."""
        f32 = rows.float()
        if claim_rows.numel():  # a shape, known on the host: no device sync
            scale[claim_pages] = f32[claim_rows].abs().amax(dim=-1) / 127.0
        s = scale[page]  # [N, heads]
        safe = torch.where(s > 0, s, 1.0)
        q = (f32 / safe[:, :, None]).round_().clamp_(-127, 127).to(torch.int8)
        spec = self.cache.spec
        pool.view(-1, spec.num_heads, spec.head_dim)[dest] = q
        return q.float() * s[:, :, None] if round_trip else None

    def _write(self, g, k_rows, v_rows, dest_parts, round_trip=False):
        """Write one layer's new K/V rows into the cache: dest_parts is
        (slots, positions) on the slot layout, (dest,) on fp32 pools and
        quant_plan's four operands on int8 pools. With `round_trip` on
        int8 pools, returns the rows as the pool now holds them."""
        cache = self.cache
        if not self.quantized:
            cache.commit(g, *dest_parts, k_rows, v_rows)
            return None
        return tuple(
            self._quant_scatter(pool[g], scale[g], rows, *dest_parts, round_trip=round_trip)
            for pool, scale, rows in ((cache.k, cache.k_scale, k_rows), (cache.v, cache.v_scale, v_rows))
        )

    def _scales(self, g):
        if not self.quantized:
            return {}
        return dict(k_scale=self.cache.k_scale[g], v_scale=self.cache.v_scale[g])

    def _quant_write(self, pool, scale, rows, dest):
        """Device half of the decode core's int8 write: quantize `rows`
        [N, heads, head_dim] into the whole int8 pool `pool` (scratch page
        included) at flat rows `dest` [N], one row per slot, dead rows at
        the scratch page's. Every row re-derives its page's scale with
        torch.where (abs-max / 127 where it is the page's first row, the
        stored scale elsewhere) and writes it back, with no host branch;
        the values are _quant_scatter's."""
        spec = self.cache.spec
        f32 = rows.float()
        page = dest // spec.page_size
        first = (dest % spec.page_size == 0)[:, None]
        s = torch.where(first, f32.abs().amax(dim=-1) / 127.0, scale[page])
        scale[page] = s
        safe = torch.where(s > 0, s, 1.0)
        q = (f32 / safe[:, :, None]).round_().clamp_(-127, 127).to(torch.int8)
        pool.view(-1, spec.num_heads, spec.head_dim)[dest] = q

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
            parts = quant_plan(dest, ps) if self.quantized else [dest]
            tok_t, last_t, real_t, *dest_t = _to_device(
                self.device, [tokens, plens - 1, np.nonzero(real.ravel())[0]] + parts
            )
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
                kf, vf = self._rows(k), self._rows(v)
                trip = self._write(g, kf[real_t], vf[real_t], dest_t, round_trip=True)
                if trip is not None:
                    # attend over the int8 round trip, as later steps
                    # will, in the projections' dtype (bf16 under mixed
                    # precision, as the reference's k_deq.astype(k.dtype))
                    kf[real_t], vf[real_t] = trip[0].to(kf.dtype), trip[1].to(vf.dtype)
                    k, v = kf.view(k.shape), vf.view(v.shape)
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

    def _decode_core(self, params, st: _CoreState) -> None:
        """One fixed-shape decode step on the device, with no host read:
        each slot with alive & (step < limits) writes its K/V row at its
        carried length (through the table snapshot on the paged layout;
        every other row at the scratch row), attends, and takes the greedy
        argmax; EOS clears alive, and lengths / tokens move for the active
        slots only (the reference's scan body). Writes tokens, mask and
        the finite flag into st.out[step], the logits into
        st.logits[step], then advances st.step. The same core runs under
        a CUDA graph capture, so everything here stays on the device."""
        spec = self.cache.spec
        cache = self.cache
        lens = st.lengths
        act = (st.alive != 0) & (st.step < st.limits)
        if self.paged:
            ps = spec.page_size
            pidx = (lens // ps).clamp(max=spec.max_pages_per_seq - 1).long()
            page = st.tables.gather(1, pidx[:, None])[:, 0].long()
            dest = page * ps + (lens % ps).long()
        else:
            dest = torch.arange(spec.max_seqs, device=lens.device) * spec.max_len + lens.long()
        dest = torch.where(act, dest, cache.scratch_row)

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            if self.quantized:
                for store, scale, rows in ((cache.k_store, cache.k_scale_store, k),
                                           (cache.v_store, cache.v_scale_store, v)):
                    self._quant_write(store[g], scale[g], rows[:, 0], dest)
            else:
                flat = (-1, spec.num_heads, spec.head_dim)
                cache.k_store[g].view(flat)[dest] = k[:, 0].to(cache.dtype)
                cache.v_store[g].view(flat)[dest] = v[:, 0].to(cache.dtype)
            if self.paged:
                attn = paged_decode_attention(
                    q, cache.k[g], cache.v[g], st.tables, lens,
                    kernel=self.decode_kernel, **self._scales(g),
                )
            else:
                attn = decode_attention(q, cache.k[g], cache.v[g], lens, kernel=self.decode_kernel)
            return [mha_project_out(attn, ws, ctx, use_bias=use_bias)]

        logits = self._forward_logits(params, st.tokens[:, None], hook)[:, -1, :]
        if st.logits is None:
            st.logits = torch.empty((st.steps, *logits.shape), dtype=logits.dtype, device=logits.device)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        hit = act & (st.eos >= 0) & (nxt == st.eos)
        at = st.step.long().view(1)
        row = torch.stack([nxt, act.to(torch.int32), torch.isfinite(logits).all(dim=-1).to(torch.int32)])
        st.out.index_copy_(0, at, row[None])
        st.logits.index_copy_(0, at, logits[None])
        lens.copy_(torch.where(act, lens + 1, lens))
        st.tokens.copy_(torch.where(act, nxt, st.tokens))
        st.alive.masked_fill_(hit, 0)
        st.step.add_(1)

    def _load_state(self, st: _CoreState, tokens, active, limits, eos) -> None:
        """The core's inputs for a run from step 0, in one host-to-device
        copy: the host lengths and (paged) a table snapshot."""
        cache = self.cache
        parts = [tokens, cache.lengths, active, limits, eos, [0]]
        if self.paged:
            parts.append(cache.block_tables)
        host = np.concatenate([np.asarray(a, dtype=np.int32).ravel() for a in parts])
        st.inp.copy_(torch.from_numpy(host))

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
        [max_seqs, V] on the device). One eager run of the decode core."""
        spec = self.cache.spec
        cache = self.cache
        active = np.asarray(active_mask, dtype=bool)
        if self.paged:
            # claim the next page for any sequence about to cross a page
            # boundary BEFORE the step (the admission reserve guarantees it)
            for slot in np.nonzero(active)[0]:
                cache.ensure_position(int(slot), int(cache.lengths[slot]))
        st = _CoreState(spec.max_seqs, self._table_cols(), 1, self.device)
        self._load_state(st, tokens, active, active, np.full(spec.max_seqs, -1))
        self._decode_core(params, st)
        nxt = st.out[0, 0].cpu().numpy()
        cache.lengths[active] += 1
        return nxt, st.logits[0]

    def _table_cols(self) -> int:
        return self.cache.spec.max_pages_per_seq if self.paged else 0

    # -- multi-step decode -----------------------------------------------------

    @property
    def multistep_cache_entries(self) -> int:
        """Captured decode windows alive (CUDA graphs; 0 on the CPU)."""
        return len(self._graphs)

    @torch.no_grad()
    def decode_multi(
        self,
        params,
        tokens: np.ndarray,
        active_mask: np.ndarray,
        step_limits: np.ndarray,
        eos_tokens: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
        """A synchronous window of k = max(step_limits over active slots)
        fused decode steps (reference decode_multi). tokens [max_seqs]:
        the last emitted token per slot; step_limits [max_seqs]: steps
        each slot runs at most; eos_tokens [max_seqs] (-1 = none): EOS
        retires a slot inside the window, after it emits the EOS token.
        Claims every page the window can touch first, snapshots the
        tables once, runs the decode core k times (on the card: k
        replays of a captured CUDA graph) and reads the host once.

        Returns (tokens_ks [k, max_seqs] on the host, logits_ks [k,
        max_seqs, V] on the device, mask_ks [k, max_seqs] bool on the
        host: the steps each slot took); `window_finite` [k, max_seqs]
        comes from the same read. The host lengths advance by the FULL
        limits: the caller truncates slots that retired early."""
        spec = self.cache.spec
        cache = self.cache
        active = np.asarray(active_mask, dtype=bool)
        limits = np.where(active, np.asarray(step_limits, dtype=np.int32), 0).astype(np.int32)
        k = int(limits.max()) if limits.size else 0
        if k < 1:
            raise ValueError("multi-step window needs at least one fused step")
        if k > self.max_fused_steps:
            raise ValueError(f"a window of {k} steps exceeds max_fused_steps {self.max_fused_steps}")
        for slot in np.nonzero(limits)[0]:
            if int(cache.lengths[slot]) + int(limits[slot]) > spec.max_len:
                raise ValueError(
                    f"slot {int(slot)}: {int(limits[slot])} fused steps overrun max_len {spec.max_len}"
                )
        if self.paged:
            # every page the window writes is claimed BEFORE the table
            # snapshot (the admission reserve guarantees the claims)
            for slot in np.nonzero(limits)[0]:
                start = int(cache.lengths[slot])
                for pos in range(start, start + int(limits[slot])):
                    cache.ensure_position(int(slot), pos)
        eos = np.full(spec.max_seqs, -1, dtype=np.int32) if eos_tokens is None else eos_tokens
        if self.device.type == "cuda":
            st, logits = self._graph_window(params, tokens, active, limits, eos, k)
        else:
            st = _CoreState(spec.max_seqs, self._table_cols(), k, self.device)
            self._load_state(st, tokens, active, limits, eos)
            for _ in range(k):
                self._decode_core(params, st)
            logits = st.logits
        host = st.out[:k].cpu().numpy()  # the window's one host read
        cache.lengths[active] += limits[active]
        self.window_finite = host[:, 2].astype(bool)
        return host[:, 0], logits, host[:, 1].astype(bool)

    def _graph_window(self, params, tokens, active, limits, eos, k):
        """k steps of the decode core on the card as replays of one
        captured CUDA graph over static state, captured at the first
        window (and again for other weights): that window's first step
        runs eagerly on the capture stream, which warms it, and the graph
        is captured after it. A failed capture or replay raises. Returns
        (the state, a copy of the window's logits [k, max_seqs, V])."""
        spec = self.cache.spec
        key = ("paged" if self.paged else "slot", spec.kv_dtype, spec.max_seqs)
        weights = tuple(w.data_ptr() for ws in params.values() for w in ws)
        win = self._graphs.get(key)
        if win is None or win.weights != weights:
            st = _CoreState(spec.max_seqs, self._table_cols(), self.max_fused_steps, self.device)
            win = self._graphs[key] = _GraphWindow(st, torch.cuda.Stream(self.device), weights)
        st = win.state
        self._load_state(st, tokens, active, limits, eos)
        done = 0
        if win.graph is None:
            here = torch.cuda.current_stream(self.device)
            win.stream.wait_stream(here)
            with torch.cuda.stream(win.stream):
                self._decode_core(params, st)  # step 0, and the warm-up
                done = 1
                before = dict(dk.LAUNCHES)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=win.stream):
                    self._decode_core(params, st)
                # the capture launched nothing: its counts go per replay
                win.launches = {n: dk.LAUNCHES[n] - before[n] for n in before}
                dk.LAUNCHES.update(before)
            here.wait_stream(win.stream)
            win.graph = graph
        for _ in range(k - done):
            win.graph.replay()
            for name, n in win.launches.items():
                dk.LAUNCHES[name] += n
        # the stacks are overwritten by the next window
        return st, st.logits[:k].clone()

    # -- speculative verify ----------------------------------------------------

    def _verify_scatter_dest(self, w: int, lengths: np.ndarray, draft_lens: np.ndarray):
        """Host destinations of a verify write: (rows, dest) where `rows`
        indexes the [max_seqs * w] fresh K/V rows that are written and
        `dest` is each one's flat cache row (slot * max_len + position on
        the slot layout, page * page_size + offset on the paged one). Row
        j of slot s lands at position lengths[s] + j when j < draft_lens[s]
        and the position is inside max_len (and, paged, on a claimed
        page); pad rows, inactive slots and overflow are never written."""
        spec = self.cache.spec
        pos = lengths[:, None].astype(np.int64) + np.arange(w)[None, :]
        valid = (np.arange(w)[None, :] < draft_lens[:, None]) & (pos < spec.max_len)
        if self.paged:
            ps = spec.page_size
            page_idx = np.clip(pos // ps, 0, spec.max_pages_per_seq - 1)
            entry = np.take_along_axis(self.cache.block_tables, page_idx, axis=1).astype(np.int64)
            valid &= entry != spec.num_pages
            flat = entry * ps + pos % ps
        else:
            flat = np.arange(spec.max_seqs)[:, None] * spec.max_len + pos
        return np.nonzero(valid.ravel())[0], flat[valid]

    @torch.no_grad()
    def _verify(self, params, tokens, draft_lens, parents=None) -> np.ndarray:
        spec = self.cache.spec
        cache = self.cache
        tokens = np.asarray(tokens, dtype=np.int32)
        draft_lens = np.asarray(draft_lens, dtype=np.int32)
        if tokens.ndim != 2 or tokens.shape[0] != spec.max_seqs:
            raise ValueError(
                f"tokens must be [max_seqs={spec.max_seqs}, w], got {tokens.shape}"
            )
        w = tokens.shape[1]
        if w < 1:
            raise ValueError("verify needs at least one token column")
        if draft_lens.shape != (spec.max_seqs,):
            raise ValueError("draft_lens must be [max_seqs]")
        for slot in np.nonzero(draft_lens)[0]:
            need = int(cache.lengths[slot]) + int(draft_lens[slot])
            if draft_lens[slot] > w or need > spec.max_len:
                raise ValueError(
                    f"slot {int(slot)}: draft_lens {int(draft_lens[slot])} "
                    f"overruns width {w} or max_len {spec.max_len}"
                )
        if self.paged:
            # claim every page the fresh rows touch BEFORE the step
            for slot in np.nonzero(draft_lens)[0]:
                start = int(cache.lengths[slot])
                for p in range(start, start + int(draft_lens[slot])):
                    cache.ensure_position(int(slot), p)
        lengths = cache.lengths.copy()
        rows, dest = self._verify_scatter_dest(w, lengths, draft_lens)
        host = [tokens, lengths, rows]
        if self.paged:
            ps = spec.page_size
            host += [cache.block_tables] + (quant_plan(dest, ps) if self.quantized else [dest])
        else:
            host += [dest // spec.max_len, dest % spec.max_len]
        if parents is not None:
            host.append(parents)
        dev = _to_device(self.device, host)
        # the tree mask, once per step for every layer
        allowed = tree_allowed_mask(dev.pop(), dev[1], w, spec.max_len) if parents is not None else None
        tok_t, len_t, rows_t = dev[:3]
        tables_t, dest_t = (dev[3], dev[4:]) if self.paged else (None, dev[3:])

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            self._write(g, self._rows(k)[rows_t], self._rows(v)[rows_t], dest_t)
            if self.paged:
                attn = paged_verify_attention(
                    q, cache.k[g], cache.v[g], tables_t, len_t,
                    kernel=self.decode_kernel, allowed=allowed, **self._scales(g),
                )
            else:
                attn = verify_attention(
                    q, cache.k[g], cache.v[g], len_t,
                    kernel=self.decode_kernel, allowed=allowed,
                )
            return [mha_project_out(attn, ws, ctx, use_bias=use_bias)]

        # numpy has no bfloat16: a mixed-precision model's bf16 logits
        # reach the host as float32, exactly (the reference's
        # np.asarray(...).astype(np.float32))
        return self._forward_logits(params, tok_t, hook).float().cpu().numpy()

    def verify(self, params, tokens: np.ndarray, draft_lens: np.ndarray) -> np.ndarray:
        """One speculative verify step (SpecInfer's scoring call),
        synchronous. tokens [max_seqs, w]: column 0 is each slot's last
        emitted (not yet cached) token, columns 1..draft_lens[s]-1 its
        drafted continuation; draft_lens [max_seqs] = real rows per slot
        (0 for inactive slots). Writes the real rows' K/V (claiming paged
        slots' pages first) under the staircase mask and does NOT advance
        lengths. Returns the logits [max_seqs, w, V] on the host: row
        [s, j] is the model's distribution for the token following
        tokens[s, j]."""
        return self._verify(params, tokens, draft_lens)

    def verify_tree(
        self,
        params,
        tokens: np.ndarray,
        draft_lens: np.ndarray,
        parents: np.ndarray,
    ) -> np.ndarray:
        """Token-tree verify: as verify, with columns 1.. holding draft
        tree nodes in topological order and parents [max_seqs, w] mapping
        each row to its parent row (-1 for row 0, chain padding past
        draft_lens). Row j attends the committed prefix and its own
        root-to-j chain only; the mask is built once per step from
        `parents`, so every tree topology of width w runs the same
        kernels."""
        parents = np.asarray(parents, dtype=np.int32)
        tokens = np.asarray(tokens)
        if parents.shape != tokens.shape:
            raise ValueError(
                f"parents must match tokens shape {tokens.shape}, got {parents.shape}"
            )
        if np.any(parents >= np.arange(tokens.shape[1])[None, :]):
            raise ValueError("parents must be topological: parents[:, j] < j")
        return self._verify(params, tokens, draft_lens, parents)
