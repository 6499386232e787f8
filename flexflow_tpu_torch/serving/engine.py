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
    reach the CUDA kernels of ops/cuda/decode_kernel.py), picks each
    token (greedy or sampled) and carries lengths / tokens / alive forward as the
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

Greedy argmax picks tokens at temperature 0; above it `_select` samples
with the reference's per-row keys, fold_in(fold_in(PRNGKey(seed), slot),
position) at the cache position the token will occupy (prompt length
for prefill, lengths + 1 for decode, cursor + chunk for a chunk step),
through serving/sampling.py's copy of jax.random. The slots' keys,
fold_in(PRNGKey(seed), slot), are made once per engine and only when it
samples; the decode core samples on the device from them, so a
CUDA-graph window samples inside the graph. A chunk step draws only for
the rows whose chunk ends their prompt.

  * **prefill_chunk**: chunked prefill (the reference's _chunk_impl):
    the next chunk_lens[s] prompt tokens of each chunking slot, the
    batch compacted to those slots, through the verify core's staircase
    (query offset = the slot's cursor) and the decode kernels #4 / #5 /
    #6 at the step's width (at most decode_kernel.MAX_W rows); the rows
    are prompt tokens, so lengths advance by the chunk. The last chunk
    row's logits give the first generated token, sampled at cursor +
    chunk = the prompt length on a final chunk.
  * **prefill_suffix**: the prefix-shared admission's prefill of the
    unshared suffix, as successive chunk steps of at most MAX_W rows.

Every decode, multi-step window, verify and chunk step is split, as the
reference's are, into a **dispatch** (claim pages, stage the inputs,
enqueue the step, advance the host lengths, open the cache's in-flight
window, issue the read-back) and a **reconcile** (wait for the
read-back, close the window), which hand each other an `InflightStep`:
host snapshots of what the commit needs beside the step's device
tensors. `decode`, `decode_multi`, `verify`, `verify_tree` and
`prefill_chunk` are dispatch + immediate reconcile; the async scheduler
runs the halves an iteration apart and chains a decode's input tokens
on the in-flight step's `device_next` on the device. On the card the
dispatch side never waits for the stream: every host-to-device copy is
`non_blocking` from a fresh pinned snapshot the step keeps until its
reconcile, every device-to-host copy is issued at dispatch, non_blocking
into pinned memory, with a CUDA event the reconcile waits on, and the
finite flags of each row come back in that same read. On the CPU both
halves run eagerly and the reconcile just reads the tensors.

With an adapter pool (serving/tenancy/adapters.py) every step kind
adds the per-row LoRA deltas (plain PyTorch, as the reference's) right
after the Q/K/V projections, before the cache writes, and after the
output projection; rows serving the base model take the unmodified
tensors through a select. The tables of a step travel in its one int32
copy: the prefill batch's row tables, the slot tables of decode and
verify (the decode core's in `_CoreState.inp`, so a graph replay reads
the attachments of its own window), and the chunk step's compacted to
its slots. Without a pool no adapter op runs.

The reference's kernel-failure handler, which switched the engine to
dense attention for good after any kernel error, is deliberately
absent: a failing kernel, capture or replay raises, and nothing on the
card falls back to eager steps or to a dense path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

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
from flexflow_tpu_torch.serving.sampling import sample, slot_keys
from flexflow_tpu_torch.serving.tenancy.adapters import adapter_rows, apply_adapter_out, apply_adapter_qkv


def _snapshot(device, host: np.ndarray, keep: List[torch.Tensor]) -> torch.Tensor:
    """The source of a host-to-device copy of `host` that never waits for
    the stream (copy it with non_blocking=True): a fresh snapshot, so no
    later write to `host` reaches the copy, pinned on the card and held
    in `keep` until the step reconciles."""
    t = torch.from_numpy(np.array(host))
    if device.type == "cuda":
        t = t.pin_memory()
        keep.append(t)
    return t


def _to_device(device, parts: Sequence[np.ndarray], keep: Optional[List[torch.Tensor]] = None):
    """Copy host int arrays to `device` in one int32 transfer (from a
    _snapshot); returns a device view per part, shaped like it."""
    device = torch.device(device)
    flat = np.concatenate([np.asarray(p, dtype=np.int32).ravel() for p in parts])
    buf = _snapshot(device, flat, [] if keep is None else keep).to(device, non_blocking=True)
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
    block tables | adapter tables | adapter flags | chain mask], so a
    window's host inputs reach the device in one copy (the adapter
    tables [max_seqs, adapter_cols] and flags [max_seqs] only with an
    adapter pool, the chain mask [max_seqs] only for a chained decode
    step's state); the per-step stacks tokens / mask / finite are views
    of one int32 buffer `out` [steps, 3, max_seqs], so the host reads
    them in one copy, and `logits` [steps, max_seqs, V] stays on the
    device."""

    def __init__(self, max_seqs: int, table_cols: int, steps: int, device, chained: bool = False,
                 adapter_cols: int = 0):
        S = max_seqs
        self.steps = steps
        # every run loads all of `inp` first and reads `out` only at the
        # steps it ran, so neither needs zeroing
        n = 5 * S + 1 + S * table_cols
        m = n + (S * (adapter_cols + 1) if adapter_cols else 0)
        self.inp = torch.empty(m + (S if chained else 0), dtype=torch.int32, device=device)
        self.tokens, self.lengths, self.alive, self.limits, self.eos = self.inp[: 5 * S].view(5, S)
        self.step = self.inp[5 * S]
        self.tables = self.inp[5 * S + 1:n].view(S, table_cols) if table_cols else None
        self.adapter_tables = self.inp[n:m - S].view(S, adapter_cols) if adapter_cols else None
        self.has_adapter = self.inp[m - S:m] if adapter_cols else None
        self.chain_mask = self.inp[m:] if chained else None
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
    # a dispatched window over this state is not yet reconciled: the next
    # replay would overwrite its static outputs
    inflight: bool = False


@dataclasses.dataclass
class InflightStep:
    """One dispatched step not yet reconciled (the reference's
    InflightStep): the only record that crosses from a dispatch to its
    reconcile. Host snapshots (numpy, copied at dispatch) of what the
    commit reads — the pre-step lengths, the active rows, the
    scheduler's participants, plans and chunk cursors —
    beside the step's device tensors, the pinned host buffer its one
    read-back lands in and the event that marks it landed."""

    kind: str  # "decode" | "multistep" | "verify" | "verify_tree" | "chunk"
    active: np.ndarray  # bool [max_seqs]: the rows the step ran for
    lengths: np.ndarray  # int32 [max_seqs]: cache lengths before the step
    dispatch_t: float = 0.0  # wall clock at the end of the dispatch
    # chunk: slot -> (start, size, final) and slot -> the sequence being
    # prefilled, the cursor snapshot the commit reads
    chunks: Optional[Dict[int, tuple]] = None
    chunk_seqs: Optional[Dict[int, list]] = None
    device_next: Optional[torch.Tensor] = None  # decode: tokens [max_seqs] int32, for chaining
    device_logits: Optional[torch.Tensor] = None  # [max_seqs, V], [k, max_seqs, V] or [max_seqs, w, V]
    k_steps: int = 1  # multistep: the window's depth
    step_limits: Optional[np.ndarray] = None  # multistep: int32 [max_seqs] per-slot caps
    # the one read-back: a pinned host tensor (the tensor itself on the
    # CPU), the event recorded after its copy, and the staged inputs kept
    # alive until the reconcile
    readback: Optional[torch.Tensor] = None
    done: Optional["torch.cuda.Event"] = None
    staged: List[torch.Tensor] = dataclasses.field(default_factory=list)
    window: Optional[_GraphWindow] = None  # multistep on the card: its captured state
    # filled by the reconcile: per-row finite flags ([max_seqs], [k,
    # max_seqs] for a window)
    finite: Optional[np.ndarray] = None
    # scheduler-side snapshot: slot -> Request at dispatch, the draft
    # plan (token lists; the trees of a tree verify) and the dispatching
    # iteration
    participants: Dict[int, object] = dataclasses.field(default_factory=dict)
    plan: Optional[Dict[int, list]] = None
    tree_plan: Optional[Dict[int, object]] = None
    iteration: int = -1


class GenerationEngine:
    """Step functions over (params, cache); scheduling lives in
    serving.scheduler. `max_fused_steps` is the deepest decode_multi
    window (the depth of the captured graph's per-step stacks).
    temperature 0 is greedy; above it tokens are sampled under `seed`.
    `adapters`, an AdapterPool over the same model, adds each slot's
    LoRA deltas to every step (None: no adapter op runs)."""

    def __init__(
        self,
        model,
        cache,
        decode_kernel: str = "auto",
        max_fused_steps: int = 8,
        temperature: float = 0.0,
        seed: int = 0,
        adapters=None,
    ):
        if model.executor is None:
            raise RuntimeError("compile() the model before serving")
        check_mode(decode_kernel)
        if max_fused_steps < 1:
            raise ValueError(f"max_fused_steps must be >= 1, got {max_fused_steps}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.model = model
        self.executor = model.executor
        self.cache = cache
        self.device = model.device
        self.decode_kernel = decode_kernel
        self.max_fused_steps = int(max_fused_steps)
        self.adapters = adapters
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
        # [max_seqs, 2]: each slot's fold_in(PRNGKey(seed), slot), the
        # constant part of its sampling keys (None when greedy)
        self._slot_keys = (
            slot_keys(self.seed, torch.arange(cache.spec.max_seqs, device=self.device))
            if self.temperature > 0.0 else None
        )

    def _forward_logits(self, params, tokens, hook) -> torch.Tensor:
        return self.executor.logits(
            params,
            {self.input_name: tokens},
            op_hooks={OperatorType.MULTIHEAD_ATTENTION: hook},
        )

    def _select_device(self, logits: torch.Tensor, slots: Optional[torch.Tensor],
                       positions: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference's _pick on the device: logits [n, vocab] -> token
        ids [n] int32, the first maximum at temperature 0 (bf16 logits
        compare as bf16, as jnp.argmax does; slots and positions unused),
        else one draw per row keyed by (seed, slot, position) — the cache
        position the token will occupy. slots None: row i is slot i."""
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        keys = self._slot_keys if slots is None else self._slot_keys[slots.long()]
        return sample(logits, self.temperature, self.seed, None, positions, keys).to(torch.int32)

    def _select(self, logits: torch.Tensor, slots: torch.Tensor, positions: torch.Tensor) -> np.ndarray:
        """_select_device, read on the host."""
        return self._select_device(logits, slots, positions).cpu().numpy()

    def _issue_readback(self, step: InflightStep, t: torch.Tensor) -> None:
        """Issue the step's one device-to-host read of `t` at dispatch: on
        the card a non_blocking copy into fresh pinned memory and an event
        recorded after it; on the CPU the tensor itself. The last act of
        every dispatch: stamps its end."""
        if self.device.type != "cuda":
            step.readback = t
        else:
            step.readback = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            step.readback.copy_(t, non_blocking=True)
            step.done = torch.cuda.Event()
            step.done.record()
        step.dispatch_t = time.perf_counter()

    @staticmethod
    def _wait(step: InflightStep) -> np.ndarray:
        """The reconcile's read: wait for the step's event, then the host
        copy (numpy)."""
        if step.done is not None:
            step.done.synchronize()
        return step.readback.numpy()

    def _adapter_views(self, dev: List[torch.Tensor]):
        """Split a step's device views at the adapter tables and flags a
        host part list carried there (`_adapter_parts`): returns ((tables,
        has), or None without a pool, and the views after them)."""
        if self.adapters is None:
            return None, dev
        return (dev[0], dev[1] != 0), dev[2:]

    def _adapter_gather(self, rows):
        """The step's AdapterGather of (tables, has) rows (None without a
        pool)."""
        return None if rows is None else self.adapters.gather(*rows)

    def _adapter_parts(self) -> List[np.ndarray]:
        """The slot tables and flags of the adapter pool, as host parts of
        a step's one copy ([] without a pool)."""
        return [] if self.adapters is None else list(self.adapters.slot_tables())

    def _adapter_cols(self) -> int:
        return 0 if self.adapters is None else self.adapters.spec.pages_per_adapter

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
        ad_parts = [] if self.adapters is None else list(self.adapters.row_tables(slots, n))
        if self.paged:
            ps = spec.page_size
            pos = np.arange(bucket)
            pages = self.cache.block_tables[slots_np][:, pos // ps]  # [n, bucket]
            # bucket padding past a prompt's allocated pages is not written
            real = pages != spec.num_pages
            dest = (pages * ps + pos % ps)[real]
            parts = quant_plan(dest, ps) if self.quantized else [dest]
            tok_t, last_t, slots_t, plens_t, real_t, *rest = _to_device(
                self.device, [tokens, plens - 1, slots_np, plens, np.nonzero(real.ravel())[0]] + ad_parts + parts
            )
            rows, dest_t = self._adapter_views(rest)
        else:
            tok_t, last_t, slots_t, plens_t, pos_t, *rest = _to_device(
                self.device, [tokens, plens - 1, slots_np, plens, np.arange(bucket)] + ad_parts
            )
            rows, _ = self._adapter_views(rest)
        ad = self._adapter_gather(rows)
        cache = self.cache

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            q, k, v = apply_adapter_qkv(ins[0], q, k, v, ad, g)
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
            return [apply_adapter_out(attn, mha_project_out(attn, ws, ctx, use_bias=use_bias), ad, g)]

        logits = self._forward_logits(params, tok_t, hook)
        last = logits[torch.arange(n, device=self.device), last_t.long()]
        # the sampled token will sit at cache position len(prompt)
        nxt = self._select(last, slots_t, plens_t)
        for p, s in zip(prompts, slots):
            cache.lengths[s] = len(p)
        return nxt, last

    # -- chunked prefill -----------------------------------------------------

    @torch.no_grad()
    def prefill_chunk_dispatch(
        self,
        params,
        tokens: np.ndarray,
        chunk_lens: np.ndarray,
        final: Optional[np.ndarray] = None,
    ) -> InflightStep:
        """Dispatch one chunked-prefill step (the reference's
        prefill_chunk_dispatch). tokens [max_seqs, w]: the next
        chunk_lens[s] prompt tokens of each chunking slot (rows with
        chunk_lens 0 take no part). The batch is compacted to the
        chunking slots; their rows are written at each slot's cursor
        (paged slots claim those pages first), attend under the verify
        staircase (query offset = cursor) through kernel #4, #5 or #6 at
        width w <= decode_kernel.MAX_W, and the cursors advance by the
        chunk at dispatch: prompt rows are accepted by construction, so
        the next chunk may dispatch before this one reconciles. `final`
        [max_seqs] bool marks the slots whose chunk ends their prompt:
        only those pick a token (None: every chunking slot does)."""
        spec = self.cache.spec
        cache = self.cache
        tokens = np.asarray(tokens, dtype=np.int32)
        chunk_lens = np.asarray(chunk_lens, dtype=np.int32)
        if tokens.ndim != 2 or tokens.shape[0] != spec.max_seqs:
            raise ValueError(f"tokens must be [max_seqs={spec.max_seqs}, w], got {tokens.shape}")
        w = tokens.shape[1]
        if not 1 <= w <= dk.MAX_W:
            raise ValueError(f"a chunk step takes 1 to {dk.MAX_W} token columns, got {w}")
        if chunk_lens.shape != (spec.max_seqs,):
            raise ValueError("chunk_lens must be [max_seqs]")
        for slot in np.nonzero(chunk_lens)[0]:
            if chunk_lens[slot] > w or int(cache.lengths[slot]) + int(chunk_lens[slot]) > spec.max_len:
                raise ValueError(
                    f"slot {int(slot)}: chunk_lens {int(chunk_lens[slot])} "
                    f"overruns width {w} or max_len {spec.max_len}"
                )
        slot_ids = np.nonzero(chunk_lens > 0)[0]
        if slot_ids.size == 0:
            raise ValueError("chunk step needs at least one active slot")
        if self.paged:
            for slot in slot_ids:
                start = int(cache.lengths[slot])
                for p in range(start, start + int(chunk_lens[slot])):
                    cache.ensure_position(int(slot), p)
        lengths = cache.lengths.copy()
        picks = np.ones(slot_ids.size, dtype=bool) if final is None else np.asarray(final, dtype=bool)[slot_ids]
        keep: List[torch.Tensor] = []
        out_c, last_c, slots_t = self._chunk_core(
            params, tokens[slot_ids], slot_ids, chunk_lens[slot_ids], picks, keep
        )
        logits = last_c.new_zeros((spec.max_seqs, last_c.shape[-1]))
        logits[slots_t.long()] = last_c
        cache.lengths[slot_ids] += chunk_lens[slot_ids]
        cache.begin_inflight()
        step = InflightStep(
            kind="chunk",
            active=chunk_lens > 0,
            lengths=lengths,
            device_logits=logits,
            staged=keep,
        )
        self._issue_readback(step, out_c)
        return step

    def prefill_chunk_reconcile(self, step: InflightStep) -> Tuple[np.ndarray, torch.Tensor]:
        """Wait for a chunk step's read-back and close its window.
        Returns (next_tokens [max_seqs] on the host, the last chunk row's
        logits [max_seqs, V] on the device), zero for slots that took no
        part or picked no token; `step.finite` [max_seqs] gets each row's
        finite flag (False where a slot took no part)."""
        try:
            host = self._wait(step)
        finally:
            self.cache.end_inflight()
        spec = self.cache.spec
        slot_ids = np.nonzero(step.active)[0]
        nxt = np.zeros(spec.max_seqs, dtype=np.int32)
        step.finite = np.zeros(spec.max_seqs, dtype=bool)
        nxt[slot_ids] = host[0]
        step.finite[slot_ids] = host[1] != 0
        return nxt, step.device_logits

    def prefill_chunk(
        self,
        params,
        tokens: np.ndarray,
        chunk_lens: np.ndarray,
        final: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """One chunked-prefill step, synchronous: prefill_chunk_dispatch
        and its reconcile. Returns (next_tokens [max_seqs] on the host,
        the last chunk row's logits [max_seqs, V] on the device)."""
        return self.prefill_chunk_reconcile(self.prefill_chunk_dispatch(params, tokens, chunk_lens, final))

    def _chunk_core(self, params, tokens, slot_ids, chunk_lens, picks, keep):
        """The compact chunk batch [B, w] of prefill_chunk_dispatch, on
        the device only: returns ([2, B] int32 of the next tokens, zero
        where picks [B] is false, and each row's finite flag; the
        last-row logits [B, V]; the slots [B] on the device)."""
        spec = self.cache.spec
        cache = self.cache
        B, w = tokens.shape
        lengths = cache.lengths[slot_ids].astype(np.int64)
        pos = lengths[:, None] + np.arange(w)[None, :]
        valid = np.arange(w)[None, :] < chunk_lens[:, None]
        if self.paged:
            ps = spec.page_size
            tables = cache.block_tables[slot_ids]
            page_idx = np.clip(pos // ps, 0, spec.max_pages_per_seq - 1)
            entry = np.take_along_axis(tables, page_idx, axis=1).astype(np.int64)
            flat = (entry * ps + pos % ps)[valid]
            parts = [tables] + (quant_plan(flat, ps) if self.quantized else [flat])
        else:
            flat = (slot_ids[:, None].astype(np.int64) * spec.max_len + pos)[valid]
            parts = [flat // spec.max_len, flat % spec.max_len]
        dev = _to_device(
            self.device,
            [tokens, lengths, np.nonzero(valid.ravel())[0], slot_ids, chunk_lens - 1, lengths + chunk_lens,
             np.nonzero(picks)[0]]
            + self._adapter_parts()
            + parts,
            keep,
        )
        tok_t, len_t, rows_t, slots_t, last_t, end_t, pick_t = dev[:7]
        rows, rest = self._adapter_views(dev[7:])
        tables_t, dest_t = (rest[0], rest[1:]) if self.paged else (None, rest)
        slots_l = slots_t.long()
        # the slot tables, compacted to the chunk batch's rows
        ad = self._adapter_gather(adapter_rows(rows, slots_l))

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            q, k, v = apply_adapter_qkv(ins[0], q, k, v, ad, g)
            self._write(g, self._rows(k)[rows_t], self._rows(v)[rows_t], dest_t)
            if self.paged:
                attn = paged_verify_attention(
                    q, cache.k[g], cache.v[g], tables_t, len_t,
                    kernel=self.decode_kernel, **self._scales(g),
                )
            else:
                attn = verify_attention(
                    q, cache.k[g][slots_l], cache.v[g][slots_l], len_t, kernel=self.decode_kernel
                )
            return [apply_adapter_out(attn, mha_project_out(attn, ws, ctx, use_bias=use_bias), ad, g)]

        logits = self._forward_logits(params, tok_t, hook)
        last = logits[torch.arange(B, device=self.device), last_t.long()]
        nxt = torch.zeros(B, dtype=torch.int32, device=self.device)
        if picks.any():
            # on a final chunk cursor + chunk is the prompt length: the
            # monolithic prefill's sampling key
            pick = pick_t.long()
            nxt[pick] = self._select_device(last[pick], slots_t[pick], end_t[pick])
        out = torch.stack([nxt, torch.isfinite(last).all(dim=-1).to(torch.int32)])
        return out, last, slots_t

    def prefill_suffix(
        self,
        params,
        prompts: Sequence[Sequence[int]],
        slots: Sequence[int],
        cursors: Sequence[int],
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Prefill only prompt[cursor:] of each prompt: the admission of
        prefix-shared requests, whose mapped pages already hold positions
        [0, cursor) (the cache parked their lengths at the cursor). The
        suffixes run as successive chunk steps of at most MAX_W rows, so
        a long suffix stays on the decode kernels; each request's token
        comes from its last step, sampled at its full prompt length.
        Returns (next_tokens [n] on the host, last_logits [n, V]) in
        request order."""
        spec = self.cache.spec
        if not prompts:
            raise ValueError("prefill_suffix needs at least one prompt")
        rest = np.zeros(spec.max_seqs, dtype=np.int64)
        for p, s, c in zip(prompts, slots, cursors):
            c = int(c)
            if not 0 <= c < len(p):
                raise ValueError(
                    f"cursor {c} outside [0, {len(p)}): at least one prompt "
                    "token must be recomputed for sampling logits"
                )
            if int(self.cache.lengths[s]) != c:
                raise ValueError(f"slot {s} holds {int(self.cache.lengths[s])} positions, not its cursor {c}")
            rest[s] = len(p) - c
        nxt = np.zeros(len(prompts), dtype=np.int32)
        last = [None] * len(prompts)
        while rest.any():
            w = int(min(dk.MAX_W, rest.max()))
            tokens = np.zeros((spec.max_seqs, w), dtype=np.int32)
            chunk = np.minimum(rest, w).astype(np.int32)
            for p, s in zip(prompts, slots):
                start = int(self.cache.lengths[s])
                tokens[s, : chunk[s]] = np.asarray(p[start : start + chunk[s]], dtype=np.int32)
            step_nxt, step_logits = self.prefill_chunk(params, tokens, chunk, final=(chunk > 0) & (chunk == rest))
            rest -= chunk
            for i, s in enumerate(slots):
                if chunk[s] and not rest[s]:
                    nxt[i], last[i] = step_nxt[s], step_logits[s]
        return nxt, torch.stack(last)

    # -- decode --------------------------------------------------------------

    def _decode_core(self, params, st: _CoreState) -> None:
        """One fixed-shape decode step on the device, with no host read:
        each slot with alive & (step < limits) writes its K/V row at its
        carried length (through the table snapshot on the paged layout;
        every other row at the scratch row), attends, and picks its token
        (greedy, or sampled at position length + 1); EOS clears alive, and lengths / tokens move for the active
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
        ad = None
        if st.adapter_tables is not None:
            ad = self.adapters.gather(st.adapter_tables, st.has_adapter != 0)

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            q, k, v = apply_adapter_qkv(ins[0], q, k, v, ad, g)
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
            return [apply_adapter_out(attn, mha_project_out(attn, ws, ctx, use_bias=use_bias), ad, g)]

        logits = self._forward_logits(params, st.tokens[:, None], hook)[:, -1, :]
        if st.logits is None:
            st.logits = torch.empty((st.steps, *logits.shape), dtype=logits.dtype, device=logits.device)
        nxt = self._select_device(logits, None, lens + 1 if self.temperature > 0.0 else None)
        hit = act & (st.eos >= 0) & (nxt == st.eos)
        at = st.step.long().view(1)
        row = torch.stack([nxt, act.to(torch.int32), torch.isfinite(logits).all(dim=-1).to(torch.int32)])
        st.out.index_copy_(0, at, row[None])
        st.logits.index_copy_(0, at, logits[None])
        lens.copy_(torch.where(act, lens + 1, lens))
        st.tokens.copy_(torch.where(act, nxt, st.tokens))
        st.alive.masked_fill_(hit, 0)
        st.step.add_(1)

    def _load_state(self, st: _CoreState, tokens, active, limits, eos, keep: List[torch.Tensor],
                    chain_mask=None) -> None:
        """The core's inputs for a run from step 0, in one host-to-device
        copy (from a _snapshot): the host lengths, (paged) the tables,
        (with a pool) the adapter slot tables and (a chained state) the
        chain mask."""
        cache = self.cache
        parts = [tokens, cache.lengths, active, limits, eos, [0]]
        if self.paged:
            parts.append(cache.block_tables)
        parts += self._adapter_parts()
        if chain_mask is not None:
            parts.append(chain_mask)
        host = np.concatenate([np.asarray(a, dtype=np.int32).ravel() for a in parts])
        st.inp.copy_(_snapshot(self.device, host, keep), non_blocking=True)

    @torch.no_grad()
    def decode_dispatch(
        self,
        params,
        tokens: np.ndarray,
        active_mask: np.ndarray,
        chain: Optional[InflightStep] = None,
        chain_mask: Optional[np.ndarray] = None,
    ) -> InflightStep:
        """Dispatch one decode iteration over every slot: claim each
        active slot's next page (paged), run the decode core once, bump
        the active host lengths and issue the read-back of the tokens and
        finite flags. tokens [max_seqs] is the last emitted token per slot
        (free slots carry anything). Where `chain_mask` is set, the input
        token is instead the in-flight decode step `chain`'s device_next,
        taken on the device (the async loop's chained decode: no host
        round trip between two steps)."""
        spec = self.cache.spec
        cache = self.cache
        active = np.asarray(active_mask, dtype=bool)
        if self.paged:
            # claim the next page for any sequence about to cross a page
            # boundary BEFORE the step (the admission reserve guarantees it)
            for slot in np.nonzero(active)[0]:
                cache.ensure_position(int(slot), int(cache.lengths[slot]))
        lengths = cache.lengths.copy()
        keep: List[torch.Tensor] = []
        chained = chain is not None and chain_mask is not None and bool(np.any(chain_mask))
        st = _CoreState(spec.max_seqs, self._table_cols(), 1, self.device, chained=chained,
                        adapter_cols=self._adapter_cols())
        self._load_state(st, tokens, active, active, np.full(spec.max_seqs, -1), keep,
                         chain_mask if chained else None)
        if chained:
            st.tokens.copy_(torch.where(st.chain_mask != 0, chain.device_next, st.tokens))
        self._decode_core(params, st)
        cache.lengths[active] += 1
        cache.begin_inflight()
        step = InflightStep(
            kind="decode",
            active=active.copy(),
            lengths=lengths,
            device_next=st.out[0, 0],
            device_logits=st.logits[0],
            staged=keep,
        )
        self._issue_readback(step, st.out[0])
        return step

    def decode_reconcile(self, step: InflightStep) -> Tuple[np.ndarray, torch.Tensor]:
        """Wait for a decode step's read-back and close its window.
        Returns (next_tokens [max_seqs] on the host, logits [max_seqs, V]
        on the device); `step.finite` [max_seqs] gets each row's finite
        flag from the same read."""
        try:
            host = self._wait(step)
        finally:
            self.cache.end_inflight()
        step.finite = host[2] != 0
        return host[0], step.device_logits

    @torch.no_grad()
    def decode(
        self,
        params,
        tokens: np.ndarray,
        active_mask: np.ndarray,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """One decode iteration over every slot, synchronous: writes each
        active slot's new K/V row at its length, bumps active lengths.
        Returns (next_tokens [max_seqs] on the host, logits [max_seqs, V]
        on the device). One eager run of the decode core."""
        return self.decode_reconcile(self.decode_dispatch(params, tokens, active_mask))

    def _table_cols(self) -> int:
        return self.cache.spec.max_pages_per_seq if self.paged else 0

    # -- multi-step decode -----------------------------------------------------

    @property
    def multistep_cache_entries(self) -> int:
        """Captured decode windows alive (CUDA graphs; 0 on the CPU)."""
        return len(self._graphs)

    @torch.no_grad()
    def decode_multi_dispatch(
        self,
        params,
        tokens: np.ndarray,
        active_mask: np.ndarray,
        step_limits: np.ndarray,
        eos_tokens: Optional[np.ndarray] = None,
    ) -> InflightStep:
        """Dispatch a window of k = max(step_limits over active slots)
        fused decode steps (reference decode_multi_dispatch). tokens
        [max_seqs]: the last emitted token per slot; step_limits
        [max_seqs]: steps each slot runs at most; eos_tokens [max_seqs]
        (-1 = none): EOS retires a slot inside the window, after it emits
        the EOS token. Claims every page the window can touch first,
        snapshots the tables once, runs the decode core k times (on the
        card: k replays of a captured CUDA graph) and issues one
        read-back. The host lengths advance by the FULL limits: the
        caller truncates slots that retired early."""
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
        lengths = cache.lengths.copy()
        eos = np.full(spec.max_seqs, -1, dtype=np.int32) if eos_tokens is None else eos_tokens
        keep: List[torch.Tensor] = []
        win = None
        if self.device.type == "cuda":
            win, st, logits = self._graph_window(params, tokens, active, limits, eos, k, keep)
        else:
            st = _CoreState(spec.max_seqs, self._table_cols(), k, self.device, adapter_cols=self._adapter_cols())
            self._load_state(st, tokens, active, limits, eos, keep)
            for _ in range(k):
                self._decode_core(params, st)
            logits = st.logits
        cache.lengths[active] += limits[active]
        cache.begin_inflight()
        step = InflightStep(
            kind="multistep",
            active=active.copy(),
            lengths=lengths,
            device_logits=logits,
            k_steps=k,
            step_limits=limits,
            staged=keep,
            window=win,
        )
        # the window's one host read, issued before any later replay can
        # overwrite the captured state's stacks
        self._issue_readback(step, st.out[:k])
        if win is not None:
            win.inflight = True
        return step

    def decode_multi_reconcile(self, step: InflightStep) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
        """Wait for a window's read-back and close its in-flight window.
        Returns (tokens_ks [k, max_seqs] on the host, logits_ks [k,
        max_seqs, V] on the device, mask_ks [k, max_seqs] bool on the
        host: the steps each slot took); `step.finite` and
        `window_finite` [k, max_seqs] come from the same read."""
        try:
            host = self._wait(step)
        finally:
            self.cache.end_inflight()
            if step.window is not None:
                step.window.inflight = False
        step.finite = self.window_finite = host[:, 2] != 0
        return host[:, 0], step.device_logits, host[:, 1] != 0

    def decode_multi(
        self,
        params,
        tokens: np.ndarray,
        active_mask: np.ndarray,
        step_limits: np.ndarray,
        eos_tokens: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
        """A synchronous window (reference decode_multi):
        decode_multi_dispatch and its reconcile."""
        return self.decode_multi_reconcile(
            self.decode_multi_dispatch(params, tokens, active_mask, step_limits, eos_tokens)
        )

    def _graph_window(self, params, tokens, active, limits, eos, k, keep):
        """k steps of the decode core on the card as replays of one
        captured CUDA graph over static state, captured at the first
        window (and again for other weights): that window's first step
        runs eagerly on the capture stream, which warms it, and the graph
        is captured after it. A failed capture or replay raises, and so
        does a replay while an earlier window over the same state is not
        yet reconciled (its outputs would be overwritten). Returns (the
        window, its state, a copy of the window's logits [k, max_seqs,
        V])."""
        spec = self.cache.spec
        key = ("paged" if self.paged else "slot", spec.kv_dtype, spec.max_seqs)
        weights = tuple(w.data_ptr() for ws in params.values() for w in ws)
        win = self._graphs.get(key)
        if win is not None and win.inflight:
            raise RuntimeError(
                "a decode window was dispatched while an earlier window over the same captured "
                "state is not reconciled: reconcile it first"
            )
        if win is None or win.weights != weights:
            st = _CoreState(spec.max_seqs, self._table_cols(), self.max_fused_steps, self.device,
                            adapter_cols=self._adapter_cols())
            win = self._graphs[key] = _GraphWindow(st, torch.cuda.Stream(self.device), weights)
        st = win.state
        self._load_state(st, tokens, active, limits, eos, keep)
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
        return win, st, st.logits[:k].clone()

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
    def _verify_dispatch(self, params, tokens, draft_lens, parents=None) -> InflightStep:
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
        host = [tokens, lengths, rows] + self._adapter_parts()
        if self.paged:
            ps = spec.page_size
            host += [cache.block_tables] + (quant_plan(dest, ps) if self.quantized else [dest])
        else:
            host += [dest // spec.max_len, dest % spec.max_len]
        if parents is not None:
            host.append(parents)
        keep: List[torch.Tensor] = []
        dev = _to_device(self.device, host, keep)
        # the tree mask, once per step for every layer
        allowed = tree_allowed_mask(dev.pop(), dev[1], w, spec.max_len) if parents is not None else None
        tok_t, len_t, rows_t = dev[:3]
        rows, rest = self._adapter_views(dev[3:])
        tables_t, dest_t = (rest[0], rest[1:]) if self.paged else (None, rest)
        ad = self._adapter_gather(rows)

        def hook(node, ins, ws, ctx):
            g = node.guid
            use_bias = node.params.get("bias", True)
            q, k, v = mha_project_qkv(ins, ws, ctx, use_bias=use_bias)
            q, k, v = apply_adapter_qkv(ins[0], q, k, v, ad, g)
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
            return [apply_adapter_out(attn, mha_project_out(attn, ws, ctx, use_bias=use_bias), ad, g)]

        logits = self._forward_logits(params, tok_t, hook)
        cache.begin_inflight()
        step = InflightStep(
            kind="verify" if parents is None else "verify_tree",
            active=draft_lens > 0,
            lengths=lengths,
            device_logits=logits,
            staged=keep,
        )
        # numpy has no bfloat16: a mixed-precision model's bf16 logits
        # reach the host as float32, exactly (the reference's
        # np.asarray(...).astype(np.float32))
        self._issue_readback(step, logits.float())
        return step

    def verify_dispatch(self, params, tokens: np.ndarray, draft_lens: np.ndarray) -> InflightStep:
        """Dispatch one speculative verify step (SpecInfer's scoring
        call). tokens [max_seqs, w]: column 0 is each slot's last emitted
        (not yet cached) token, columns 1..draft_lens[s]-1 its drafted
        continuation; draft_lens [max_seqs] = real rows per slot (0 for
        inactive slots). Writes the real rows' K/V (claiming paged slots'
        pages first) under the staircase mask and does NOT advance
        lengths: the caller accepts a prefix against the step's snapshot
        lengths and commits it with cache.truncate."""
        return self._verify_dispatch(params, tokens, draft_lens)

    def verify_tree_dispatch(
        self,
        params,
        tokens: np.ndarray,
        draft_lens: np.ndarray,
        parents: np.ndarray,
    ) -> InflightStep:
        """Token-tree verify: as verify_dispatch, with columns 1.. holding
        draft tree nodes in topological order and parents [max_seqs, w]
        mapping each row to its parent row (-1 for row 0, chain padding
        past draft_lens). Row j attends the committed prefix and its own
        root-to-j chain only; the mask is built once per step from
        `parents`, so every tree topology of width w runs the same
        kernels. The step carries a host copy of `parents`."""
        parents = np.asarray(parents, dtype=np.int32)
        tokens = np.asarray(tokens)
        if parents.shape != tokens.shape:
            raise ValueError(
                f"parents must match tokens shape {tokens.shape}, got {parents.shape}"
            )
        if np.any(parents >= np.arange(tokens.shape[1])[None, :]):
            raise ValueError("parents must be topological: parents[:, j] < j")
        return self._verify_dispatch(params, tokens, draft_lens, parents)

    def verify_reconcile(self, step: InflightStep) -> np.ndarray:
        """Wait for a verify step's logits and close its window. Returns
        the logits [max_seqs, w, V] on the host (float32): row [s, j] is
        the model's distribution for the token following tokens[s, j]."""
        try:
            return self._wait(step)
        finally:
            self.cache.end_inflight()

    def verify(self, params, tokens: np.ndarray, draft_lens: np.ndarray) -> np.ndarray:
        """One speculative verify step, synchronous (verify_dispatch and
        its reconcile): the logits [max_seqs, w, V] on the host."""
        return self.verify_reconcile(self.verify_dispatch(params, tokens, draft_lens))

    def verify_tree(
        self,
        params,
        tokens: np.ndarray,
        draft_lens: np.ndarray,
        parents: np.ndarray,
    ) -> np.ndarray:
        """Synchronous token-tree verify (verify_tree_dispatch and its
        reconcile): the logits [max_seqs, w, V] on the host."""
        return self.verify_reconcile(self.verify_tree_dispatch(params, tokens, draft_lens, parents))
