"""Paged multi-LoRA adapter pool, the PagedKVCache's sibling allocator
(port of flexflow_tpu/serving/tenancy/adapters.py).

S-LoRA / Punica: one base model serves many tenants by keeping each
tenant's rank-r LoRA factors for the attention projections (Q/K/V/out)
resident in pooled device tensors and gathering the right pages per
batch row inside the engine's steps. Paging runs over the RANK
dimension: a pool page holds ``page_rank`` rank slices, an adapter of
rank r occupies ``ceil(r / page_rank)`` pages, and the delta
``(x @ A) @ B`` sums exactly over pages because a LoRA product is a sum
over rank slices.

The host ledgers are the reference's: a free-page heap
(``_free_adapter_pages``), per-page refcounts (``_adapter_refcounts``:
1 for the load's ownership plus 1 per attached slot), the adapter page
tables (``adapter_tables``) and each slot's adapter (``slot_adapter``),
written only by the helpers below; ``check_invariants`` re-derives
every ledger from the tables.

Device layout per attention layer guid (``NP`` pool pages, ``pr`` =
page_rank, ``e`` = embed, ``h``/``d`` = heads/head_dim), float32, as
the reference's (``device_pools``):

- ``a_q``/``a_k``/``a_v``: ``[NP+1, e, pr]``
- ``b_q``/``b_k``/``b_v``: ``[NP+1, pr, h, d]``
- ``a_o``: ``[NP+1, h, d, pr]``; ``b_o``: ``[NP+1, pr, e]``

Row ``NP`` is the permanent zero sentinel: unused table entries point at
it, so a sentinel gather adds exactly 0.0, and rows without an adapter
take the unmodified projections through the ``torch.where`` select of
:func:`apply_adapter_qkv` / :func:`apply_adapter_out`.

Those per-layer pools are views of four tensors stacked over the layers
(``a_qkv`` [L, NP+1, e, 3, pr], ``b_qkv`` [L, NP+1, 3, pr, h*d], ``a_o``
[L, NP+1, h*d, pr], ``b_o`` [L, NP+1, pr, e]), so that a step gathers
every layer's pages of its rows once (:meth:`AdapterPool.gather`), in
the layout the deltas' batched products read, and each layer then adds
its deltas with a few products (ops/attention.py ``lora_delta_qkv`` /
``lora_delta_out``): an eager step launches a few hundred fewer small
kernels than per-layer, per-factor gathers and contractions would.

Where the reference rebinds its pools functionally on every load, the
port's pools are device tensors at fixed addresses (CUDA-graph windows
capture them by address): ``load`` writes each page in place with
copies queued on the current (serving) stream, without waiting for it.
Stream order then keeps every step already queued there, eager, chained
or a graph replay, on the old contents, and every later step reads the
new ones. ``unload`` refuses while any slot is attached, as the
reference does.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ops.attention import lora_delta_out, lora_delta_qkv


class AdapterPoolExhausted(RuntimeError):
    """Raised when a load needs more adapter pages than the pool holds."""


_AB_NAMES = ("a_q", "b_q", "a_k", "b_k", "a_v", "b_v", "a_o", "b_o")


@dataclass(frozen=True)
class AdapterPoolSpec:
    """Geometry of one adapter pool (all attention layers share it)."""

    layer_guids: Tuple[int, ...]
    max_seqs: int
    embed_dim: int
    num_heads: int
    head_dim: int
    max_adapters: int
    max_rank: int
    page_rank: int
    num_pages: int

    @property
    def pages_per_adapter(self) -> int:
        return -(-self.max_rank // self.page_rank)

    def pages_for(self, rank: int) -> int:
        return -(-rank // self.page_rank)


def default_page_rank(max_rank: int) -> int:
    """Auto page sizing: at most 4 rank slices a page, so mixed ranks
    pack without waste."""
    return max(1, min(int(max_rank), 4))


class AdapterPool:
    """Paged pool of LoRA adapter factors plus the slot -> adapter map
    the engine snapshots at dispatch.

    - ``adapter_tables`` [max_adapters, pages_per_adapter] int32: the
      pages backing each loaded adapter, the sentinel ``num_pages`` in
      unused entries.
    - ``_free_adapter_pages``: min-heap of free page ids (lowest first,
      so allocation is deterministic).
    - ``_adapter_refcounts`` [num_pages] int32: 1 while an adapter owns
      the page, +1 per slot attached to that adapter.
    - ``slot_adapter`` [max_seqs] int32: the adapter each slot serves
      (-1 = the base model).
    """

    def __init__(self, spec: AdapterPoolSpec, dtype=torch.float32, device="cpu"):
        if spec.max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1, got {spec.max_adapters}")
        if spec.max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {spec.max_rank}")
        if spec.page_rank < 1:
            raise ValueError(f"page_rank must be >= 1, got {spec.page_rank}")
        if spec.num_pages < spec.pages_per_adapter:
            raise ValueError(
                f"num_pages {spec.num_pages} cannot hold even one "
                f"max_rank adapter ({spec.pages_per_adapter} pages)"
            )
        self.spec = spec
        self.dtype = dtype
        self.device = torch.device(device)
        P = spec.pages_per_adapter
        self.adapter_tables = np.full((spec.max_adapters, P), spec.num_pages, dtype=np.int32)
        self._free_adapter_pages: List[int] = list(range(spec.num_pages))
        heapq.heapify(self._free_adapter_pages)
        self._adapter_refcounts = np.zeros(spec.num_pages, dtype=np.int32)
        self.slot_adapter = np.full(spec.max_seqs, -1, dtype=np.int32)
        self._loaded: Dict[int, int] = {}  # adapter_id -> rank
        self.loads = 0
        self.unloads = 0
        self.attaches = 0
        self.detaches = 0
        e, h, d, pr = spec.embed_dim, spec.num_heads, spec.head_dim, spec.page_rank
        L, rows = len(spec.layer_guids), spec.num_pages + 1  # + the permanent zero-sentinel row
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=self.device)
        self._stacked = {"a_qkv": zeros(L, rows, e, 3, pr), "b_qkv": zeros(L, rows, 3, pr, h * d),
                         "a_o": zeros(L, rows, h * d, pr), "b_o": zeros(L, rows, pr, e)}
        st = self._stacked
        self._layer = {g: i for i, g in enumerate(spec.layer_guids)}
        self._pools: Dict[int, Dict[str, torch.Tensor]] = {}
        for g, i in self._layer.items():
            views = {}
            for j, n in enumerate("qkv"):
                views["a_" + n] = st["a_qkv"][i, :, :, j]
                views["b_" + n] = st["b_qkv"][i, :, j].view(rows, pr, h, d)
            views["a_o"] = st["a_o"][i].view(rows, h, d, pr)
            views["b_o"] = st["b_o"][i]
            self._pools[g] = {k: views[k] for k in _AB_NAMES}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_model(
        cls,
        model,
        max_seqs: int,
        max_adapters: int = 8,
        max_rank: int = 8,
        page_rank: int = 0,
        num_pages: int = 0,
        dtype=torch.float32,
    ) -> "AdapterPool":
        """A pool sized for a compiled model, on its device: the geometry
        comes from the KV cache's own derivation, so the two allocators
        agree on the attention shape."""
        from flexflow_tpu_torch.serving.kv_cache import _derive_geometry

        guids, heads, head_dim = _derive_geometry(model)
        pr = page_rank if page_rank else default_page_rank(max_rank)
        per = -(-max_rank // pr)
        spec = AdapterPoolSpec(
            layer_guids=tuple(guids),
            max_seqs=int(max_seqs),
            embed_dim=heads * head_dim,
            num_heads=heads,
            head_dim=head_dim,
            max_adapters=int(max_adapters),
            max_rank=int(max_rank),
            page_rank=int(pr),
            num_pages=int(num_pages) if num_pages else int(max_adapters) * per,
        )
        return cls(spec, dtype=dtype, device=model.device)

    # -- ledger mutators -----------------------------------------------------

    def _pop_free_adapter_page(self) -> int:
        """The one path pages leave the free heap by."""
        if not self._free_adapter_pages:
            raise AdapterPoolExhausted(f"adapter pool dry: {self.spec.num_pages} pages all owned")
        return heapq.heappop(self._free_adapter_pages)

    def _install_adapter_page(self, adapter_id: int, pi: int, page: int):
        """Bind a popped page into an adapter's table, refcount 1 (the
        load's own reference)."""
        self.adapter_tables[adapter_id, pi] = page
        self._adapter_refcounts[page] = 1

    def _free_adapter_page(self, adapter_id: int, pi: int) -> None:
        """Unbind one table entry back to the sentinel and return the
        page to the heap (refcount 1 only: unload refuses while a slot
        holds a reference)."""
        page = int(self.adapter_tables[adapter_id, pi])
        self.adapter_tables[adapter_id, pi] = self.spec.num_pages
        self._adapter_refcounts[page] = 0
        heapq.heappush(self._free_adapter_pages, page)

    def load(self, adapter_id: int, weights, scale: float = 1.0) -> None:
        """Load one adapter's factors into pooled pages.

        ``weights``: {layer_guid: {"a_q": [e, r], "b_q": [r, e], ...}}
        (2-D host matrices; ``e`` of the b and out factors is the
        flattened head space ``h*d``). The rank comes from the factors;
        ``scale`` folds into B here. Pages are overwritten whole (the
        last zero-padded past the rank), so a recycled page never leaks
        an earlier tenant's factors. The pages are written in place on
        the current stream (module docstring)."""
        aid = int(adapter_id)
        if not 0 <= aid < self.spec.max_adapters:
            raise ValueError(f"adapter_id {aid} outside [0, {self.spec.max_adapters})")
        if aid in self._loaded:
            raise ValueError(f"adapter {aid} already loaded (unload first)")
        missing = [g for g in self.spec.layer_guids if g not in weights]
        if missing:
            raise ValueError(f"weights missing attention layers {missing}")
        rank = int(np.asarray(weights[self.spec.layer_guids[0]]["a_q"]).shape[1])
        if not 1 <= rank <= self.spec.max_rank:
            raise ValueError(f"rank {rank} outside [1, {self.spec.max_rank}]")
        e, h, d = self.spec.embed_dim, self.spec.num_heads, self.spec.head_dim
        pr = self.spec.page_rank
        n = self.spec.pages_for(rank)
        if len(self._free_adapter_pages) < n:
            raise AdapterPoolExhausted(
                f"adapter {aid} needs {n} pages, {len(self._free_adapter_pages)} free"
            )
        # every factor's shape is checked before any page is taken or written
        mats = {}
        for g in self.spec.layer_guids:
            mats[g] = {k: np.asarray(weights[g][k], dtype=np.float32) for k in _AB_NAMES}
            for k in _AB_NAMES:
                want = (e, rank) if k.startswith("a_") else (rank, e)
                if mats[g][k].shape != want:
                    raise ValueError(f"layer {g} {k}: expected {want}, got {mats[g][k].shape}")
        pages = [self._pop_free_adapter_page() for _ in range(n)]
        for pi, page in enumerate(pages):
            self._install_adapter_page(aid, pi, page)
        idx = self._to_device(np.asarray(pages, dtype=np.int64))
        for g in self.spec.layer_guids:
            m = {k: v * float(scale) if k.startswith("b_") else v for k, v in mats[g].items()}
            pool = self._pools[g]
            blk = {k: np.zeros((n, *pool[k].shape[1:]), dtype=np.float32) for k in _AB_NAMES}
            for pi in range(n):
                lo, hi = pi * pr, min(rank, (pi + 1) * pr)
                w = hi - lo
                for k in ("a_q", "a_k", "a_v"):
                    blk[k][pi, :, :w] = m[k][:, lo:hi]
                for k in ("b_q", "b_k", "b_v"):
                    blk[k][pi, :w] = m[k][lo:hi].reshape(w, h, d)
                blk["a_o"][pi, :, :, :w] = m["a_o"][:, lo:hi].reshape(h, d, w)
                blk["b_o"][pi, :w] = m["b_o"][lo:hi]
            for k in _AB_NAMES:
                pool[k].index_copy_(0, idx, self._to_device(blk[k]).to(self.dtype))
        self._loaded[aid] = rank
        self.loads += 1

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the pool's device, queued on the current stream
        without waiting for it: on the card a non_blocking copy from
        pinned memory (whose block the caching host allocator keeps
        until the copy has run)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def unload(self, adapter_id: int) -> None:
        """Return an adapter's pages to the pool. Refuses while any slot
        is attached: the engine may still gather those pages."""
        aid = int(adapter_id)
        if aid not in self._loaded:
            raise ValueError(f"adapter {aid} is not loaded")
        n = self.spec.pages_for(self._loaded[aid])
        pages = [int(self.adapter_tables[aid, pi]) for pi in range(n)]
        if any(self._adapter_refcounts[p] != 1 for p in pages):
            attached = int((self.slot_adapter == aid).sum())
            raise RuntimeError(f"adapter {aid} still attached to {attached} slot(s)")
        for pi in range(n):
            self._free_adapter_page(aid, pi)
        self._loaded.pop(aid)
        self.unloads += 1

    def attach(self, slot: int, adapter_id: int) -> None:
        """Point a slot at an adapter (-1 = base model) and pin its pages.
        The scheduler calls this at admission, before the slot's first
        prefill."""
        s = int(slot)
        if not 0 <= s < self.spec.max_seqs:
            raise ValueError(f"slot {s} outside [0, {self.spec.max_seqs})")
        if self.slot_adapter[s] != -1:
            raise RuntimeError(
                f"slot {s} already attached to adapter {int(self.slot_adapter[s])} (detach first)"
            )
        aid = int(adapter_id)
        if aid == -1:
            return
        if aid not in self._loaded:
            raise ValueError(f"adapter {aid} is not loaded")
        self.slot_adapter[s] = aid
        n = self.spec.pages_for(self._loaded[aid])
        for pi in range(n):
            self._adapter_refcounts[self.adapter_tables[aid, pi]] += 1
        self.attaches += 1

    def detach(self, slot: int) -> None:
        """Release a slot's adapter reference (idempotent for base-model
        slots). The scheduler calls this wherever the slot frees:
        finalize and preemption."""
        s = int(slot)
        aid = int(self.slot_adapter[s])
        if aid == -1:
            return
        self.slot_adapter[s] = -1
        n = self.spec.pages_for(self._loaded[aid])
        for pi in range(n):
            self._adapter_refcounts[self.adapter_tables[aid, pi]] -= 1
        self.detaches += 1

    # -- dispatch-side views -------------------------------------------------

    @property
    def device_pools(self) -> Dict[int, Dict[str, torch.Tensor]]:
        return self._pools

    @property
    def loaded(self) -> Dict[int, int]:
        """{adapter_id: rank} of the loaded adapters."""
        return dict(self._loaded)

    def gather(self, tbl: torch.Tensor, has: torch.Tensor) -> "AdapterGather":
        """One step's adapter factors for batch rows with page tables tbl
        [b, P] and flags has [b] bool (device tensors): each row's pages
        of every layer, gathered once and laid out for
        ops/attention.py's lora_delta_qkv / lora_delta_out (K = P *
        page_rank rank slices a row, its pages in order)."""
        st, idx = self._stacked, tbl.long()
        b, P = idx.shape
        L, e, K = st["a_qkv"].shape[0], self.spec.embed_dim, idx.shape[1] * self.spec.page_rank
        hd = self.spec.num_heads * self.spec.head_dim
        # [L, b, P, ...] gathers, reordered so that each product contracts
        # one contiguous run: A columns (q|k|v, page, rank), B rows (page, rank)
        a_qkv = st["a_qkv"][:, idx].permute(0, 1, 3, 4, 2, 5).reshape(L, b, e, 3 * K)
        b_qkv = st["b_qkv"][:, idx].permute(0, 1, 3, 2, 4, 5).reshape(L, b, 3, K, hd)
        a_o = st["a_o"][:, idx].permute(0, 1, 3, 2, 4).reshape(L, b, hd, K)
        b_o = st["b_o"][:, idx].reshape(L, b, K, e)
        return AdapterGather(self._layer, has, a_qkv, b_qkv, a_o, b_o)

    def slot_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tbl [max_seqs, P] int32, has [max_seqs] bool) for the
        slot-indexed steps (decode, multi-step, verify, chunk): fresh
        host arrays, which the engine snapshots at dispatch."""
        has = self.slot_adapter >= 0
        tbl = np.full((self.spec.max_seqs, self.spec.pages_per_adapter), self.spec.num_pages, dtype=np.int32)
        rows = np.nonzero(has)[0]
        if rows.size:
            tbl[rows] = self.adapter_tables[self.slot_adapter[rows]]
        return tbl, has.copy()

    def row_tables(self, slots: Sequence[int], rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tbl [rows, P], has [rows]) aligned to a prefill batch whose
        row i serves slot ``slots[i]`` (rows past len(slots) get the
        sentinel and the base model)."""
        tbl = np.full((rows, self.spec.pages_per_adapter), self.spec.num_pages, dtype=np.int32)
        has = np.zeros(rows, dtype=bool)
        for i, s in enumerate(slots):
            aid = int(self.slot_adapter[int(s)])
            if aid >= 0:
                tbl[i] = self.adapter_tables[aid]
                has[i] = True
        return tbl, has

    # -- invariants / telemetry ----------------------------------------------

    def check_invariants(self) -> None:
        """Re-derive every ledger from the tables: page ownership is
        disjoint, refcounts equal 1 + attached slots, the free heap is
        exactly the unowned pages, conservation holds, and the sentinel
        pool row is still zero."""
        spec = self.spec
        owned: Dict[int, Tuple[int, int]] = {}
        for aid in range(spec.max_adapters):
            rank = self._loaded.get(aid)
            n = spec.pages_for(rank) if rank else 0
            for pi in range(spec.pages_per_adapter):
                page = int(self.adapter_tables[aid, pi])
                if pi < n:
                    if not 0 <= page < spec.num_pages:
                        raise AssertionError(f"adapter {aid} page {pi} out of range: {page}")
                    if page in owned:
                        raise AssertionError(f"page {page} owned twice: {owned[page]} and ({aid}, {pi})")
                    owned[page] = (aid, pi)
                elif page != spec.num_pages:
                    raise AssertionError(f"adapter {aid} unused entry {pi} not sentinel: {page}")
        expected = np.zeros(spec.num_pages, dtype=np.int32)
        for page in owned:
            expected[page] = 1
        for s in range(spec.max_seqs):
            aid = int(self.slot_adapter[s])
            if aid == -1:
                continue
            if aid not in self._loaded:
                raise AssertionError(f"slot {s} attached to unloaded adapter {aid}")
            for pi in range(spec.pages_for(self._loaded[aid])):
                expected[self.adapter_tables[aid, pi]] += 1
        if not np.array_equal(self._adapter_refcounts, expected):
            bad = np.nonzero(self._adapter_refcounts != expected)[0]
            raise AssertionError(
                f"adapter refcounts diverge at pages {bad.tolist()}: "
                f"have {self._adapter_refcounts[bad].tolist()}, derived {expected[bad].tolist()}"
            )
        free = set(self._free_adapter_pages)
        if len(free) != len(self._free_adapter_pages):
            raise AssertionError("duplicate pages in the adapter free heap")
        if free & set(owned):
            raise AssertionError(f"pages both owned and free: {sorted(free & set(owned))}")
        if len(owned) + len(free) != spec.num_pages:
            raise AssertionError(
                f"adapter page conservation broken: {len(owned)} owned + {len(free)} free != {spec.num_pages}"
            )
        for g in spec.layer_guids:
            for k in _AB_NAMES:
                if bool(self._pools[g][k][spec.num_pages].any()):
                    raise AssertionError(f"layer {g} {k}: sentinel row is not zero")

    def telemetry_gauges(self) -> Dict[str, float]:
        free = len(self._free_adapter_pages)
        return {
            "adapters_loaded": float(len(self._loaded)),
            "adapter_pages_live": float(self.spec.num_pages - free),
            "adapter_pages_free": float(free),
            "adapter_slots_attached": float(int((self.slot_adapter >= 0).sum())),
        }

    def telemetry_counters(self) -> Dict[str, int]:
        return {
            "adapter_loads_total": self.loads,
            "adapter_unloads_total": self.unloads,
            "adapter_attaches_total": self.attaches,
            "adapter_detaches_total": self.detaches,
        }


# -- application inside the engine's steps ----------------------------------


@dataclass
class AdapterGather:
    """One step's adapter factors (AdapterPool.gather): stacked over the
    layers, `layer` mapping each attention guid to its index; `has` [b]
    bool marks the rows served by an adapter."""

    layer: Dict[int, int]
    has: torch.Tensor
    a_qkv: torch.Tensor  # [L, b, e, 3K]
    b_qkv: torch.Tensor  # [L, b, 3, K, h*d]
    a_o: torch.Tensor  # [L, b, h*d, K]
    b_o: torch.Tensor  # [L, b, K, e]


def apply_adapter_qkv(x, q, k, v, ad: Optional[AdapterGather], guid):
    """Add the per-row LoRA deltas to the Q/K/V projections right after
    ``mha_project_qkv``, so the K/V deltas land before the cache writes
    and the decode kernels read adapted history unchanged. ``ad`` is None
    (no pool: q, k, v come back as they are, with no op run) or the
    step's AdapterGather; a row whose ``has`` is False takes the
    unmodified elements through the select. The delta is float32, added
    to the float32 projection and cast back to its dtype (bf16 under
    mixed precision)."""
    if ad is None:
        return q, k, v
    i = ad.layer[guid]
    deltas = lora_delta_qkv(x, ad.a_qkv[i], ad.b_qkv[i])
    sel = ad.has[:, None, None, None]
    return tuple(torch.where(sel, (t.float() + dt.view(t.shape)).to(t.dtype), t) for t, dt in zip((q, k, v), deltas))


def apply_adapter_out(attn, y, ad: Optional[AdapterGather], guid):
    """Add the output projection's LoRA delta after ``mha_project_out``:
    the attention core already ran, untouched."""
    if ad is None:
        return y
    i = ad.layer[guid]
    dy = lora_delta_out(attn, ad.a_o[i], ad.b_o[i])
    return torch.where(ad.has[:, None, None], (y.float() + dy).to(y.dtype), y)


def adapter_rows(rows, slot_ids):
    """Compact a slot-indexed (tables, has) pair to a batch whose row i
    serves slot ``slot_ids[i]`` (the chunk steps)."""
    if rows is None:
        return None
    tbl, has = rows
    return tbl[slot_ids], has[slot_ids]


# -- test / benchmark weights --------------------------------------------------


def make_lora_weights(spec: AdapterPoolSpec, rank: int, seed: int = 0):
    """Deterministic random LoRA factors shaped for :meth:`AdapterPool
    .load`: the reference's draws, bit for bit (np.random.default_rng
    of `seed`, the same order)."""
    rng = np.random.default_rng(seed)
    e = spec.embed_dim
    weights = {}
    for g in spec.layer_guids:
        weights[g] = {
            k: rng.standard_normal((e, rank)).astype(np.float32) * 0.1
            if k.startswith("a_")
            else rng.standard_normal((rank, e)).astype(np.float32) * 0.1
            for k in _AB_NAMES
        }
    return weights
