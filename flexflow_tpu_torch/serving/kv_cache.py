"""KV caches for the serving engine: slot-contiguous and block-paged
(port of the single-host part of flexflow_tpu/serving/kv_cache.py).

* `KVCache` — one pair of `[max_seqs, max_len, heads, head_dim]` tensors
  per attention layer; a slot is one row of the leading dim.
* `PagedKVCache` — PagedAttention pools `[num_pages, page_size, heads,
  head_dim]`, a host-side free-page allocator and per-slot block tables
  (`[max_seqs, max_pages_per_seq]` int32, padded with the sentinel
  `num_pages`). Admission uses the reference's *reserve* policy by default: a
  request is admitted only when the free pool covers its worst case on
  top of every in-flight request's outstanding worst case, so a decode
  can always claim its next page.

The reference's arrays are functional: each jitted step returns fresh
ones and `commit` swaps them in. Here the pools are written in place:
`commit` scatters a step's new K/V rows into the cache tensors at
explicit, masked destinations (torch raises on an out-of-bounds index
where JAX silently drops the write). Each cache also keeps one scratch
row past its visible tensors (the slot layout's flat row max_seqs *
max_len, the pools' page num_pages, which is the block tables' sentinel
and no table maps): the device-resident decode step sends the rows of
dead and masked slots there, so a fixed-shape step never needs a host
branch and no dead row aliases a live one. `k_store`/`v_store` (and the
int8 `k_scale_store`/`v_scale_store`) are the whole tensors, scratch
included; `k`/`v` (and `k_scale`/`v_scale`) are their visible views,
which every kernel reads. Under `kv_dtype="int8"` the paged
pools hold int8 rows with one fp32 scale per (page, head) in the side
pools `k_scale`/`v_scale` [num_pages, heads]; the engine's
`_quant_scatter` writes them. `truncate` is speculative decoding's
rollback on both layouts: it moves a slot's visible length, compacts a
token tree's accepted rows into contiguous positions, and on the paged
layout returns pages past the new length to the pool under the reserve
ledger.

The paged cache also takes the reference's two other admission tools:

  * **optimistic admission** (`alloc(..., optimistic=True)`): a slot is
    admitted on the pages its sequence fills now and reserves nothing;
    a later claim that would eat into other slots' reserve raises
    PagePoolExhausted, which the scheduler answers by preempting.
  * **prefix cache** (`prefix_cache=True`): every full page is keyed by a
    hash chained over its tokens and all before it; `alloc_shared` maps
    the registered pages matching a prefix of a new sequence (refcounted)
    and parks the slot's length past them, and the first write into a
    shared page copies it (`_cow_page`: its K/V rows in every layer, and
    its per-head scales on int8 pools) unless the slot is its last
    holder. Pages return to the pool when their last reference drops.
  * **published-prefix eviction** (`prefix_evict="lru"`): a published
    page whose last reference drops is kept, still matchable, as an
    eviction candidate; when the free heap runs dry the least recently
    released one is unpublished and reused, before any live request is
    preempted, and a new admission that matches it maps it again at no
    cost to the pool.

Both caches take the async loop's in-flight window
(`begin_inflight` at a step's dispatch, `end_inflight` at its
reconcile, in dispatch order). The slot layout only counts them. On the
paged layout a page released while a window is open (a retire, a
preemption, a verify's rollback) goes to `_limbo`, tagged with the
newest open window, and returns to the free heap when that window
closes: a step still in flight may write rows through its table
snapshot, and the page must not reach a new owner before it has.
Retained prefix pages carry the same tag and become evictable only once
their window has closed.

Swap-to-host, cost-priced eviction and host partitions are not ported
yet (ROADMAP, Port queue: serving features).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.core.types import OperatorType


class PagePoolExhausted(RuntimeError):
    """The free-page pool cannot supply a page a sequence needs now —
    under the reserve policy, an allocator invariant was violated."""


def default_buckets(max_len: int, smallest: int = 16) -> Tuple[int, ...]:
    """Powers of two from `smallest` up to (and including) max_len."""
    out = []
    b = smallest
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def default_page_size(max_len: int, target: int = 16) -> int:
    """Largest power of two <= target that divides max_len (vLLM's
    default block size is 16; halve until the geometry is divisible)."""
    ps = target
    while ps > 1 and max_len % ps:
        ps //= 2
    return ps


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static geometry of the cache, derived from the compiled model.
    page_size == 0 means the slot-contiguous layout."""

    layer_guids: Tuple[int, ...]  # MHA node guids, topo order
    max_seqs: int
    max_len: int
    num_heads: int
    head_dim: int
    buckets: Tuple[int, ...]
    page_size: int = 0
    num_pages: int = 0
    kv_dtype: str = "fp32"  # "fp32" | "int8" (paged layout only)

    def bucket(self, length: int) -> int:
        """Smallest bucket >= length (prefill pad target)."""
        for b in self.buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt length {length} exceeds max_len {self.max_len}")

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    @property
    def max_pages_per_seq(self) -> int:
        if not self.paged:
            raise ValueError("max_pages_per_seq is a paged-layout property")
        return self.max_len // self.page_size


def _derive_geometry(model):
    """(layer_guids, heads, head_dim) from a compiled FFModel; every
    attention layer must agree on (heads, head_dim)."""
    if model.executor is None:
        raise RuntimeError("compile() the model before building a KV cache")
    graph = model.graph
    guids = [
        g
        for g in model.executor.topo
        if graph.nodes[g].op_type == OperatorType.MULTIHEAD_ATTENTION
    ]
    if not guids:
        raise ValueError("model has no attention layers to cache")
    geom = {
        (
            int(graph.nodes[g].params["num_heads"]),
            int(graph.nodes[g].params["embed_dim"]) // int(graph.nodes[g].params["num_heads"]),
        )
        for g in guids
    }
    if len(geom) != 1:
        raise ValueError(f"attention layers disagree on (heads, head_dim): {geom}")
    heads, head_dim = geom.pop()
    return guids, heads, head_dim


def _compaction(new_len: int, src_rows: Sequence[int], max_len: int):
    """(sources, destinations) int64 arrays of a tree commit's row moves:
    the accepted rows at `src_rows` go to [new_len - len(src_rows),
    new_len). Positions are non-decreasing and each source sits at or
    after its destination (topological node order guarantees both).
    None when every row is already in place (a chain)."""
    srcs = [int(p) for p in src_rows]
    dests = list(range(new_len - len(srcs), new_len))
    if dests[0] < 0:
        raise ValueError(f"{len(srcs)} compacted rows do not fit under new_len {new_len}")
    for s, d in zip(srcs, dests):
        if not d <= s < max_len:
            raise ValueError(f"source row {s} outside [{d}, {max_len})")
    if srcs == dests:
        return None
    return np.asarray(srcs, dtype=np.int64), np.asarray(dests, dtype=np.int64)


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index array on `device` without waiting for the stream: on
    the card a non_blocking copy from pinned memory (the async loop may
    have a step in flight when a commit moves rows)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _stores(guids, rows: int, row_shape, dtype, device):
    """One zeroed [rows + 1, *row_shape] tensor per layer: the visible
    rows and the scratch row after them."""
    return {g: torch.zeros((rows + 1, *row_shape), dtype=dtype, device=device) for g in guids}


class KVCache:
    """Slot-contiguous cache tensors + host-side slot bookkeeping."""

    paged = False

    def __init__(self, spec: KVCacheSpec, dtype: torch.dtype, device):
        self.spec = spec
        self.dtype = dtype
        self.device = torch.device(device)
        shape = (spec.max_seqs, spec.max_len, spec.num_heads, spec.head_dim)
        # flat [max_seqs * max_len + 1, heads, head_dim]: slot s's position
        # p is row s * max_len + p; the last row is the scratch row
        self.scratch_row = spec.max_seqs * spec.max_len
        rows = (spec.num_heads, spec.head_dim)
        self.k_store = _stores(spec.layer_guids, self.scratch_row, rows, dtype, self.device)
        self.v_store = _stores(spec.layer_guids, self.scratch_row, rows, dtype, self.device)
        self.k: Dict[int, torch.Tensor] = {g: t[:-1].view(shape) for g, t in self.k_store.items()}
        self.v: Dict[int, torch.Tensor] = {g: t[:-1].view(shape) for g, t in self.v_store.items()}
        # lengths[i] = tokens currently cached in slot i; _free is a
        # min-heap so alloc pops the lowest free id (deterministic reuse)
        self.lengths = np.zeros(spec.max_seqs, dtype=np.int32)
        self._free: List[int] = list(range(spec.max_seqs))
        self._active: set = set()
        self._inflight_depth = 0

    # -- in-flight window (async dispatch) -------------------------------------

    def begin_inflight(self) -> None:
        """Open an in-flight window (a dispatched step not yet
        reconciled). The slot layout pins nothing: a stale row an
        in-flight step writes for a retired slot lands at a position the
        next occupant overwrites before its length exposes it."""
        self._inflight_depth += 1

    def end_inflight(self) -> None:
        if self._inflight_depth <= 0:
            raise RuntimeError("end_inflight without a matching begin_inflight")
        self._inflight_depth -= 1

    @property
    def pinned_pages(self) -> int:
        """Signature parity with PagedKVCache: the slot layout pins nothing."""
        return 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(
        self, prompt_len: Optional[int] = None, total_len: Optional[int] = None, optimistic: bool = False
    ) -> Optional[int]:
        """Take the lowest free slot (None when full): every slot holds
        max_len positions, so the lengths and the policy (accepted for
        signature parity with PagedKVCache) cannot change the verdict."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._active.add(slot)
        self.lengths[slot] = 0
        return slot

    def claim(self, slot: int) -> None:
        """Allocate one specific free slot: the small-model draft keeps its
        cache slot-aligned with the target's (serving/spec.py
        ModelDraftProposer), mirroring the target's admission."""
        if slot in self._active:
            raise ValueError(f"slot {slot} is already active")
        if slot not in self._free:
            raise ValueError(f"slot {slot} is not a valid free slot")
        self._free.remove(slot)
        heapq.heapify(self._free)
        self._active.add(slot)
        self.lengths[slot] = 0

    def free(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        self._active.remove(slot)
        self.lengths[slot] = 0
        heapq.heappush(self._free, slot)

    def commit(self, g: int, slots: torch.Tensor, positions: torch.Tensor, k_rows, v_rows) -> None:
        """Write K/V rows of layer `g` in place at (slots, positions) —
        index tensors broadcast against each other and against the rows'
        leading dims. Callers pass only rows that belong in the cache."""
        self.k[g].index_put_((slots, positions), k_rows.to(self.dtype))
        self.v[g].index_put_((slots, positions), v_rows.to(self.dtype))

    def truncate(self, slot: int, new_len: int, src_rows: Optional[Sequence[int]] = None) -> None:
        """Set the slot's visible length to `new_len` (speculative-decode
        rollback: verify writes every draft row, acceptance keeps a
        prefix; new_len may also exceed the current length, since verify
        commits through this call). Rows past new_len stay as stale data
        that the lengths mask hides. src_rows (tree-verify commit): the
        accepted root-to-leaf rows' absolute positions, in path order,
        compacted into [new_len - len(src_rows), new_len) first."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        if not 0 <= new_len <= self.spec.max_len:
            raise ValueError(f"new_len {new_len} outside [0, {self.spec.max_len}]")
        if src_rows is not None and len(src_rows):
            moves = _compaction(new_len, src_rows, self.spec.max_len)
            if moves is not None:
                si, di = (_index(m, self.device) for m in moves)
                for g in self.spec.layer_guids:
                    # the gather on the right copies before the scatter
                    self.k[g][slot, di] = self.k[g][slot, si]
                    self.v[g][slot, di] = self.v[g][slot, si]
        self.lengths[slot] = new_len

    def check_invariants(self) -> None:
        """Assert the slot bookkeeping is consistent."""
        spec = self.spec
        assert self._active.isdisjoint(self._free)
        assert len(self._active) + len(self._free) == spec.max_seqs
        for s in self._free:
            assert self.lengths[s] == 0
        for s in self._active:
            assert 0 <= self.lengths[s] <= spec.max_len

    @staticmethod
    def from_model(model, max_seqs: int, max_len: int, dtype=torch.float32, buckets=None) -> "KVCache":
        guids, heads, head_dim = _derive_geometry(model)
        spec = KVCacheSpec(
            layer_guids=tuple(guids),
            max_seqs=max_seqs,
            max_len=max_len,
            num_heads=heads,
            head_dim=head_dim,
            buckets=tuple(buckets) if buckets else default_buckets(max_len),
        )
        return KVCache(spec, dtype, model.device)


class PagedKVCache:
    """Block-paged pools + host-side page allocator and block tables
    (reserve or optimistic admission, an optional prefix cache, single
    host)."""

    paged = True

    def __init__(
        self, spec: KVCacheSpec, dtype: torch.dtype, device, prefix_cache: bool = False, prefix_evict: str = "none"
    ):
        if not spec.paged:
            raise ValueError("PagedKVCache needs a spec with page_size > 0")
        if prefix_evict not in ("none", "lru"):
            raise ValueError(f"prefix_evict must be 'none' or 'lru', got {prefix_evict!r}")
        if spec.max_len % spec.page_size:
            raise ValueError(
                f"max_len {spec.max_len} is not divisible by page_size {spec.page_size}"
            )
        if spec.num_pages < spec.max_len // spec.page_size:
            raise ValueError(
                f"num_pages {spec.num_pages} cannot hold even one max_len "
                f"sequence ({spec.max_len // spec.page_size} pages of {spec.page_size})"
            )
        if spec.kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype must be 'fp32' or 'int8', got {spec.kv_dtype!r}")
        self.quantized = spec.kv_dtype == "int8"
        if self.quantized:
            dtype = torch.int8
        self.spec = spec
        self.dtype = dtype
        self.device = torch.device(device)
        # [num_pages + 1, page_size, heads, head_dim]: page num_pages (the
        # tables' sentinel) is the scratch page
        self.scratch_row = spec.num_pages * spec.page_size
        page = (spec.page_size, spec.num_heads, spec.head_dim)
        guids = spec.layer_guids
        self.k_store = _stores(guids, spec.num_pages, page, dtype, self.device)
        self.v_store = _stores(guids, spec.num_pages, page, dtype, self.device)
        self.k: Dict[int, torch.Tensor] = {g: t[:-1] for g, t in self.k_store.items()}
        self.v: Dict[int, torch.Tensor] = {g: t[:-1] for g, t in self.v_store.items()}
        # int8 side pools: fp32 scale per (page, head); 0 marks a page
        # whose first row has not been written (the engine's scatter
        # claims it). Empty under fp32.
        qguids = guids if self.quantized else ()
        heads = (spec.num_heads,)
        self.k_scale_store = _stores(qguids, spec.num_pages, heads, torch.float32, self.device)
        self.v_scale_store = _stores(qguids, spec.num_pages, heads, torch.float32, self.device)
        self.k_scale: Dict[int, torch.Tensor] = {g: t[:-1] for g, t in self.k_scale_store.items()}
        self.v_scale: Dict[int, torch.Tensor] = {g: t[:-1] for g, t in self.v_scale_store.items()}
        self.lengths = np.zeros(spec.max_seqs, dtype=np.int32)
        self.block_tables = np.full(
            (spec.max_seqs, spec.max_pages_per_seq), spec.num_pages, dtype=np.int32
        )
        # min-heaps: alloc pops the lowest free slot/page id
        self._free_slots: List[int] = list(range(spec.max_seqs))
        self._free_pages: List[int] = list(range(spec.num_pages))
        self._active: set = set()
        # reserve ledger: _max_pages[s] is slot s's worst-case page need
        # (fixed at admission), _held[s] what it holds now; _reserved =
        # sum of (max - held) over active slots — pages the free list
        # keeps back for in-flight growth
        self._held = np.zeros(spec.max_seqs, dtype=np.int64)
        self._max_pages = np.zeros(spec.max_seqs, dtype=np.int64)
        self._reserved = 0
        # optimistic slots keep _max_pages pinned to their owned pages and
        # never touch _reserved
        self._optimistic: set = set()
        # prefix sharing: per-page reference counts (re-derivable from the
        # tables), the per-entry shared flag (the mapping aliases a page
        # another request wrote: the first write through it copies), the
        # per-slot shared count and the hash index (chained key -> page,
        # with its inverse). The reserve ledger prices OWNED pages
        # (_held - _shared): a shared mapping costs nothing until it copies
        self.prefix_cache = bool(prefix_cache)
        self._refcounts = np.zeros(spec.num_pages, dtype=np.int32)
        self._entry_shared = np.zeros((spec.max_seqs, spec.max_pages_per_seq), dtype=bool)
        self._shared = np.zeros(spec.max_seqs, dtype=np.int64)
        self._prefix_index: Dict[bytes, int] = {}
        self._page_keys: Dict[int, bytes] = {}
        self.prefix_hits = 0  # admissions that mapped >= 1 shared page
        self.cow_copies = 0  # divergent writes that copied a page
        # published-prefix eviction: page -> (LRU stamp, the window open
        # at its release) for each retained publication-only page
        # (refcount 0, off the free heap, still in the hash index)
        self.prefix_evict = prefix_evict
        self._pub_only: Dict[int, Tuple[int, int]] = {}
        self._evict_tick = 0
        self.prefix_evictions = 0
        # in-flight windows: ids up to _window_seq were opened, up to
        # _window_closed reconciled; _limbo holds (page, window id) of
        # each page released while a window was open
        self._window_seq = 0
        self._window_closed = 0
        self._limbo: List[Tuple[int, int]] = []

    # -- in-flight window (async dispatch) -------------------------------------

    @property
    def _inflight_depth(self) -> int:
        return self._window_seq - self._window_closed

    def begin_inflight(self) -> None:
        """Open an in-flight window: a dispatched step holds a snapshot of
        the block tables, so a page released from now on is pinned until
        every step dispatched before the release has reconciled."""
        self._window_seq += 1

    def end_inflight(self) -> None:
        """Close the oldest open window (steps reconcile in dispatch
        order); the limbo pages waiting only on it return to the heap."""
        if self._window_closed >= self._window_seq:
            raise RuntimeError("end_inflight without a matching begin_inflight")
        self._window_closed += 1
        if self._limbo:
            kept = []
            for p, wid in self._limbo:
                if wid <= self._window_closed:
                    heapq.heappush(self._free_pages, p)
                else:
                    kept.append((p, wid))
            self._limbo = kept

    @property
    def pinned_pages(self) -> int:
        """Pages released inside an open window, unavailable until the
        steps that may still write them reconcile."""
        return len(self._limbo)

    def _release_page(self, page: int) -> None:
        if self._window_seq > self._window_closed:
            self._limbo.append((page, self._window_seq))
        else:
            heapq.heappush(self._free_pages, page)

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def num_free_pages(self) -> int:
        """Pages on the free heap (pinned and retained pages are not)."""
        return len(self._free_pages)

    def _pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.spec.page_size)

    def _owned(self, slot: int) -> int:
        """Pages the slot holds that came from the free pool (its shared
        mappings alias pages other requests own)."""
        return int(self._held[slot]) - int(self._shared[slot])

    def _avail(self) -> int:
        """Admission headroom: free pages plus evictable retained prefix
        pages minus the growth reserve. Pinned pages do not count, so a
        view one step stale only under-promises."""
        return len(self._free_pages) + self._evictable_count() - self._reserved

    def _evictable_count(self) -> int:
        """Retained prefix pages whose window has closed."""
        return sum(1 for _, wid in self._pub_only.values() if wid <= self._window_closed)

    def _evict_prefix_page(self) -> None:
        """Unpublish the least recently released evictable prefix page
        and push it onto the free heap."""
        cands = [(stamp, p) for p, (stamp, wid) in self._pub_only.items() if wid <= self._window_closed]
        if not cands:
            raise PagePoolExhausted("no evictable publication-only page")
        _, page = min(cands)
        del self._pub_only[page]
        key = self._page_keys.pop(page, None)
        if key is not None and self._prefix_index.get(key) == page:
            del self._prefix_index[key]
        heapq.heappush(self._free_pages, page)
        self.prefix_evictions += 1

    def _pop_free_page(self) -> int:
        """The one pop of the free heap: a dry heap first evicts a
        retained prefix page, so live requests are served from idle
        published pages before anyone is preempted."""
        if not self._free_pages:
            self._evict_prefix_page()
        return heapq.heappop(self._free_pages)

    def can_admit(self, prompt_len: int = 1, total_len: int = 0, optimistic: bool = False) -> bool:
        """True when a slot is free and the free pool covers this
        request's need on top of every in-flight reservation: its worst
        case under the reserve policy, the pages its prompt fills now
        under the optimistic one."""
        need = self._pages_for(prompt_len if optimistic else max(prompt_len, total_len))
        return bool(self._free_slots) and self._avail() >= need

    def alloc(
        self, prompt_len: Optional[int] = None, total_len: Optional[int] = None, optimistic: bool = False
    ) -> Optional[int]:
        """Admit a sequence: take a slot, allocate the pages its prompt
        fills now and (reserve policy) reserve the rest of its worst case.
        None when the policy refuses. `optimistic` reserves nothing past
        the prompt's pages. Omitted lengths reserve and fill max_len."""
        spec = self.spec
        if prompt_len is None:
            prompt_len = spec.max_len
        total = max(prompt_len, total_len if total_len is not None else 0)
        if total > spec.max_len:
            raise ValueError(f"sequence of {total} tokens exceeds max_len {spec.max_len}")
        if not self.can_admit(prompt_len, total, optimistic):
            return None
        need_now = self._pages_for(prompt_len)
        slot = heapq.heappop(self._free_slots)
        self._active.add(slot)
        for i in range(need_now):
            self._install_page(slot, i, self._pop_free_page())
        self._held[slot] = need_now
        if optimistic:
            self._optimistic.add(slot)
            self._max_pages[slot] = need_now
        else:
            self._max_pages[slot] = self._pages_for(total)
            self._reserved += int(self._max_pages[slot]) - need_now
        self.lengths[slot] = 0
        return slot

    # -- prefix sharing (hashed page cache + copy-on-write) --------------------

    def _install_page(self, slot: int, pi: int, page: int) -> None:
        """Map a freshly popped page into a table entry (refcount 1)."""
        self.block_tables[slot, pi] = page
        self._refcounts[page] = 1

    def _incref(self, slot: int, pi: int, page: int) -> None:
        """Map a live (or retained) page as a SHARED entry of `slot`; a
        retained page is live again and no longer an eviction candidate."""
        self.block_tables[slot, pi] = page
        self._refcounts[page] += 1
        self._entry_shared[slot, pi] = True
        self._shared[slot] += 1
        self._pub_only.pop(page, None)

    def _decref_page(self, page: int) -> None:
        """Drop one reference. Under prefix_evict="lru" the last one of a
        published page retains it as an eviction candidate; otherwise it
        unpublishes the page and releases it (through limbo while a
        window is open)."""
        self._refcounts[page] -= 1
        assert self._refcounts[page] >= 0
        if self._refcounts[page] == 0:
            if self.prefix_evict != "none" and page in self._page_keys:
                self._evict_tick += 1
                self._pub_only[page] = (self._evict_tick, self._window_seq)
                return
            key = self._page_keys.pop(page, None)
            if key is not None and self._prefix_index.get(key) == page:
                del self._prefix_index[key]
            self._release_page(page)

    def _decref_entry(self, slot: int, pi: int) -> None:
        """Clear one table entry: sentinel the mapping, settle the shared
        flag and the held count, and drop the page's reference."""
        page = int(self.block_tables[slot, pi])
        if page == self.spec.num_pages:
            return
        self.block_tables[slot, pi] = self.spec.num_pages
        self._held[slot] -= 1
        if self._entry_shared[slot, pi]:
            self._entry_shared[slot, pi] = False
            self._shared[slot] -= 1
        self._decref_page(page)

    @staticmethod
    def _chain_key(prev: bytes, tokens) -> bytes:
        """Key of a full page holding `tokens`, chained on the previous
        page's key: equal keys mean equal content and equal prefix, which
        is what makes a page's K/V rows reusable."""
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.asarray(tokens, dtype=np.int64).tobytes())
        return h.digest()

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Longest run of registered pages covering a prefix of `tokens`
        (full pages only). Read-only."""
        pages: List[int] = []
        if not self.prefix_cache:
            return pages
        ps = self.spec.page_size
        key = b""
        for i in range(len(tokens) // ps):
            key = self._chain_key(key, tokens[i * ps : (i + 1) * ps])
            page = self._prefix_index.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def register_prefix(self, slot: int, tokens: Sequence[int], upto) -> None:
        """Publish the slot's full pages covering tokens[:upto] (capped at
        its visible length, so only written pages) so later admissions can
        map them. Idempotent; a content collision keeps the page already
        in the index."""
        if not self.prefix_cache:
            return
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        ps = self.spec.page_size
        upto = min(int(upto), len(tokens), int(self.lengths[slot]))
        key = b""
        for i in range(upto // ps):
            key = self._chain_key(key, tokens[i * ps : (i + 1) * ps])
            page = int(self.block_tables[slot, i])
            if page == self.spec.num_pages:
                break
            if key in self._prefix_index or page in self._page_keys:
                continue
            self._prefix_index[key] = page
            self._page_keys[page] = key

    def alloc_shared(
        self,
        tokens: Sequence[int],
        prompt_len: Optional[int] = None,
        total_len: Optional[int] = None,
        optimistic: bool = False,
    ) -> Optional[Tuple[int, int]]:
        """Admit a sequence with prefix sharing: registered pages matching
        a prefix of `tokens` are mapped (refcounted) instead of allocated;
        returns (slot, cursor), the cursor past the shared content, where
        the slot's length is parked. At least one token is always left to
        recompute (the request needs its sampling logits), so a
        whole-sequence match gets cursor len(tokens) - 1 and its first
        write copies the last shared page. `prompt_len` is the span
        allocated now (0 under chunked prefill). Plain `alloc` with cursor
        0 when the prefix cache is off; None when admission is refused."""
        spec = self.spec
        ntok = len(tokens)
        if prompt_len is None:
            prompt_len = ntok
        total = max(ntok, prompt_len, total_len if total_len is not None else 0)
        if total > spec.max_len:
            raise ValueError(f"sequence of {total} tokens exceeds max_len {spec.max_len}")
        if not self.prefix_cache:
            slot = self.alloc(prompt_len, total, optimistic=optimistic)
            return None if slot is None else (slot, 0)
        ps = spec.page_size
        matched = self.match_prefix(tokens)
        m = len(matched)
        cursor = min(m * ps, max(0, ntok - 1))
        # fresh pages now: the unshared rest of the eager span; the worst
        # case over the slot's life: every page from the cursor's on (the
        # cursor's page copies when it is still shared)
        fresh_now = max(0, self._pages_for(prompt_len) - m)
        max_p = self._pages_for(total) - cursor // ps
        # matched retained pages are about to be mapped, not evicted: the
        # headroom they give as candidates is not there for this admission
        avail = self._avail() - sum(1 for page in matched if page in self._pub_only)
        if not self._free_slots or avail < (fresh_now if optimistic else max_p):
            return None
        slot = heapq.heappop(self._free_slots)
        self._active.add(slot)
        for i, page in enumerate(matched):
            self._incref(slot, i, page)
        for i in range(m, m + fresh_now):
            self._install_page(slot, i, self._pop_free_page())
        self._held[slot] = m + fresh_now
        if optimistic:
            self._optimistic.add(slot)
            self._max_pages[slot] = fresh_now
        else:
            self._max_pages[slot] = max_p
            self._reserved += max_p - fresh_now
        self.lengths[slot] = cursor
        if m:
            self.prefix_hits += 1
        return slot, cursor

    def _claimable(self, slot: int) -> None:
        """Raise PagePoolExhausted unless `slot` may take one more page
        from the pool: an optimistic slot only from the headroom above the
        reserve, a reserve slot from its own reserve."""
        if slot in self._optimistic:
            if self._avail() < 1:
                raise PagePoolExhausted(
                    f"free-page pool exhausted: optimistic slot {slot} needs a page "
                    f"but {len(self._free_pages)} free - {self._reserved} reserved "
                    "leaves none"
                )
        elif not self._free_pages and not self._evictable_count():
            if self._limbo:
                raise PagePoolExhausted(
                    f"free-page pool exhausted: {len(self._limbo)} pages pinned by an "
                    "in-flight step — reconcile the pipeline to release them"
                )
            raise PagePoolExhausted(
                "free-page pool exhausted despite the admission reserve — "
                "allocator invariant violated"
            )

    def _cow_page(self, slot: int, pi: int) -> None:
        """First write into a shared mapping: take the page over when this
        slot is its last holder (the content is about to diverge, so the
        index stops advertising it), else pop a fresh page, copy the shared
        page's K/V rows (and, on int8 pools, its per-head scales) in every
        layer, and remap the entry; other holders keep the old page."""
        page = int(self.block_tables[slot, pi])
        if self._refcounts[page] > 1:
            self._claimable(slot)
            new = self._pop_free_page()
            for g in self.spec.layer_guids:
                self.k[g][new] = self.k[g][page]
                self.v[g][new] = self.v[g][page]
                if self.quantized:
                    self.k_scale[g][new] = self.k_scale[g][page]
                    self.v_scale[g][new] = self.v_scale[g][page]
            self.block_tables[slot, pi] = new
            self._refcounts[new] = 1
            self._refcounts[page] -= 1
            self.cow_copies += 1
        else:
            key = self._page_keys.pop(page, None)
            if key is not None and self._prefix_index.get(key) == page:
                del self._prefix_index[key]
        self._entry_shared[slot, pi] = False
        self._shared[slot] -= 1
        if slot in self._optimistic:
            self._max_pages[slot] = self._owned(slot)
        elif self._owned(slot) <= self._max_pages[slot]:
            self._reserved -= 1

    def ensure_position(self, slot: int, pos: int) -> None:
        """Make position `pos` of `slot` writable: claim the page when the
        sequence crosses a page boundary (the admission reserve guarantees
        a reserve slot's claim; an optimistic slot's raises
        PagePoolExhausted when it would eat into the reserve, the
        scheduler's cue to preempt), and copy a shared page before its
        first write. Every step claims its write positions here, which
        makes this the one copy-on-write seam."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        pi = pos // self.spec.page_size
        if self.block_tables[slot, pi] != self.spec.num_pages:
            if self._entry_shared[slot, pi]:
                self._cow_page(slot, pi)
            return
        self._claimable(slot)
        self._install_page(slot, pi, self._pop_free_page())
        self._held[slot] += 1
        if slot in self._optimistic:
            self._max_pages[slot] = self._owned(slot)
        elif self._owned(slot) <= self._max_pages[slot]:
            self._reserved -= 1

    def free(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        self._active.remove(slot)
        owned = self._owned(slot)
        for pi in range(self.spec.max_pages_per_seq):
            self._decref_entry(slot, pi)
        if slot in self._optimistic:
            self._optimistic.discard(slot)
        else:
            self._reserved -= max(0, int(self._max_pages[slot]) - owned)
        self._held[slot] = 0
        self._max_pages[slot] = 0
        self.lengths[slot] = 0
        heapq.heappush(self._free_slots, slot)

    def commit(self, g: int, dest: torch.Tensor, k_rows, v_rows) -> None:
        """Write K/V rows of layer `g` in place at flat pool rows `dest`
        (page * page_size + offset). Callers pass only rows whose
        destination is an allocated page."""
        spec = self.spec
        flat = (-1, spec.num_heads, spec.head_dim)
        self.k[g].view(flat).index_put_((dest,), k_rows.reshape(flat).to(self.dtype))
        self.v[g].view(flat).index_put_((dest,), v_rows.reshape(flat).to(self.dtype))

    def truncate(self, slot: int, new_len: int, src_rows: Optional[Sequence[int]] = None) -> None:
        """Set the slot's visible length to `new_len` and return every
        page past ceil(new_len / page_size) to the free list — the
        speculative-decode rollback. Returned pages go back under the
        slot's admission reserve (`_reserved` grows by the pages released,
        capped at the slot's worst case), so a later re-growth still finds
        them. new_len may exceed the current length but never the pages
        the slot holds. src_rows: see KVCache.truncate; the rows move
        through the block table before any page is released."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        spec = self.spec
        if not 0 <= new_len <= spec.max_len:
            raise ValueError(f"new_len {new_len} outside [0, {spec.max_len}]")
        keep = self._pages_for(new_len)
        if keep > self._held[slot]:
            raise ValueError(
                f"new_len {new_len} needs {keep} pages but slot {slot} "
                f"holds {int(self._held[slot])}"
            )
        if src_rows is not None and len(src_rows):
            moves = _compaction(new_len, src_rows, spec.max_len)
            if moves is not None:
                self._compact_rows(slot, *moves)
        old_resv = max(0, int(self._max_pages[slot]) - self._owned(slot))
        for pi in range(keep, spec.max_pages_per_seq):
            self._decref_entry(slot, pi)
        if slot in self._optimistic:
            # released pages return to the common pool, not a reserve
            self._max_pages[slot] = self._owned(slot)
        else:
            self._reserved += max(0, int(self._max_pages[slot]) - self._owned(slot)) - old_resv
        self.lengths[slot] = new_len

    def _compact_rows(self, slot: int, srcs: np.ndarray, dests: np.ndarray) -> None:
        """Move rows at positions `srcs` to `dests` of `slot`, resolving
        both through the block table. On int8 pools each moved row is
        dequantized with its source page's scale and requantized under
        its destination page's; a destination page whose FIRST row is
        among the moves re-derives its scale from that row (the
        _quant_scatter claim rule), so the committed bytes match a
        sequential decode of the accepted path up to the int8 round trip.
        All gathers run before any scatter."""
        spec = self.spec
        ps = spec.page_size
        pages = self.block_tables[slot]
        for pos in np.concatenate([srcs, dests]):
            if pages[pos // ps] == spec.num_pages:
                raise ValueError(f"slot {slot} position {int(pos)} has no mapped page")
        sf = pages[srcs // ps].astype(np.int64) * ps + srcs % ps
        df = pages[dests // ps].astype(np.int64) * ps + dests % ps
        first = np.nonzero(df % ps == 0)[0]  # moves onto a page's first row
        si, di, spi, dpi, fi, fpi = (
            _index(a, self.device)
            for a in (sf, df, sf // ps, df // ps, first, df[first] // ps)
        )
        flat = (-1, spec.num_heads, spec.head_dim)
        for g in spec.layer_guids:
            for pool, scale in (
                (self.k[g], self.k_scale.get(g)), (self.v[g], self.v_scale.get(g))
            ):
                f = pool.view(flat)
                if scale is None:
                    f[di] = f[si]
                    continue
                deq = f[si].float() * scale[spi][:, :, None]
                scale[fpi] = deq[fi].abs().amax(dim=-1) / 127.0
                s = scale[dpi]
                safe = torch.where(s > 0, s, torch.ones_like(s))
                f[di] = torch.round(deq / safe[:, :, None]).clamp_(-127, 127).to(torch.int8)

    def check_invariants(self) -> None:
        """Assert the allocator's accounting re-derives from the block
        tables: the refcounts equal the tables' references and a page has
        at most one owning (unshared) mapping; every page is live, on the
        free heap, pinned in limbo or retained as a published-only page,
        exactly one of them; per-slot ledgers match the tables and visible
        lengths fit the held pages; the hash index advertises live or
        retained pages only, bijectively; limbo exists only inside a
        window; the reserve re-derives over reserve slots' owned pages and
        never promises pages the pool (limbo and retained pages included)
        lacks; optimistic slots carry no reserve. Holds inside an
        in-flight window too."""
        spec = self.spec
        sentinel = spec.num_pages
        refs = np.zeros(spec.num_pages, dtype=np.int64)
        owners = np.zeros(spec.num_pages, dtype=np.int64)
        for s in range(spec.max_seqs):
            row = [int(p) for p in self.block_tables[s] if p != sentinel]
            for pi in range(spec.max_pages_per_seq):
                p = int(self.block_tables[s, pi])
                if p == sentinel:
                    assert not self._entry_shared[s, pi]
                    continue
                refs[p] += 1
                owners[p] += not self._entry_shared[s, pi]
            assert len(row) == int(self._held[s])
            assert int(self._entry_shared[s].sum()) == int(self._shared[s])
            if s not in self._active:
                assert not row and self.lengths[s] == 0
            else:
                assert int(self.lengths[s]) <= len(row) * spec.page_size
        assert np.array_equal(refs, self._refcounts.astype(np.int64))
        assert (owners <= 1).all()
        live = set(np.nonzero(refs)[0].tolist())
        pub_only = set(self._pub_only)
        assert not pub_only or self.prefix_evict != "none"
        for p in pub_only:
            assert refs[p] == 0 and p in self._page_keys
        limbo = [p for p, _ in self._limbo]
        free = self._free_pages
        assert len(free) == len(set(free)) and len(limbo) == len(set(limbo))
        assert live.isdisjoint(free) and live.isdisjoint(limbo) and set(limbo).isdisjoint(free)
        assert pub_only.isdisjoint(free) and pub_only.isdisjoint(limbo)
        assert len(live) + len(free) + len(limbo) + len(pub_only) == spec.num_pages
        assert self._inflight_depth >= 0
        assert not self._limbo or self._inflight_depth > 0
        assert len(self._prefix_index) == len(self._page_keys)
        for key, p in self._prefix_index.items():
            assert self._page_keys.get(p) == key and (refs[p] > 0 or p in pub_only)
        assert self._reserved == sum(
            max(0, int(self._max_pages[s]) - self._owned(s))
            for s in self._active
            if s not in self._optimistic
        )
        assert 0 <= self._reserved <= len(free) + len(limbo) + len(pub_only)
        for s in self._optimistic:
            assert s in self._active and int(self._max_pages[s]) == self._owned(s)
        assert self._active.isdisjoint(self._free_slots)
        assert len(self._active) + len(self._free_slots) == spec.max_seqs

    @staticmethod
    def from_model(
        model,
        max_seqs: int,
        max_len: int,
        dtype=torch.float32,
        buckets: Optional[Sequence[int]] = None,
        page_size: int = 0,
        num_pages: int = 0,
        kv_dtype: str = "fp32",
        prefix_cache: bool = False,
        prefix_evict: str = "none",
    ) -> "PagedKVCache":
        """Defaults pick the vLLM-style page size and a pool with exactly
        the slot layout's capacity (max_seqs * max_len rows). kv_dtype
        "int8" makes int8 pools with fp32 scale side pools; prefix_cache
        turns on the hashed page cache and prefix_evict="lru" its
        retention of released published pages."""
        guids, heads, head_dim = _derive_geometry(model)
        if page_size <= 0:
            page_size = default_page_size(max_len)
        if num_pages <= 0:
            num_pages = max_seqs * max_len // page_size
        spec = KVCacheSpec(
            layer_guids=tuple(guids),
            max_seqs=max_seqs,
            max_len=max_len,
            num_heads=heads,
            head_dim=head_dim,
            buckets=tuple(buckets) if buckets else default_buckets(max_len),
            page_size=page_size,
            num_pages=num_pages,
            kv_dtype=kv_dtype,
        )
        return PagedKVCache(spec, dtype, model.device, prefix_cache=prefix_cache, prefix_evict=prefix_evict)
