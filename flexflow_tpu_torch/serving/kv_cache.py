"""KV caches for the serving engine: slot-contiguous and block-paged
(port of the single-host part of flexflow_tpu/serving/kv_cache.py).

* `KVCache` — one pair of `[max_seqs, max_len, heads, head_dim]` tensors
  per attention layer; a slot is one row of the leading dim.
* `PagedKVCache` — PagedAttention pools `[num_pages, page_size, heads,
  head_dim]`, a host-side free-page allocator and per-slot block tables
  (`[max_seqs, max_pages_per_seq]` int32, padded with the sentinel
  `num_pages`). Admission uses the reference's *reserve* policy: a
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
ledger. Prefix sharing, swap-to-host, optimistic admission and host
partitions are not ported yet (ROADMAP, Port queue: serving features).
"""

from __future__ import annotations

import dataclasses
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

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, prompt_len: Optional[int] = None, total_len: Optional[int] = None) -> Optional[int]:
        """Take the lowest free slot (None when full): every slot holds
        max_len positions, so the lengths (accepted for signature parity
        with PagedKVCache) cannot change the verdict."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._active.add(slot)
        self.lengths[slot] = 0
        return slot

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
                si, di = (torch.as_tensor(m, device=self.device) for m in moves)
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
    (reserve admission, single host)."""

    paged = True

    def __init__(self, spec: KVCacheSpec, dtype: torch.dtype, device):
        if not spec.paged:
            raise ValueError("PagedKVCache needs a spec with page_size > 0")
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

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def num_free_pages(self) -> int:
        return len(self._free_pages)

    def _pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.spec.page_size)

    def can_admit(self, prompt_len: int = 1, total_len: int = 0) -> bool:
        """True when a slot is free and the free pool covers this
        request's worst case on top of every in-flight reservation."""
        need = self._pages_for(max(prompt_len, total_len))
        return bool(self._free_slots) and len(self._free_pages) - self._reserved >= need

    def alloc(self, prompt_len: Optional[int] = None, total_len: Optional[int] = None) -> Optional[int]:
        """Admit a sequence: take a slot, allocate the pages its prompt
        fills now and reserve the rest of its worst case. None when the
        reserve policy refuses. Omitted lengths reserve and fill max_len."""
        spec = self.spec
        if prompt_len is None:
            prompt_len = spec.max_len
        total = max(prompt_len, total_len if total_len is not None else 0)
        if total > spec.max_len:
            raise ValueError(f"sequence of {total} tokens exceeds max_len {spec.max_len}")
        if not self.can_admit(prompt_len, total):
            return None
        need_now = self._pages_for(prompt_len)
        max_p = self._pages_for(total)
        slot = heapq.heappop(self._free_slots)
        self._active.add(slot)
        for i in range(need_now):
            self.block_tables[slot, i] = heapq.heappop(self._free_pages)
        self._held[slot] = need_now
        self._max_pages[slot] = max_p
        self._reserved += max_p - need_now
        self.lengths[slot] = 0
        return slot

    def ensure_position(self, slot: int, pos: int) -> None:
        """Make position `pos` of `slot` writable, claiming the next page
        from the free list when the sequence crosses a page boundary (the
        admission reserve guarantees the claim)."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        pi = pos // self.spec.page_size
        if self.block_tables[slot, pi] != self.spec.num_pages:
            return
        if not self._free_pages:
            raise PagePoolExhausted(
                "free-page pool exhausted despite the admission reserve — "
                "allocator invariant violated"
            )
        self.block_tables[slot, pi] = heapq.heappop(self._free_pages)
        self._held[slot] += 1
        if self._held[slot] <= self._max_pages[slot]:
            self._reserved -= 1

    def free(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        self._active.remove(slot)
        self._reserved -= max(0, int(self._max_pages[slot] - self._held[slot]))
        for pi in range(self.spec.max_pages_per_seq):
            page = int(self.block_tables[slot, pi])
            if page != self.spec.num_pages:
                heapq.heappush(self._free_pages, page)
                self.block_tables[slot, pi] = self.spec.num_pages
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
        old_resv = max(0, int(self._max_pages[slot] - self._held[slot]))
        for pi in range(keep, spec.max_pages_per_seq):
            page = int(self.block_tables[slot, pi])
            if page != spec.num_pages:
                heapq.heappush(self._free_pages, page)
                self.block_tables[slot, pi] = spec.num_pages
                self._held[slot] -= 1
        self._reserved += max(0, int(self._max_pages[slot] - self._held[slot])) - old_resv
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
            torch.as_tensor(a, device=self.device)
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
        tables: every page is in exactly one table or on the free heap,
        per-slot ledgers match the tables, visible lengths fit the held
        pages, and the reserve never promises pages the pool lacks."""
        spec = self.spec
        sentinel = spec.num_pages
        seen: List[int] = []
        for s in range(spec.max_seqs):
            row = [int(p) for p in self.block_tables[s] if p != sentinel]
            assert len(row) == int(self._held[s])
            seen += row
            if s not in self._active:
                assert not row and self.lengths[s] == 0
            else:
                assert int(self.lengths[s]) <= len(row) * spec.page_size
        assert len(seen) == len(set(seen))
        assert set(seen).isdisjoint(self._free_pages)
        assert len(seen) + len(self._free_pages) == spec.num_pages
        assert self._reserved == sum(
            max(0, int(self._max_pages[s] - self._held[s])) for s in self._active
        )
        assert 0 <= self._reserved <= len(self._free_pages)
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
    ) -> "PagedKVCache":
        """Defaults pick the vLLM-style page size and a pool with exactly
        the slot layout's capacity (max_seqs * max_len rows). kv_dtype
        "int8" makes int8 pools with fp32 scale side pools."""
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
        return PagedKVCache(spec, dtype, model.device)
