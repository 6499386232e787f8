"""Iteration-level request scheduling (port of the synchronous loop of
flexflow_tpu/serving/scheduler.py; Orca, OSDI'22).

The unit of scheduling is one model iteration: each iteration admits
queued requests into free KV-cache slots, strictly FIFO, with one
prefill batch for the newcomers, then runs one decode step over every
in-flight slot. A request that leaves (EOS or its token budget) frees
its slot at that iteration boundary, so the next admission can refill
it. `StaticBatchingScheduler` is the request-level baseline: a batch
decodes until every member finishes before the next is admitted.

Every request ends in exactly one terminal status: FINISHED, FAILED
(bad input, non-finite logits, an engine fault), CANCELLED or
TIMED_OUT. A fault retires only the requests it touches and the queue
behind them keeps serving. Stats are plain attributes.

With a `proposer` (serving/spec.py) every iteration after admission is
one speculative step instead of a decode: the proposer drafts up to
`spec_k` tokens per slot (a deduped token tree of up to spec_k *
spec_branch nodes when spec_branch > 1), one batched verify scores them,
the acceptance rule keeps the longest agreeing prefix (path) plus one
token of the target's, and cache.truncate commits it. Greedy
speculative streams equal plain greedy streams.

With `decode_multistep`, an iteration that no host-visible event can
interrupt runs up to `max_fused_steps` decode steps as one
device-resident window (engine.decode_multi: on the card, replays of a
captured CUDA graph) and reads the host once; per-slot caps keep the
window inside each request's budget, max_len and (paged) its current
page, EOS retires a slot inside the window, and the commit rolls back
what a slot did not take. Fused streams equal one-at-a-time streams.

With a `token_budget` (chunked prefill, Sarathi-Serve), admission no
longer prefills: each iteration plans round-robin chunk grants of
`chunk_size` tokens (at most decode_kernel.MAX_W per slot) within the
budget the decode/verify step leaves, runs one chunk step over the
slots still streaming their prompts in, and emits a request's first
token when its final chunk commits; that slot decodes from the next
iteration on.

With a prefix-caching paged cache, admission maps the registered pages
that match a prefix of the sequence and prefills only the rest
(engine.prefill_suffix, or chunk steps from the shared cursor); the
prefill publishes the request's full pages only after it returned.

Under `admission="optimistic"` the paged cache admits on the prompt's
pages alone; when a page claim finds the pool dry, the youngest running
request (by (admit_iter, rid)) is preempted: its slot and pages are
freed and it re-queues at the head, to be re-admitted with prompt +
generated tokens as its recompute sequence. A request preempted more
than `max_preemptions` times fails, naming the cause.

Sampling (the engine's temperature and seed) reaches the speculative
acceptance rules of serving/spec.py as the reference passes them.

Every step is a dispatch and a reconcile (engine.InflightStep): the
dispatch side claims pages, builds the step's inputs from live state and
enqueues it; the commit runs after the reconcile against the step's
snapshot only (its participants, lengths, plans and chunk cursors),
never live scheduler or cache state. The synchronous schedulers
reconcile at once. `AsyncContinuousBatchingScheduler` (serve_async=True)
runs the two an iteration apart: while step N runs on the device the
host admits, claims pages and dispatches step N + 1, its input tokens
chained on N's outputs on the device, and only then commits N.

With more than one priority class (`classes`, serving/tenancy/
fairness.py), admission serves per-class FIFO queues in deficit
round-robin order (a selected head that cannot be admitted still blocks
everyone behind it), the chunk planner's grants are DRR serves of one
persistent instance, and preemption victims are the cheapest by class
weight x resident tokens, youngest first on ties. One class or none
leaves every decision as it is without classes. With an adapter pool on
the engine, admission attaches each slot to its request's adapter and
every release of a slot detaches it.

Swap-to-host, journal, fault injection and telemetry are not ported yet
(ROADMAP, Port queue: serving features).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ops.cuda.decode_kernel import MAX_W
from flexflow_tpu_torch.serving.kv_cache import PagePoolExhausted
from flexflow_tpu_torch.serving.spec import DraftTree, accept_drafts, accept_tree
from flexflow_tpu_torch.serving.tenancy.fairness import DeficitRoundRobin

# chunk widths are the decode kernels' query rows: a multiple of this
# (the reference's decode_kernel.SUBLANES)
CHUNK_ALIGN = 8


class RequestStatus:
    """String constants (json-friendly) for the request lifecycle."""

    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"


TERMINAL_STATUSES = frozenset(
    {
        RequestStatus.FINISHED,
        RequestStatus.FAILED,
        RequestStatus.CANCELLED,
        RequestStatus.TIMED_OUT,
    }
)


@dataclasses.dataclass
class Request:
    """One generation request. `generated` accumulates post-prompt tokens
    (the first comes from the admission prefill). `deadline_s` is a
    wall-clock budget from submit, queued or running."""

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    deadline_s: Optional[float] = None
    # multi-tenant serving: a free-form tenant tag, the priority class
    # ("" = the first configured class) and the LoRA adapter serving the
    # request (-1 = the base model)
    tenant: str = ""
    priority_class: str = ""
    adapter_id: int = -1

    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    status: str = RequestStatus.QUEUED
    error: Optional[str] = None
    preemptions: int = 0
    submit_iter: int = -1
    admit_iter: int = -1
    finish_iter: int = -1
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    # chunked prefill (token_budget > 0): the sequence being prefilled
    # (prompt + recompute tokens, fixed at admission) and the cursor of
    # its committed chunks. prefill_pos < len(prefill_seq) means the
    # request is still prefilling: it neither decodes nor drafts until its
    # last chunk lands
    prefill_seq: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0
    # the dispatch cursor: tokens handed to a chunk step, possibly still
    # in flight (prefill_pos is the committed one)
    prefill_dispatched: int = 0

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def ok(self) -> bool:
        return self.status == RequestStatus.FINISHED

    @property
    def latency_s(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft_s(self) -> float:
        """Submit -> first generated token (0.0 if none was produced)."""
        if not self.generated:
            return 0.0
        return self.first_token_time - self.submit_time

    @property
    def decode_s_per_token(self) -> float:
        """Mean seconds per generated token after the first."""
        if len(self.generated) <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (len(self.generated) - 1)

    def deadline_exceeded(self, now: float) -> bool:
        return self.deadline_s is not None and now - self.submit_time > self.deadline_s

    def _done_after(self, token: int) -> bool:
        return (
            self.eos_token is not None and token == self.eos_token
        ) or len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class SchedulerStats:
    """Counters and aggregates of one scheduler's run."""

    iterations: int = 0
    decode_steps: int = 0
    prefill_batches: int = 0
    tokens_generated: int = 0
    slot_steps: int = 0  # sum over decode iterations of max_seqs
    busy_slot_steps: int = 0  # sum of actually-active slots
    elapsed_s: float = 0.0
    # wall time of decode steps and prefill batches, each ending in the
    # host read of its sampled tokens (so it includes the device work)
    decode_s: float = 0.0
    prefill_s: float = 0.0
    submitted_requests: int = 0
    finished_requests: int = 0
    failed_requests: int = 0
    cancelled_requests: int = 0
    timed_out_requests: int = 0
    step_faults: int = 0
    # speculative decoding (verify iterations only); under token trees
    # draft_tokens_proposed counts each tree's DEPTH (the most one verify
    # could accept), so acceptance_rate keeps its meaning, and the node
    # count lives in tree_nodes_proposed
    verify_steps: int = 0
    tree_verify_steps: int = 0
    tree_nodes_proposed: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    draft_faults: int = 0  # proposer faults degraded to plain decode
    verify_s: float = 0.0  # wall time of verify steps, as decode_s
    # device-resident multi-step decode (decode_multistep=True)
    multistep_windows: int = 0  # fused windows run
    multistep_steps: int = 0  # decode steps run inside fused windows
    multistep_cache_entries: int = 0  # captured CUDA graphs alive (gauge)
    # steps that read device results on the host, every kind (prefill
    # batches, decode and verify steps, fused windows, chunk steps)
    host_syncs: int = 0
    peak_in_flight: int = 0  # max concurrent running requests observed
    # chunked prefill (token_budget > 0)
    chunk_steps: int = 0  # chunk steps run
    chunk_tokens: int = 0  # prompt tokens streamed in through chunks
    budget_deferrals: int = 0  # prefill-pending slots granted no tokens
    budget_used: int = 0  # tokens the last iteration charged to its budget
    chunk_s: float = 0.0  # wall time of chunk steps, as decode_s
    # optimistic admission
    preemptions: int = 0  # preempt-and-requeue events
    # prefix cache (mirrored from the allocator at each iteration end)
    prefix_hits: int = 0  # admissions that mapped at least one shared page
    prefix_pages_shared: int = 0  # live shared table entries (gauge)
    cow_copies: int = 0  # copy-on-write page forks
    prefix_tokens_skipped: int = 0  # prompt tokens admission did not recompute
    prefix_evictions: int = 0  # retained published pages reclaimed (prefix_evict)
    # the dispatch / reconcile split (the sync loops fill them too, with
    # an overlap window of about nothing)
    dispatch_count: int = 0  # steps dispatched, every kind
    dispatch_gap_sum_s: float = 0.0  # wall time between consecutive dispatches
    commit_wait_s: float = 0.0  # time blocked on device outputs at reconcile
    overlapped_host_s: float = 0.0  # host time between a dispatch and its reconcile
    # async speculation: pre-proposals drafted while a verify was in
    # flight, used as they were or rolled back at its reconcile
    pre_proposal_hits: int = 0
    pre_proposal_misses: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def occupancy(self) -> float:
        return self.busy_slot_steps / self.slot_steps if self.slot_steps else 0.0

    @property
    def mean_decode_step_s(self) -> float:
        return self.decode_s / self.decode_steps if self.decode_steps else 0.0

    @property
    def host_syncs_per_token(self) -> float:
        """Host reads per generated token: about 1 step at a time, toward
        1/K under fused windows of K steps."""
        if not self.tokens_generated:
            return 0.0
        return self.host_syncs / self.tokens_generated

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify steps accepted."""
        if not self.draft_tokens_proposed:
            return 0.0
        return self.draft_tokens_accepted / self.draft_tokens_proposed

    @property
    def mean_dispatch_gap_s(self) -> float:
        """Mean wall time between consecutive dispatches: the host's
        critical path per step (under the sync loop it includes the wait
        for the device)."""
        if self.dispatch_count <= 1:
            return 0.0
        return self.dispatch_gap_sum_s / (self.dispatch_count - 1)

    @property
    def overlap_fraction(self) -> float:
        """Of the time from a step's dispatch to the end of its
        reconcile's wait, the share the host spent on other work instead
        of blocked on the device: ~0 for the sync loop, toward 1 when the
        async loop hides the host behind the device."""
        window = self.overlapped_host_s + self.commit_wait_s
        if window <= 0.0:
            return 0.0
        return self.overlapped_host_s / window


def _finite_rows(logits: torch.Tensor) -> np.ndarray:
    """Per-row finite flags of prefill logits, read on the host."""
    return torch.isfinite(logits).all(dim=-1).cpu().numpy()


class _SchedulerBase:
    """Shared admission/decode/verify machinery. `proposer` switches the
    per-iteration step from plain decode to speculative draft/verify.
    `classes` ({name: PriorityClass}, config order = scheduling order)
    with more than one entry makes admission and chunk grants
    weighted-fair and victims class-priced."""

    def __init__(
        self,
        engine,
        params=None,
        proposer=None,
        spec_k: int = 4,
        spec_branch: int = 1,
        admission: str = "reserve",
        max_preemptions: int = 3,
        debug_invariants: bool = False,
        token_budget: int = 0,
        chunk_size: int = 16,
        decode_multistep: bool = False,
        max_fused_steps: int = 8,
        classes=None,
    ):
        self.engine = engine
        self.cache = engine.cache
        self.params = params if params is not None else engine.model.params
        self.proposer = proposer
        self.spec_k = int(spec_k)
        if proposer is not None and self.spec_k < 1:
            raise ValueError("speculative decoding needs spec_k >= 1")
        # spec_branch > 1 verifies a deduped token tree of up to
        # spec_k * spec_branch nodes; the verify width is fixed at
        # 1 + that, and the tree's shape rides in as a parent table
        self.spec_branch = int(spec_branch)
        if self.spec_branch < 1:
            raise ValueError(f"spec_branch must be >= 1, got {spec_branch}")
        self._tree_nodes = self.spec_k * self.spec_branch
        self.debug_invariants = bool(debug_invariants)
        self.decode_multistep = bool(decode_multistep)
        self.max_fused_steps = int(max_fused_steps)
        if self.max_fused_steps < 1:
            raise ValueError(f"max_fused_steps must be >= 1, got {max_fused_steps}")
        # this iteration's drafts, made by _fusable_steps' dry run and
        # consumed by _verify_once, so nothing drafts twice
        self._cached_proposals = None
        # admission, max_preemptions, token_budget and chunk_size arrive
        # checked by ServeConfig
        self.admission = admission
        self.max_preemptions = int(max_preemptions)
        self.token_budget = int(token_budget)
        self.chunk_size = int(chunk_size)
        # slots whose final chunk committed this iteration: their first
        # decode/verify waits for the next one
        self._chunk_unlocked: set = set()
        self._budget_used_iter = 0
        self._last_dispatch_t: Optional[float] = None
        self.queue: deque = deque()
        self.running: Dict[int, Request] = {}  # slot -> request
        self.finished: List[Request] = []
        self.stats = SchedulerStats()
        self._by_rid: Dict[int, Request] = {}
        self._iter = 0
        # multi-tenancy: one class or none keeps FIFO admission, the
        # round-robin planner and youngest-first victims
        self.classes = dict(classes) if classes else None
        self._multiclass = bool(self.classes) and len(self.classes) > 1
        self._default_class = next(iter(self.classes)) if self.classes else ""
        self._admit_drr: Optional[DeficitRoundRobin] = None
        self._grant_drr: Optional[DeficitRoundRobin] = None  # chunk grants, made at first use
        if self._multiclass:
            self._admit_drr = DeficitRoundRobin({n: c.weight for n, c in self.classes.items()}, unit=1.0)
        # the engine's adapter pool (None: no adapters anywhere); the
        # scheduler owns attach / detach
        self.adapters = getattr(engine, "adapters", None)

    # -- submission / cancellation -------------------------------------------

    def submit(self, request: Request, strict: bool = True) -> bool:
        """Queue a request. Invalid requests raise ValueError when
        `strict`, or go straight to FAILED when not. Returns True when
        the request entered the queue."""
        try:
            self._validate(request)
        except ValueError as e:
            if strict:
                raise
            request.submit_iter = self._iter
            request.submit_time = time.perf_counter()
            self._by_rid[request.rid] = request
            self.stats.submitted_requests += 1
            self._finalize(request, RequestStatus.FAILED, error=str(e))
            return False
        request.status = RequestStatus.QUEUED
        request.submit_iter = self._iter
        request.submit_time = time.perf_counter()
        self._by_rid[request.rid] = request
        self.stats.submitted_requests += 1
        self.queue.append(request)
        return True

    def _validate(self, request: Request) -> None:
        if not request.prompt:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.rid}: max_new_tokens must be >= 1, "
                f"got {request.max_new_tokens}"
            )
        if request.deadline_s is not None and request.deadline_s <= 0:
            raise ValueError(
                f"request {request.rid}: deadline_s must be > 0, got {request.deadline_s}"
            )
        need = len(request.prompt) + request.max_new_tokens
        if need > self.cache.spec.max_len:
            raise ValueError(
                f"request {request.rid}: prompt+max_new_tokens {need} "
                f"exceeds cache max_len {self.cache.spec.max_len}"
            )
        if request.priority_class and (self.classes is None or request.priority_class not in self.classes):
            raise ValueError(
                f"request {request.rid}: unknown priority class "
                f"{request.priority_class!r} (configured: "
                f"{sorted(self.classes) if self.classes else []})"
            )
        if request.adapter_id != -1:
            if self.adapters is None:
                raise ValueError(
                    f"request {request.rid}: adapter_id {request.adapter_id} "
                    "but the engine has no adapter pool (--adapters)"
                )
            if request.adapter_id not in self.adapters.loaded:
                raise ValueError(f"request {request.rid}: adapter {request.adapter_id} is not loaded")

    def _class_of(self, req: Request) -> str:
        """The request's priority class: the first configured class when
        it names none."""
        return req.priority_class or self._default_class

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request. False for unknown or
        already-terminal rids."""
        req = self._by_rid.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        self._finalize(req, RequestStatus.CANCELLED)
        return True

    # -- lifecycle core ------------------------------------------------------

    def _finalize(self, req: Request, status: str, error: Optional[str] = None):
        """The only transition into a terminal status: releases the slot
        (or the queue position) and feeds the stats."""
        if req.status in TERMINAL_STATUSES:
            return
        req.status = status
        req.error = error
        req.finish_iter = self._iter
        req.finish_time = time.perf_counter()
        if req.slot is not None and self.running.get(req.slot) is req:
            if self.proposer is not None:
                self.proposer.retire(req)
            del self.running[req.slot]
            if self.adapters is not None:
                self.adapters.detach(req.slot)
            self.cache.free(req.slot)
            req.slot = None
        else:
            self._dequeue(req)
        self.finished.append(req)
        stats = self.stats
        if status == RequestStatus.FINISHED:
            stats.finished_requests += 1
        elif status == RequestStatus.FAILED:
            stats.failed_requests += 1
        elif status == RequestStatus.CANCELLED:
            stats.cancelled_requests += 1
        elif status == RequestStatus.TIMED_OUT:
            stats.timed_out_requests += 1

    def _fail(self, req: Request, error: str) -> None:
        self._finalize(req, RequestStatus.FAILED, error=error)

    def _reap_deadlines(self) -> None:
        now = time.perf_counter()
        for req in [r for r in self.queue if r.deadline_exceeded(now)]:
            self._finalize(req, RequestStatus.TIMED_OUT)
        for req in [r for r in list(self.running.values()) if r.deadline_exceeded(now)]:
            self._finalize(req, RequestStatus.TIMED_OUT)

    def _fail_all_running(self, error: str) -> None:
        """Whole-step engine fault: retire every participant with the
        captured error; the queue behind them keeps serving."""
        self.stats.step_faults += 1
        for req in list(self.running.values()):
            self._fail(req, error)

    # -- preemption (optimistic admission) -----------------------------------

    def _victim_cost(self, req: Request) -> float:
        """Class-priced eviction cost (multiclass only): the request's
        resident tokens (prompt + generated, the recompute bill) times
        its class weight. The reference can price the recompute through
        its search cost model instead, which the port does not have yet
        (ROADMAP, Port queue)."""
        return float(len(req.prompt) + len(req.generated)) * self.classes[self._class_of(req)].weight

    def _pick_victim(self) -> Optional[Request]:
        """Youngest-by-admission running request (the vLLM victim rule:
        the least recompute to lose and, under FIFO, the weakest claim);
        (admit_iter, rid) makes the choice deterministic. Multiclass: the
        cheapest by `_victim_cost`, ties broken youngest first by the
        same key."""
        if not self.running:
            return None
        if self._multiclass:
            return min(self.running.values(), key=lambda r: (self._victim_cost(r), -r.admit_iter, -r.rid))
        return max(self.running.values(), key=lambda r: (r.admit_iter, r.rid))

    def _preempt(self, req: Request, cause: str = "pool") -> None:
        """Reclaim the victim's slot and pages and re-queue it at the
        head, to be re-admitted with prompt + generated as its recompute
        sequence. A request preempted more than max_preemptions times
        fails instead, naming the cause."""
        req.preemptions += 1
        self.stats.preemptions += 1
        if req.preemptions > self.max_preemptions:
            self._fail(
                req,
                f"preempted {req.preemptions} times (max_preemptions "
                f"{self.max_preemptions}; last cause={cause})",
            )
            return
        if self.proposer is not None:
            self.proposer.retire(req)
        del self.running[req.slot]
        if self.adapters is not None:
            self.adapters.detach(req.slot)
        self.cache.free(req.slot)
        req.slot = None
        req.status = RequestStatus.QUEUED
        self.queue.appendleft(req)

    # -- admission + prefill -------------------------------------------------

    def _dequeue(self, req: Request) -> None:
        """Remove `req` from the queue by identity (the multiclass head
        need not be the queue's front, and Request's dataclass equality
        could match a twin)."""
        for i, queued in enumerate(self.queue):
            if queued is req:
                del self.queue[i]
                return

    def _admission_head(self):
        """The request admission tries next: the queue's front, or under
        multiclass the DRR-selected class's front (per-class FIFO is the
        queue filtered by class, so a preempted request's appendleft
        keeps it at its class's front). Returns (request, commit), where
        commit charges the serve and is called only when the admission
        lands (select is pure; None without multiclass)."""
        if not self._multiclass:
            return self.queue[0], None
        heads: Dict[str, Request] = {}
        for r in self.queue:
            heads.setdefault(self._class_of(r), r)
        backlogged = list(heads)
        self._admit_drr.settle(backlogged)
        name, rounds = self._admit_drr.select({c: 1.0 for c in backlogged})

        def commit(drr=self._admit_drr):
            drr.charge(name, rounds, backlogged, cost=1.0)

        return heads[name], commit

    def _admit(self) -> List[Request]:
        """FIFO admission into free slots (the head either admits or
        blocks everyone behind it) + one prefill batch for the admitted
        set. The paged layout also requires free pages: the request's
        worst case under the reserve policy, only the pages its sequence
        fills now under the optimistic one. A preempted request re-admits
        with prompt + generated, whose prefill rebuilds the KV it lost and
        samples its next token. With a prefix cache, registered pages
        matching a prefix of the sequence are mapped and only the rest is
        prefilled; with a token budget nothing is prefilled here: the
        chunk cursors are armed and the planner streams the sequence in.
        Multiclass changes which head is tried (`_admission_head`), not
        the blocking rule. Each admitted slot attaches to its request's
        adapter before the prefill."""
        optimistic = self.admission == "optimistic"
        prefix = bool(getattr(self.cache, "prefix_cache", False))
        admitted: List[Request] = []
        seqs: List[List[int]] = []
        cursors: List[int] = []
        while self.queue:
            req, drr_commit = self._admission_head()
            seq = list(req.prompt) + list(req.generated)
            now = 0 if self.token_budget else len(seq)
            total = len(req.prompt) + req.max_new_tokens
            if prefix:
                res = self.cache.alloc_shared(seq, prompt_len=now, total_len=total, optimistic=optimistic)
                slot, cursor = (None, 0) if res is None else res
            else:
                slot, cursor = self.cache.alloc(now, total, optimistic=optimistic), 0
            if slot is None:
                break
            self._dequeue(req)
            req.slot = slot
            req.admit_iter = self._iter
            req.status = RequestStatus.RUNNING
            if self.adapters is not None:
                self.adapters.attach(slot, req.adapter_id)
            if drr_commit is not None:
                drr_commit()
            self.running[slot] = req
            admitted.append(req)
            seqs.append(seq)
            cursors.append(cursor)
            self.stats.prefix_tokens_skipped += cursor
        self.stats.peak_in_flight = max(self.stats.peak_in_flight, len(self.running))
        if not admitted:
            return admitted
        if self.proposer is not None:
            self.proposer.admit(admitted)
        if self.token_budget:
            # shared admissions start their cursors at the shared extent
            for req, seq, cur in zip(admitted, seqs, cursors):
                req.prefill_seq = [int(t) for t in seq]
                req.prefill_pos = req.prefill_dispatched = cur
            return admitted
        t0 = time.perf_counter()
        try:
            plain = [i for i, c in enumerate(cursors) if c == 0]
            shared = [i for i, c in enumerate(cursors) if c > 0]
            nxt = np.zeros(len(admitted), dtype=np.int64)
            finite = np.zeros(len(admitted), dtype=bool)
            if plain:
                nxt_p, last_p = self.engine.prefill(
                    self.params, [seqs[i] for i in plain], [admitted[i].slot for i in plain]
                )
                nxt[plain], finite[plain] = nxt_p, _finite_rows(last_p)
                self.stats.host_syncs += 1
            if shared:
                # the mapped pages already hold the prefix's rows
                nxt_s, last_s = self.engine.prefill_suffix(
                    self.params,
                    [seqs[i] for i in shared],
                    [admitted[i].slot for i in shared],
                    [cursors[i] for i in shared],
                )
                nxt[shared], finite[shared] = nxt_s, _finite_rows(last_s)
                self.stats.host_syncs += 1
        except Exception as e:  # fault isolation: the batch fails,
            # in-flight slots are untouched and keep decoding
            self.stats.step_faults += 1
            for req in admitted:
                self._fail(req, f"prefill failed: {e!r}")
            return admitted
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefill_batches += 1
        if prefix:
            # publish only after the prefill returned: a failed step must
            # never leave keys pointing at pages it did not write
            for req, seq in zip(admitted, seqs):
                self.cache.register_prefix(req.slot, seq, len(seq))
        for i, req in enumerate(admitted):
            if not finite[i]:
                self._fail(req, f"non-finite prefill logits at iteration {self._iter}")
                continue
            self._emit(req, int(nxt[i]))
        return admitted

    def _emit(self, req: Request, token: int) -> None:
        req.generated.append(token)
        if len(req.generated) == 1:
            req.first_token_time = time.perf_counter()
        self.stats.tokens_generated += 1
        if req._done_after(token):
            self._finalize(req, RequestStatus.FINISHED)

    # -- decode --------------------------------------------------------------

    def _secure_pages(self, widths: Dict[int, int]) -> None:
        """Claim every page this iteration's step writes before the step:
        slot s writes rows lengths[s] .. lengths[s] + widths[s] - 1 (a
        shared page among them is copied first). Under the reserve policy
        the claims are guaranteed, and a PagePoolExhausted fails just that
        slot; under the optimistic one a dry pool preempts the youngest
        running request and retries, which may preempt the very request
        claiming (its re-queue ends its claim loop). Pages pinned by an
        in-flight step come back first: the async loop drains its
        pipeline and retries before it fails or preempts anyone."""
        if not getattr(self.cache, "paged", False):
            return
        for slot in sorted(widths):
            req = self.running.get(slot)
            if req is None:
                continue
            start = int(self.cache.lengths[slot])
            pos = start
            while req.status == RequestStatus.RUNNING and pos < start + widths[slot]:
                try:
                    self.cache.ensure_position(slot, pos)
                    pos += 1
                except PagePoolExhausted as e:
                    if self._reclaim_inflight_pages():
                        continue
                    victim = self._pick_victim() if self.admission == "optimistic" else None
                    if victim is None:
                        self._fail(req, str(e))
                        break
                    self._preempt(victim)

    def _reclaim_inflight_pages(self) -> bool:
        """Reconcile the steps in flight so that the pages they pin return
        to the pool; True when there was one. The synchronous loops never
        have one."""
        return False

    def _decodable(self) -> Dict[int, Request]:
        """The running slots past prefill: not streaming a prompt in, and
        not in the iteration their final chunk committed."""
        return {
            s: r
            for s, r in self.running.items()
            if not self._prefill_pending(r) and s not in self._chunk_unlocked
        }

    # -- dispatch / reconcile ----------------------------------------------------

    _STEP_TIME = {"decode": "decode_s", "multistep": "decode_s", "verify": "verify_s",
                  "verify_tree": "verify_s", "chunk": "chunk_s"}

    def _note_dispatch(self, step, t0: float) -> None:
        """Stamp a dispatched step with its iteration; count it, the gap
        since the previous dispatch and its dispatch's host time (into
        its kind's wall-time stat)."""
        stats = self.stats
        stats.dispatch_count += 1
        step.iteration = self._iter
        if self._last_dispatch_t is not None:
            stats.dispatch_gap_sum_s += step.dispatch_t - self._last_dispatch_t
        self._last_dispatch_t = step.dispatch_t
        name = self._STEP_TIME[step.kind]
        setattr(stats, name, getattr(stats, name) + step.dispatch_t - t0)

    def _reconcile_step(self, step) -> None:
        """Wait for a step's read-back (one host sync), then commit it
        against its own snapshot. A reconcile that raises fails every
        running request."""
        engine = self.engine
        t0 = time.perf_counter()
        self.stats.overlapped_host_s += max(0.0, t0 - step.dispatch_t)
        try:
            if step.kind == "decode":
                out = engine.decode_reconcile(step)
            elif step.kind == "multistep":
                out = engine.decode_multi_reconcile(step)
            elif step.kind == "chunk":
                out = engine.prefill_chunk_reconcile(step)
            else:
                out = engine.verify_reconcile(step)
        except Exception as e:
            self._fail_all_running(f"{step.kind} step failed: {e!r}")
            return
        wait = time.perf_counter() - t0
        stats = self.stats
        stats.commit_wait_s += wait
        name = self._STEP_TIME[step.kind]
        setattr(stats, name, getattr(stats, name) + wait)
        stats.host_syncs += 1
        if step.kind == "decode":
            self._commit_decode(step, out[0])
        elif step.kind == "multistep":
            self._commit_multistep(step, out[0], out[2])
        elif step.kind == "chunk":
            self._commit_chunk(step, out[0])
        elif step.kind == "verify_tree":
            self._commit_verify_tree(step, out)
        else:
            self._commit_verify(step, out)

    @staticmethod
    def _chains(chain, slot: int, req: Request) -> bool:
        """Whether `req`'s next input token is the in-flight decode step
        `chain`'s output for its slot."""
        return (
            chain is not None
            and chain.kind == "decode"
            and bool(chain.active[slot])
            and chain.participants.get(slot) is req
        )

    def _decode_dispatch_step(self, chain=None):
        """Dispatch one decode step over every running slot past prefill.
        `chain` is the async loop's in-flight decode step: its slots take
        their input token from its device output, and a slot whose
        in-flight step emits its last budgeted token is not stepped (its
        result would be discarded). Returns the InflightStep, or None."""
        stepped: Dict[int, Request] = {}
        for slot, req in self._decodable().items():
            if len(req.generated) + int(self._chains(chain, slot, req)) >= req.max_new_tokens:
                continue
            stepped[slot] = req
        self._secure_pages({slot: 1 for slot in stepped})
        stepped = {s: r for s, r in stepped.items() if self.running.get(s) is r}
        if not stepped:
            return None
        spec = self.cache.spec
        tokens = np.zeros(spec.max_seqs, dtype=np.int32)
        active = np.zeros(spec.max_seqs, dtype=bool)
        chain_mask = np.zeros(spec.max_seqs, dtype=bool)
        for slot, req in stepped.items():
            tokens[slot] = req.generated[-1]
            active[slot] = True
            chain_mask[slot] = self._chains(chain, slot, req)
        t0 = time.perf_counter()
        try:
            step = self.engine.decode_dispatch(
                self.params, tokens, active, chain=chain, chain_mask=chain_mask if chain is not None else None
            )
        except Exception as e:
            self._fail_all_running(f"decode step failed: {e!r}")
            return None
        step.participants = stepped
        self._note_dispatch(step, t0)
        stats = self.stats
        stats.decode_steps += 1
        stats.slot_steps += spec.max_seqs
        stats.busy_slot_steps += int(active.sum())
        self._budget_used_iter += int(active.sum())
        return step

    def _commit_decode(self, step, nxt) -> None:
        """Emit each participant's token; a participant that retired, was
        preempted or whose slot turned over while the step was in flight
        fails the identity check and its token is discarded."""
        for slot in np.nonzero(step.active)[0]:
            req = step.participants.get(int(slot))
            if req is None or self.running.get(int(slot)) is not req:
                continue
            if not step.finite[slot]:
                self._fail(req, f"non-finite logits at iteration {step.iteration}")
                continue
            self._emit(req, int(nxt[slot]))

    def _decode_once(self) -> None:
        """One synchronous decode step: dispatch and reconcile."""
        step = self._decode_dispatch_step()
        if step is not None:
            self._reconcile_step(step)

    # -- device-resident multi-step decode (decode_multistep=True) -------------

    def _fusable_steps(self) -> int:
        """How many decode steps this iteration may fuse into one window:
        max_fused_steps when no host-visible event can need the host
        mid-window, else 1. What holds fusing to one step: a non-empty
        queue (admission next iteration changes the batch), a stateful
        proposer (its draft cache must advance with every committed
        token) and an iteration where a stateless proposer drafted (a
        verify's acceptance is host logic; the dry run's drafts are kept
        for _verify_once), optimistic admission (a preemption must never
        meet an open window), a prompt still streaming in, a final chunk
        that committed this iteration and cancels deferred to a
        reconcile (async loop). Deadlines do not hold fusing: one
        expiring mid-window is reaped after the window. Per-slot EOS,
        budget and page-boundary caps are the window's own
        (_decode_multi_dispatch_step)."""
        if not self.decode_multistep or self.max_fused_steps <= 1:
            return 1
        if self.queue:
            return 1
        if self.admission == "optimistic":
            return 1
        if self._chunk_unlocked or any(self._prefill_pending(r) for r in self.running.values()):
            return 1
        if getattr(self, "_pending_cancels", None):
            return 1
        if self.proposer is not None:
            if not getattr(self.proposer, "stateless", False):
                return 1
            if self._dry_propose():
                return 1
        return self.max_fused_steps

    def _dry_propose(self) -> bool:
        """Draft this iteration ahead of the fuse-or-verify decision and
        keep the drafts for _verify_once; True when any slot drafted."""
        if self.spec_branch > 1:
            trees = self._propose_trees()
            self._cached_proposals = ("tree", trees)
            return any(t.nodes > 0 for t in trees.values())
        proposals = self._propose(self.spec_k)
        self._cached_proposals = ("linear", proposals)
        return any(len(d) > 0 for d in proposals.values())

    def _decode_multi_dispatch_step(self, k: int):
        """Dispatch one fused window of up to k decode steps. Per slot the
        window stops at the request's remaining budget, the cache horizon
        and (paged) the slot's next page boundary, so it claims at most
        one fresh page per slot, as a plain decode step does. Returns the
        InflightStep, or None."""
        spec = self.cache.spec
        ps = spec.page_size if getattr(self.cache, "paged", False) else 0
        limits: Dict[int, int] = {}
        for slot, req in self._decodable().items():
            cur = int(self.cache.lengths[slot])
            cap = min(k, req.max_new_tokens - len(req.generated), spec.max_len - cur)
            if ps:
                cap = min(cap, ps - cur % ps)
            if cap >= 1:
                limits[slot] = cap
        self._secure_pages({slot: 1 for slot in limits})
        stepped = {s: r for s, r in self.running.items() if s in limits}
        if not stepped:
            return None
        tokens = np.zeros(spec.max_seqs, dtype=np.int32)
        active = np.zeros(spec.max_seqs, dtype=bool)
        step_limits = np.zeros(spec.max_seqs, dtype=np.int32)
        eos = np.full(spec.max_seqs, -1, dtype=np.int32)
        for slot, req in stepped.items():
            tokens[slot] = req.generated[-1]
            active[slot] = True
            step_limits[slot] = limits[slot]
            if req.eos_token is not None:
                eos[slot] = int(req.eos_token)
        t0 = time.perf_counter()
        try:
            step = self.engine.decode_multi_dispatch(self.params, tokens, active, step_limits, eos_tokens=eos)
        except Exception as e:  # a failed capture or replay: no eager retry
            self._fail_all_running(f"multistep decode failed: {e!r}")
            return None
        step.participants = stepped
        self._note_dispatch(step, t0)
        kmax = int(step.k_steps)
        stats = self.stats
        stats.multistep_windows += 1
        stats.multistep_steps += kmax
        stats.decode_steps += kmax
        stats.slot_steps += spec.max_seqs * kmax
        stats.busy_slot_steps += int(step_limits.sum())
        self._budget_used_iter += len(stepped)
        return step

    def _decode_multi_step(self, k: int) -> None:
        """One synchronous fused window of up to k decode steps: dispatch
        and reconcile."""
        step = self._decode_multi_dispatch_step(k)
        if step is not None:
            self._reconcile_step(step)

    def _commit_multistep(self, step, toks_ks, mask_ks) -> None:
        """Per slot: roll the cache back from the full-limit advance to
        the steps the window took (an EOS inside the window clears the
        mask of every later step, so `taken` ends at the EOS), then emit
        the taken tokens in order. Rollback runs before any emit: _emit
        may retire the request, which frees the slot."""
        for slot in np.nonzero(step.active)[0]:
            slot = int(slot)
            req = step.participants.get(slot)
            if req is None or self.running.get(slot) is not req:
                continue
            taken = int(mask_ks[:, slot].sum())
            if taken < int(step.step_limits[slot]):
                self.cache.truncate(slot, int(step.lengths[slot]) + taken)
            for i in range(taken):
                if not step.finite[i, slot]:
                    self._fail(req, f"non-finite logits at iteration {step.iteration} (window step {i})")
                    break
                self._emit(req, int(toks_ks[i, slot]))
                if self.running.get(slot) is not req:
                    break  # retired (EOS or budget): nothing past it

    # -- speculative decoding --------------------------------------------------

    def _propose(self, k: int) -> Dict[int, List[int]]:
        """Draft tokens for the running slots past prefill; a proposer
        fault degrades THIS iteration to plain decode (empty proposals
        make every verify row a w=1 decode) instead of killing the run."""
        try:
            return self.proposer.propose(self._decodable(), k)
        except Exception:
            self.stats.draft_faults += 1
            return {}

    def _propose_trees(self) -> Dict[int, DraftTree]:
        """Tree twin of _propose: one deduped token tree per running slot
        (up to spec_k deep, spec_branch alternatives per level)."""
        try:
            return self.proposer.propose_trees(self._decodable(), self.spec_k, self.spec_branch)
        except Exception:
            self.stats.draft_faults += 1
            return {}

    def _verify_dispatch_step(self, proposals):
        """Dispatch one linear speculative step: cap each slot's drafts to
        its remaining budget and the cache horizon (a verify emits up to
        k_s + 1 tokens and writes k_s + 1 rows, which also keeps paged
        verify inside the admission reserve), claim the pages, and
        dispatch one batched verify of width spec_k + 1. Under a token
        budget every verifying slot keeps its one-token floor and drafts
        fit in what remains, first-come by slot id. Returns the
        InflightStep, or None."""
        spec = self.cache.spec
        k = self.spec_k
        plan: Dict[int, List[int]] = {}
        budget_left = self.token_budget if self.token_budget else None
        for slot, req in sorted(self._decodable().items()):
            k_s = min(
                len(proposals.get(slot) or ()),
                k,
                req.max_new_tokens - len(req.generated) - 1,
                spec.max_len - int(self.cache.lengths[slot]) - 1,
            )
            if budget_left is not None:
                k_s = min(k_s, max(0, budget_left - 1))
            plan[slot] = list(proposals.get(slot) or ())[: max(0, k_s)]
            if budget_left is not None:
                budget_left -= 1 + len(plan[slot])
        # a page claim may preempt plan slots: the arrays build after it
        self._secure_pages({s: 1 + len(d) for s, d in plan.items()})
        plan = {s: d for s, d in plan.items() if s in self.running}
        if not plan:
            return None
        tokens = np.zeros((spec.max_seqs, k + 1), dtype=np.int32)
        draft_lens = np.zeros(spec.max_seqs, dtype=np.int32)
        for slot, drafts in plan.items():
            tokens[slot, 0] = self.running[slot].generated[-1]
            tokens[slot, 1 : 1 + len(drafts)] = drafts
            draft_lens[slot] = 1 + len(drafts)
        t0 = time.perf_counter()
        try:
            step = self.engine.verify_dispatch(self.params, tokens, draft_lens)
        except Exception as e:
            self._fail_all_running(f"verify step failed: {e!r}")
            return None
        step.plan = plan
        step.participants = {s: self.running[s] for s in plan}
        self._note_dispatch(step, t0)
        self._count_verify(len(plan), draft_lens)
        return step

    def _count_verify(self, slots: int, draft_lens: np.ndarray) -> None:
        stats = self.stats
        stats.verify_steps += 1
        stats.slot_steps += self.cache.spec.max_seqs
        stats.busy_slot_steps += slots
        self._budget_used_iter += int(draft_lens.sum())

    def _commit_verify(self, step, logits: np.ndarray) -> None:
        """Per slot: accept a prefix of the drafts against the step's
        pre-step lengths, roll the cache to the accepted length (paged
        slots return surplus pages), and emit accepted + 1 tokens. EOS
        inside the accepted run retires the request at the EOS."""
        for slot in sorted(step.plan):
            req = step.participants.get(slot)
            if req is None or self.running.get(slot) is not req:
                continue
            drafts = step.plan[slot]
            old_len = int(step.lengths[slot])
            if not np.isfinite(logits[slot, : 1 + len(drafts)]).all():
                self._fail(req, f"non-finite logits at iteration {step.iteration}")
                continue
            accepted, emitted = accept_drafts(
                logits[slot],
                drafts,
                temperature=self.engine.temperature,
                seed=self.engine.seed,
                slot=slot,
                base_len=old_len,
            )
            # commit BEFORE emitting: _emit may retire the request, which
            # frees the slot
            self.cache.truncate(slot, old_len + accepted + 1)
            self.proposer.rollback(slot, old_len + accepted + 1)
            self.stats.draft_tokens_proposed += len(drafts)
            self.stats.draft_tokens_accepted += accepted
            self._emit_run(req, emitted)

    def _verify_tree_dispatch_step(self, trees):
        """Dispatch one tree speculative step: prune each slot's tree to
        its budget (depth) and horizon (nodes), claim the pages its
        1 + nodes rows need, and dispatch one batched tree verify of
        fixed width 1 + spec_k * spec_branch. Returns the InflightStep,
        or None."""
        spec = self.cache.spec
        w = 1 + self._tree_nodes
        plan: Dict[int, DraftTree] = {}
        budget_left = self.token_budget if self.token_budget else None
        for slot, req in sorted(self._decodable().items()):
            # every node writes a cache row (horizon cap), but accepted
            # tokens are bounded by the depth (request budget cap); nodes
            # are charged to the token budget as linear drafts are
            max_nodes = min(self._tree_nodes, spec.max_len - int(self.cache.lengths[slot]) - 1)
            max_depth = req.max_new_tokens - len(req.generated) - 1
            if budget_left is not None:
                max_nodes = min(max_nodes, max(0, budget_left - 1))
            tree = trees.get(slot) or DraftTree([], [])
            plan[slot] = tree.prune(max(0, max_nodes), max(0, max_depth))
            if budget_left is not None:
                budget_left -= 1 + plan[slot].nodes
        self._secure_pages({s: 1 + t.nodes for s, t in plan.items()})
        plan = {s: t for s, t in plan.items() if s in self.running}
        if not plan:
            return None
        tokens = np.zeros((spec.max_seqs, w), dtype=np.int32)
        draft_lens = np.zeros(spec.max_seqs, dtype=np.int32)
        # pad rows and columns keep a chain topology (parent j - 1)
        parents = np.tile(np.arange(-1, w - 1, dtype=np.int32), (spec.max_seqs, 1))
        for slot, tree in plan.items():
            tokens[slot, 0] = self.running[slot].generated[-1]
            tokens[slot, 1 : 1 + tree.nodes] = tree.tokens
            parents[slot] = tree.row_parents(w)
            draft_lens[slot] = 1 + tree.nodes
        t0 = time.perf_counter()
        try:
            step = self.engine.verify_tree_dispatch(self.params, tokens, draft_lens, parents)
        except Exception as e:
            self._fail_all_running(f"tree verify step failed: {e!r}")
            return None
        step.plan = {s: list(t.tokens) for s, t in plan.items()}
        step.tree_plan = plan
        step.participants = {s: self.running[s] for s in plan}
        self._note_dispatch(step, t0)
        self._count_verify(len(plan), draft_lens)
        self.stats.tree_verify_steps += 1
        self.stats.tree_nodes_proposed += sum(t.nodes for t in plan.values())
        return step

    def _commit_verify_tree(self, step, logits: np.ndarray) -> None:
        """Per slot: walk the tree against the logits, accept the longest
        surviving root-to-leaf path, compact its scattered rows into
        contiguous positions (truncate with src_rows; dead branches' rows
        and pages go back in the same call), and emit len(path) + 1
        tokens. Proposed counts the tree's depth, accepted the path."""
        for slot in sorted(step.tree_plan):
            req = step.participants.get(slot)
            if req is None or self.running.get(slot) is not req:
                continue
            tree = step.tree_plan[slot]
            old_len = int(step.lengths[slot])
            if not np.isfinite(logits[slot, : 1 + tree.nodes]).all():
                self._fail(req, f"non-finite logits at iteration {step.iteration}")
                continue
            path, emitted = accept_tree(
                logits[slot],
                tree,
                temperature=self.engine.temperature,
                seed=self.engine.seed,
                slot=slot,
                base_len=old_len,
            )
            # node i's row sits at position old_len + 1 + i
            self.cache.truncate(
                slot, old_len + len(path) + 1, src_rows=[old_len + 1 + n for n in path]
            )
            self.proposer.rollback(slot, old_len + len(path) + 1)
            self.stats.draft_tokens_proposed += tree.depth()
            self.stats.draft_tokens_accepted += len(path)
            self._emit_run(req, emitted)

    def _emit_run(self, req: Request, tokens: Sequence[int]) -> None:
        for t in tokens:
            self._emit(req, int(t))
            if req.finished:
                break  # EOS or budget mid-verify: nothing past it

    def _verify_once(self) -> None:
        """One synchronous speculative iteration: draft (or take
        _fusable_steps' dry run's drafts), dispatch one batched verify
        and reconcile it."""
        cached, self._cached_proposals = self._cached_proposals, None
        if self.spec_branch > 1:
            trees = cached[1] if cached is not None and cached[0] == "tree" else self._propose_trees()
            step = self._verify_tree_dispatch_step(trees)
        else:
            proposals = cached[1] if cached is not None and cached[0] == "linear" else self._propose(self.spec_k)
            step = self._verify_dispatch_step(proposals)
        if step is not None:
            self._reconcile_step(step)

    # -- chunked prefill (token_budget > 0) -------------------------------------

    def _prefill_pending(self, req: Request) -> bool:
        """True while a chunked request still has prompt tokens whose
        chunk has not committed (monolithic admissions never are)."""
        return bool(req.prefill_seq) and req.prefill_pos < len(req.prefill_seq)

    def _reserved_step_tokens(self) -> int:
        """Tokens this iteration's decode/verify step may take for the
        slots past prefill: 1 each, plus the drafts under speculation.
        The chunk planner budgets around it, so decodes keep their cadence
        while a prompt streams in."""
        per = 1 + ((self._tree_nodes if self.spec_branch > 1 else self.spec_k) if self.proposer else 0)
        return per * sum(
            1
            for r in self.running.values()
            if not self._prefill_pending(r) and len(r.generated) < r.max_new_tokens
        )

    def _plan_chunks(self, reserved: int) -> Dict[int, int]:
        """Fair-share chunk grants for one iteration: round-robin passes
        over the slots with prompt tokens not yet dispatched, in admission
        order, one chunk_size unit (or the remainder) per pass, until the
        budget left after `reserved` runs out; each slot's grant stops at
        decode_kernel.MAX_W (the kernels' query rows). A grant that
        finishes a prompt costs only its own tokens: the slot's first
        decode waits one iteration (_chunk_unlocked). Pending slots
        granted nothing count as budget deferrals. Multiclass grants
        through `_plan_chunks_drr` instead."""
        pending = sorted(
            (r for r in self.running.values() if r.prefill_dispatched < len(r.prefill_seq)),
            key=lambda r: (r.admit_iter, r.rid),
        )
        if not pending:
            return {}
        plan: Dict[int, int] = {r.slot: 0 for r in pending}
        budget = self.token_budget - int(reserved)
        if self._multiclass:
            self._plan_chunks_drr(pending, plan, budget)
        else:
            progress = True
            while progress and budget > 0:
                progress = False
                for req in pending:
                    unit = self._grant_unit(req, plan, budget)
                    if unit:
                        plan[req.slot] += unit
                        budget -= unit
                        progress = True
        self.stats.budget_deferrals += sum(1 for c in plan.values() if c == 0)
        return {s: c for s, c in plan.items() if c > 0}

    def _grant_unit(self, req: Request, plan: Dict[int, int], budget: int) -> int:
        """The next chunk unit a pending request may be granted on top of
        plan[req.slot]: chunk_size tokens, or what is left of its
        sequence, or what keeps its grant within MAX_W; 0 when it has
        nothing left, is at MAX_W, or the unit exceeds `budget`."""
        rem = len(req.prefill_seq) - req.prefill_dispatched - plan[req.slot]
        if rem <= 0 or plan[req.slot] >= MAX_W:
            return 0
        unit = min(self.chunk_size, rem, MAX_W - plan[req.slot])
        return unit if unit <= budget else 0

    def _plan_chunks_drr(self, pending: List[Request], plan: Dict[int, int], budget: int) -> None:
        """Weighted-fair grants: each DRR serve grants one chunk unit (up
        to chunk_size tokens) to the selected class's next pending
        request, so prefill bandwidth under the budget divides by class
        weight; within a class requests rotate in admission order. The
        DRR persists across iterations (carried deficits make the shares
        hold over time), and idle classes settle to zero. Mutates `plan`."""
        drr = self._grant_drr
        if drr is None:
            weights = {n: c.weight for n, c in self.classes.items()}
            drr = self._grant_drr = DeficitRoundRobin(weights, unit=float(max(1, self.chunk_size)))
        by_class: Dict[str, List[Request]] = {}
        for r in pending:
            by_class.setdefault(self._class_of(r), []).append(r)
        drr.settle(list(by_class))
        rr: Dict[str, int] = {c: 0 for c in by_class}
        while budget > 0:
            costs: Dict[str, float] = {}
            heads: Dict[str, Tuple[Request, int, int]] = {}
            for c, reqs in by_class.items():
                n = len(reqs)
                for j in range(n):
                    pos = (rr[c] + j) % n
                    unit = self._grant_unit(reqs[pos], plan, budget)
                    if unit:
                        costs[c] = float(unit)
                        heads[c] = (reqs[pos], unit, pos)
                        break
            if not costs:
                break
            name, rounds = drr.select(costs)
            req, unit, pos = heads[name]
            plan[req.slot] += unit
            budget -= unit
            drr.charge(name, rounds, list(costs), cost=float(unit))
            rr[name] = (pos + 1) % len(by_class[name])
        if self.debug_invariants:
            drr.check_invariants(max_cost=float(max(1, self.chunk_size)))

    def _chunk_dispatch_step(self, plan: Dict[int, int]):
        """Dispatch one chunked-prefill step: claim the chunk rows' pages
        (which may preempt under optimistic admission), dispatch the step
        at the width of the largest grant padded up to a multiple of
        chunk_size (never past MAX_W: the padding changes no result) and
        advance the dispatch cursors. The cursors and sequences the
        commit needs ride the step. Returns the InflightStep, or None."""
        if not plan:
            return None
        self._secure_pages(dict(plan))
        live: Dict[int, int] = {}
        for slot, c in plan.items():
            req = self.running.get(slot)
            if req is not None:  # a preemption may have evicted it
                c = min(c, len(req.prefill_seq) - req.prefill_dispatched)
                if c > 0:
                    live[slot] = c
        if not live:
            return None
        spec = self.cache.spec
        w = max(live.values())
        w = min(-(-w // self.chunk_size) * self.chunk_size, MAX_W)
        tokens = np.zeros((spec.max_seqs, w), dtype=np.int32)
        chunk_lens = np.zeros(spec.max_seqs, dtype=np.int32)
        finals = np.zeros(spec.max_seqs, dtype=bool)
        chunks: Dict[int, tuple] = {}
        for slot, c in sorted(live.items()):
            req = self.running[slot]
            start = req.prefill_dispatched
            tokens[slot, :c] = req.prefill_seq[start : start + c]
            chunk_lens[slot] = c
            finals[slot] = start + c >= len(req.prefill_seq)
            chunks[slot] = (start, c, bool(finals[slot]))
        t0 = time.perf_counter()
        try:
            step = self.engine.prefill_chunk_dispatch(self.params, tokens, chunk_lens, finals)
        except Exception as e:
            self._fail_all_running(f"chunk step failed: {e!r}")
            return None
        for slot, (start, c, _) in chunks.items():
            self.running[slot].prefill_dispatched = start + c
        step.participants = {s: self.running[s] for s in chunks}
        step.chunks = chunks
        step.chunk_seqs = {s: self.running[s].prefill_seq for s in chunks}
        self._note_dispatch(step, t0)
        stats = self.stats
        stats.chunk_steps += 1
        stats.chunk_tokens += int(chunk_lens.sum())
        stats.slot_steps += spec.max_seqs
        stats.busy_slot_steps += len(chunks)
        self._budget_used_iter += int(chunk_lens.sum())
        return step

    def _commit_chunk(self, step, nxt) -> None:
        """Per participant, from the step's own cursor record: advance
        the committed cursor, publish every committed full page (prefix
        cache), and on a final chunk emit the request's first token."""
        prefix = bool(getattr(self.cache, "prefix_cache", False))
        for slot in sorted(step.chunks):
            req = step.participants.get(slot)
            if req is None or self.running.get(slot) is not req:
                continue
            start, size, final = step.chunks[slot]
            if not step.finite[slot]:
                self._fail(req, f"non-finite chunk logits at iteration {step.iteration}")
                continue
            req.prefill_pos = start + size
            if prefix:
                # every committed full page becomes matchable at once
                self.cache.register_prefix(slot, step.chunk_seqs[slot], start + size)
            if final:
                self._chunk_unlocked.add(slot)
                self._emit(req, int(nxt[slot]))

    def _chunk_once(self) -> None:
        """One synchronous chunked-prefill step: plan within the budget
        the decode/verify step leaves, dispatch, reconcile."""
        step = self._chunk_dispatch_step(self._plan_chunks(self._reserved_step_tokens()))
        if step is not None:
            self._reconcile_step(step)

    def _generate_once(self) -> None:
        """The iteration's generation step over the running slots. The
        fuse probe runs first, under speculation too: an iteration where
        no slot drafted runs a fused decode window instead of a verify
        of one row per slot."""
        k = self._fusable_steps()
        if k > 1:
            self._decode_multi_step(k)
        elif self.proposer is not None:
            self._verify_once()
        else:
            self._decode_once()

    # -- the loop ------------------------------------------------------------

    def _begin_iteration(self) -> None:
        self._iter += 1
        self.stats.iterations += 1
        self._cached_proposals = None
        self._budget_used_iter = 0
        self._chunk_unlocked.clear()
        self._reap_deadlines()

    def _end_iteration(self) -> None:
        stats = self.stats
        stats.budget_used = self._budget_used_iter
        stats.multistep_cache_entries = getattr(self.engine, "multistep_cache_entries", 0)
        stats.prefix_hits = getattr(self.cache, "prefix_hits", 0)
        stats.prefix_pages_shared = int(getattr(self.cache, "_shared", np.zeros(1)).sum())
        stats.cow_copies = getattr(self.cache, "cow_copies", 0)
        stats.prefix_evictions = getattr(self.cache, "prefix_evictions", 0)
        if self.debug_invariants:
            self.cache.check_invariants()
            if self.adapters is not None:
                self.adapters.check_invariants()
            if self._admit_drr is not None:
                self._admit_drr.check_invariants(max_cost=1.0)

    def work_pending(self) -> bool:
        """Anything submitted but not yet terminal."""
        return bool(self.queue or self.running)

    def step(self) -> None:
        raise NotImplementedError

    def run(self, requests: Optional[Sequence[Request]] = None) -> List[Request]:
        """Drain the queue (plus `requests`, submitted first) to
        completion; returns requests in terminal order."""
        for r in requests or ():
            self.submit(r)
        t0 = time.perf_counter()
        while self.work_pending():
            self.step()
        self.stats.elapsed_s += time.perf_counter() - t0
        return self.finished


class ContinuousBatchingScheduler(_SchedulerBase):
    """Orca-style: every iteration joins new prefills with in-flight
    decodes; slots recycle the moment a request retires. With a
    `token_budget`, each iteration also runs one chunked-prefill step for
    the slots still streaming their prompts in."""

    def step(self) -> None:
        self._begin_iteration()
        self._admit()
        if self.token_budget and self.running:
            self._chunk_once()
        if self.running:
            self._generate_once()
        self._end_iteration()


class AsyncContinuousBatchingScheduler(ContinuousBatchingScheduler):
    """The double-buffered Orca loop (serve_async=True; the reference's
    AsyncContinuousBatchingScheduler): each step's dispatch and reconcile
    run an iteration apart, so while step N runs on the device the host
    reaps queued deadlines, admits, claims pages and dispatches step
    N + 1, whose input tokens chain on N's outputs on the device, and
    only then waits for N to emit its tokens and retire requests. The
    synchronous ContinuousBatchingScheduler is the reference its streams
    are held to.

    Terminal events land one step late: a request that ends in step N is
    still stepped in N + 1, and the commit's identity check discards
    that token; the slot layout's stale row is overwritten before any
    length exposes it, and the paged cache pins every page released
    while a step is in flight. `cancel` of a running request and the
    reaping of running deadlines wait for the next reconcile; queued
    requests cancel and time out at once. A page claim that finds the
    pool dry because of pinned pages drains the pipeline and retries
    before it preempts anyone.

    A fused window cannot chain (its last token is k steps deep), so any
    step in flight drains before a window dispatches, and an open window
    drains at the next iteration's top. Two verifies cannot pipeline
    either (the next one's inputs are acceptance decisions): instead a
    stateless proposer drafts for verify N + 1 while N runs, against N's
    full-accept prediction, and the drafts are kept only where the
    prediction held (stats.pre_proposal_hits / misses). Token trees
    draft fresh."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inflight: deque = deque()  # InflightSteps, oldest first
        self._pending_cancels: set = set()

    # -- one-step-stale control events -------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Cancel a request: a queued one at once, a running one at the
        next reconcile while a step is in flight (its in-flight work is
        discarded)."""
        req = self._by_rid.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        if req.slot is not None and self._inflight:
            self._pending_cancels.add(rid)
            return True
        return super().cancel(rid)

    def _reap_deadlines(self) -> None:
        now = time.perf_counter()
        for req in [r for r in self.queue if r.deadline_exceeded(now)]:
            self._finalize(req, RequestStatus.TIMED_OUT)
        if not self._inflight:
            for req in [r for r in list(self.running.values()) if r.deadline_exceeded(now)]:
                self._finalize(req, RequestStatus.TIMED_OUT)

    def _after_reconcile(self) -> None:
        """The deferred control events, at the commit boundary: the
        cancels queued while the step was in flight, then running
        deadlines."""
        for rid in sorted(self._pending_cancels):
            req = self._by_rid.get(rid)
            if req is not None and req.status not in TERMINAL_STATUSES:
                self._finalize(req, RequestStatus.CANCELLED)
        self._pending_cancels.clear()
        now = time.perf_counter()
        for req in [r for r in list(self.running.values()) if r.deadline_exceeded(now)]:
            self._finalize(req, RequestStatus.TIMED_OUT)

    # -- the pipeline ----------------------------------------------------------

    def _reconcile_front(self) -> None:
        self._reconcile_step(self._inflight.popleft())
        self._after_reconcile()

    def _drain_inflight(self) -> bool:
        drained = bool(self._inflight)
        while self._inflight:
            self._reconcile_front()
        return drained

    def _reclaim_inflight_pages(self) -> bool:
        # the pages the steps in flight pin come back at their reconcile:
        # the drain stalls the pipeline but keeps the allocator sound
        return self._drain_inflight()

    def work_pending(self) -> bool:
        return bool(self.queue or self.running or self._inflight)

    def step(self) -> None:
        self._begin_iteration()
        self._admit()
        if self.proposer is not None:
            self._verify_iteration_async()
        else:
            self._decode_iteration_async()
        self._end_iteration()

    def _dispatch_chunk(self) -> int:
        """Dispatch this iteration's chunk step, if any, into the
        pipeline: it has no host data dependency (the engine advances
        the cursors at dispatch). Returns the steps it added."""
        if not (self.token_budget and self.running):
            return 0
        step = self._chunk_dispatch_step(self._plan_chunks(self._reserved_step_tokens()))
        if step is None:
            return 0
        self._inflight.append(step)
        return 1

    def _decode_iteration_async(self) -> None:
        """Dispatch decode N + 1, chained on the newest in-flight decode
        step N, then reconcile N. Under a token budget a chunk step
        dispatches ahead of the decode and both ride the device while the
        host reconciles the previous iteration's. An iteration that
        dispatches nothing drains the pipeline, so that its pinned pages
        and terminal events land."""
        if any(s.kind == "multistep" for s in self._inflight):
            self._drain_inflight()
        keep = self._dispatch_chunk()
        if self.running:
            k = self._fusable_steps()
            if k > 1:
                # nothing streams in (k > 1), so no chunk was dispatched;
                # the window's input tokens must be committed first
                self._drain_inflight()
                step = self._decode_multi_dispatch_step(k)
            else:
                # an interleaved chunk step never carries the decoding
                # slots' next tokens: chain on the newest decode step
                chain = next((s for s in reversed(self._inflight) if s.kind == "decode"), None)
                step = self._decode_dispatch_step(chain=chain)
            if step is not None:
                self._inflight.append(step)
                keep += 1
        while len(self._inflight) > keep:
            self._reconcile_front()
        if not keep:
            self._drain_inflight()

    def _verify_iteration_async(self) -> None:
        """While verify N is in flight, draft for N + 1 against its
        predicted outcome; dispatch this iteration's chunk step (it
        overlaps verify N on the device and stays in flight through this
        iteration's verify), reconcile N, then dispatch verify N + 1 with
        the pre-proposals that survived."""
        pre = self._pre_propose()
        keep = self._dispatch_chunk()
        while len(self._inflight) > keep:
            self._reconcile_front()
        if self.running:
            if self.spec_branch > 1:
                step = self._verify_tree_dispatch_step(self._propose_trees())
            else:
                step = self._verify_dispatch_step(self._merge_proposals(pre))
            if step is not None:
                self._inflight.append(step)

    # -- speculative pre-proposals -------------------------------------------------

    def _pre_propose(self) -> Dict[int, Tuple[int, List[int]]]:
        """Draft for the next verify while the current one is in flight,
        against each slot's predicted history: its committed tokens plus
        the in-flight drafts, all accepted. Only stateless proposers
        pre-draft. Returns slot -> (the predicted generated length, the
        draft), one token longer than spec_k: the prediction cannot know
        the verify's own token, so a pre-proposal survives only when its
        first token turns out to be that token."""
        if not self._inflight or self.proposer is None or not getattr(self.proposer, "stateless", False):
            return {}
        step = self._inflight[-1]
        if step.kind != "verify" or not step.plan:
            return {}
        seqs: Dict[int, List[int]] = {}
        basis: Dict[int, int] = {}
        for slot, drafts in step.plan.items():
            req = step.participants.get(slot)
            if req is None or self.running.get(slot) is not req:
                continue
            seqs[slot] = list(req.prompt) + list(req.generated) + [int(t) for t in drafts]
            basis[slot] = len(req.generated) + len(drafts)
        if not seqs:
            return {}
        proposals = self.proposer.propose_sequences(seqs, self.spec_k + 1)
        return {s: (basis[s], [int(t) for t in proposals.get(s) or ()]) for s in seqs}

    def _merge_proposals(self, pre: Dict[int, Tuple[int, List[int]]]) -> Dict[int, List[int]]:
        """Fresh proposals, overlaid with the pre-proposals whose
        prediction held: the in-flight verify accepted every draft (the
        stream grew by drafts + 1) and the pre-draft's first token is
        that verify's own token. Every other pre-proposal is a miss."""
        proposals = self._propose(self.spec_k)
        for slot, (basis, prop) in pre.items():
            req = self.running.get(slot)
            if req is None:
                continue
            if len(req.generated) == basis + 1 and len(prop) > 1 and prop[0] == int(req.generated[-1]):
                proposals[slot] = prop[1:]
                self.stats.pre_proposal_hits += 1
            else:
                self.stats.pre_proposal_misses += 1
        return proposals


class StaticBatchingScheduler(_SchedulerBase):
    """Request-level batching baseline: a batch runs until every member
    finishes; freed slots stay idle until the batch drains."""

    def step(self) -> None:
        self._begin_iteration()
        if not self.running:
            self._admit()
        if self.running:
            self._generate_once()
        self._end_iteration()


def latency_percentiles(requests: Sequence[Request], pcts=(50, 95), metric: str = "latency"):
    """{pct: seconds} over FINISHED requests (numpy's linear
    interpolation; all zeros for none). metric: "latency", "ttft" or
    "decode_per_token"."""
    fns = {
        "latency": lambda r: r.latency_s,
        "ttft": lambda r: r.ttft_s,
        "decode_per_token": lambda r: r.decode_s_per_token,
    }
    if metric not in fns:
        raise ValueError(f"metric must be one of {sorted(fns)}, got {metric!r}")
    vals = np.asarray([fns[metric](r) for r in requests if r.ok], dtype=np.float64)
    if vals.size == 0:
        return {p: 0.0 for p in pcts}
    return {p: float(np.percentile(vals, p)) for p in pcts}
