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

The async loop, chunked prefill, preemption, swap, tenancy, journal,
fault injection and telemetry are not ported yet (ROADMAP, Port queue:
serving features).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.serving.kv_cache import PagePoolExhausted
from flexflow_tpu_torch.serving.spec import DraftTree, accept_drafts, accept_tree


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

    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    status: str = RequestStatus.QUEUED
    error: Optional[str] = None
    submit_iter: int = -1
    admit_iter: int = -1
    finish_iter: int = -1
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0

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
    # batches, decode and verify steps, fused windows)
    host_syncs: int = 0

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


@dataclasses.dataclass
class _VerifyStep:
    """A verify step's record for its commit: the per-slot drafts (token
    lists, or DraftTrees), the cache lengths before the step, the
    requests that took part, and the host logits [max_seqs, w, V]."""

    plan: Dict[int, object]
    lengths: np.ndarray
    participants: Dict[int, Request]
    logits: np.ndarray


def _finite_rows(logits: torch.Tensor) -> np.ndarray:
    return torch.isfinite(logits).all(dim=-1).cpu().numpy()


class _SchedulerBase:
    """Shared admission/decode/verify machinery. `proposer` switches the
    per-iteration step from plain decode to speculative draft/verify."""

    def __init__(
        self,
        engine,
        params=None,
        proposer=None,
        spec_k: int = 4,
        spec_branch: int = 1,
        debug_invariants: bool = False,
        decode_multistep: bool = False,
        max_fused_steps: int = 8,
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
        self.queue: deque = deque()
        self.running: Dict[int, Request] = {}  # slot -> request
        self.finished: List[Request] = []
        self.stats = SchedulerStats()
        self._by_rid: Dict[int, Request] = {}
        self._iter = 0

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
            self.cache.free(req.slot)
            req.slot = None
        else:
            for i, queued in enumerate(self.queue):
                if queued is req:
                    del self.queue[i]
                    break
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

    # -- admission + prefill -------------------------------------------------

    def _admit(self) -> List[Request]:
        """FIFO admission into free slots (the head either admits or
        blocks everyone behind it) + one prefill batch for the admitted
        set. The paged layout also requires the request's worst-case
        pages to be free."""
        admitted: List[Request] = []
        while self.queue:
            req = self.queue[0]
            slot = self.cache.alloc(len(req.prompt), len(req.prompt) + req.max_new_tokens)
            if slot is None:
                break
            self.queue.popleft()
            req.slot = slot
            req.admit_iter = self._iter
            req.status = RequestStatus.RUNNING
            self.running[slot] = req
            admitted.append(req)
        if not admitted:
            return admitted
        if self.proposer is not None:
            self.proposer.admit(admitted)
        t0 = time.perf_counter()
        try:
            nxt, last = self.engine.prefill(
                self.params, [r.prompt for r in admitted], [r.slot for r in admitted]
            )
            finite = _finite_rows(last)
        except Exception as e:  # fault isolation: the batch fails,
            # in-flight slots are untouched and keep decoding
            self.stats.step_faults += 1
            for req in admitted:
                self._fail(req, f"prefill failed: {e!r}")
            return admitted
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefill_batches += 1
        self.stats.host_syncs += 1
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
        slot s writes rows lengths[s] .. lengths[s] + widths[s] - 1.
        Under the reserve policy the claims are guaranteed, and a
        PagePoolExhausted fails just that slot."""
        if not getattr(self.cache, "paged", False):
            return
        for slot in sorted(widths):
            req = self.running.get(slot)
            if req is None:
                continue
            start = int(self.cache.lengths[slot])
            try:
                for pos in range(start, start + widths[slot]):
                    self.cache.ensure_position(slot, pos)
            except PagePoolExhausted as e:
                self._fail(req, str(e))

    def _decode_once(self) -> None:
        """One decode step over every running slot."""
        self._secure_pages({slot: 1 for slot in self.running})
        stepped = dict(self.running)
        if not stepped:
            return
        spec = self.cache.spec
        tokens = np.zeros(spec.max_seqs, dtype=np.int32)
        active = np.zeros(spec.max_seqs, dtype=bool)
        for slot, req in stepped.items():
            tokens[slot] = req.generated[-1]
            active[slot] = True
        t0 = time.perf_counter()
        try:
            nxt, logits = self.engine.decode(self.params, tokens, active)
            finite = _finite_rows(logits)
        except Exception as e:
            self._fail_all_running(f"decode step failed: {e!r}")
            return
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_steps += 1
        self.stats.host_syncs += 1
        self.stats.slot_steps += spec.max_seqs
        self.stats.busy_slot_steps += int(active.sum())
        for slot, req in stepped.items():
            if self.running.get(slot) is not req:
                continue
            if not finite[slot]:
                self._fail(req, f"non-finite logits at iteration {self._iter}")
                continue
            self._emit(req, int(nxt[slot]))

    # -- device-resident multi-step decode (decode_multistep=True) -------------

    def _fusable_steps(self) -> int:
        """How many decode steps this iteration may fuse into one window:
        max_fused_steps when no host-visible event can need the host
        mid-window, else 1. What holds fusing to one step: a non-empty
        queue (admission next iteration changes the batch), a stateful
        proposer (its draft cache must advance with every committed
        token) and an iteration where a stateless proposer drafted (a
        verify's acceptance is host logic; the dry run's drafts are kept
        for _verify_once). Deadlines do not hold fusing: one expiring
        mid-window is reaped after the window. Per-slot EOS, budget and
        page-boundary caps are the window's own
        (_decode_multi_step). The reference's other holds guard features
        not ported yet: optimistic admission (ROADMAP, Port queue:
        preemption and swap), chunk streaming (Port queue: chunked
        prefill) and cancels deferred to a reconcile (Port queue: async
        engine)."""
        if not self.decode_multistep or self.max_fused_steps <= 1:
            return 1
        if self.queue:
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

    def _decode_multi_step(self, k: int) -> None:
        """One fused window of up to k decode steps, dispatched and
        committed synchronously. Per slot the window stops at the
        request's remaining budget, the cache horizon and (paged) the
        slot's next page boundary, so it claims at most one fresh page
        per slot, as a plain decode step does."""
        spec = self.cache.spec
        ps = spec.page_size if getattr(self.cache, "paged", False) else 0
        limits: Dict[int, int] = {}
        for slot, req in self.running.items():
            cur = int(self.cache.lengths[slot])
            cap = min(k, req.max_new_tokens - len(req.generated), spec.max_len - cur)
            if ps:
                cap = min(cap, ps - cur % ps)
            if cap >= 1:
                limits[slot] = cap
        self._secure_pages({slot: 1 for slot in limits})
        stepped = {s: r for s, r in self.running.items() if s in limits}
        if not stepped:
            return
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
        lengths = self.cache.lengths.copy()
        t0 = time.perf_counter()
        try:
            toks_ks, _, mask_ks = self.engine.decode_multi(
                self.params, tokens, active, step_limits, eos_tokens=eos
            )
            finite = self.engine.window_finite
        except Exception as e:  # a failed capture or replay: no eager retry
            self._fail_all_running(f"multistep decode failed: {e!r}")
            return
        kmax = int(step_limits.max())
        stats = self.stats
        stats.decode_s += time.perf_counter() - t0
        stats.multistep_windows += 1
        stats.multistep_steps += kmax
        stats.decode_steps += kmax
        stats.host_syncs += 1
        stats.slot_steps += spec.max_seqs * kmax
        stats.busy_slot_steps += int(step_limits.sum())
        self._commit_multistep(stepped, lengths, step_limits, toks_ks, mask_ks, finite)

    def _commit_multistep(self, stepped, lengths, step_limits, toks_ks, mask_ks, finite) -> None:
        """Per slot: roll the cache back from the full-limit advance to
        the steps the window took (an EOS inside the window clears the
        mask of every later step, so `taken` ends at the EOS), then emit
        the taken tokens in order. Rollback runs before any emit: _emit
        may retire the request, which frees the slot."""
        for slot, req in stepped.items():
            if self.running.get(slot) is not req:
                continue
            taken = int(mask_ks[:, slot].sum())
            if taken < int(step_limits[slot]):
                self.cache.truncate(slot, int(lengths[slot]) + taken)
            for i in range(taken):
                if not finite[i, slot]:
                    self._fail(req, f"non-finite logits at iteration {self._iter} (window step {i})")
                    break
                self._emit(req, int(toks_ks[i, slot]))
                if self.running.get(slot) is not req:
                    break  # retired (EOS or budget): nothing past it

    # -- speculative decoding --------------------------------------------------

    def _propose(self, k: int) -> Dict[int, List[int]]:
        """Draft tokens for the running slots; a proposer fault degrades
        THIS iteration to plain decode (empty proposals make every verify
        row a w=1 decode) instead of killing the run."""
        try:
            return self.proposer.propose(dict(self.running), k)
        except Exception:
            self.stats.draft_faults += 1
            return {}

    def _propose_trees(self) -> Dict[int, DraftTree]:
        """Tree twin of _propose: one deduped token tree per running slot
        (up to spec_k deep, spec_branch alternatives per level)."""
        try:
            return self.proposer.propose_trees(dict(self.running), self.spec_k, self.spec_branch)
        except Exception:
            self.stats.draft_faults += 1
            return {}

    def _run_verify(self, plan, widths: Dict[int, int], call) -> Optional[np.ndarray]:
        """Claim every page the plan's rows write (`widths` rows per
        slot), then run the engine's verify `call(plan)`; bookkeeping
        shared by both verify kinds. Returns the host logits, or None
        when nothing ran."""
        self._secure_pages(widths)
        for slot in [s for s in plan if s not in self.running]:
            del plan[slot]  # a failed page claim retired it
        if not plan:
            return None
        t0 = time.perf_counter()
        try:
            logits = call(plan)
        except Exception as e:
            self._fail_all_running(f"verify step failed: {e!r}")
            return None
        spec = self.cache.spec
        self.stats.verify_s += time.perf_counter() - t0
        self.stats.verify_steps += 1
        self.stats.host_syncs += 1
        self.stats.slot_steps += spec.max_seqs
        self.stats.busy_slot_steps += len(plan)
        return logits

    def _verify_dispatch_step(self, proposals) -> Optional[_VerifyStep]:
        """One linear speculative step up to its logits: cap each slot's
        drafts to its remaining budget and the cache horizon (a verify
        emits up to k_s + 1 tokens and writes k_s + 1 rows, which also
        keeps paged verify inside the admission reserve), claim the pages,
        and run one batched verify of width spec_k + 1."""
        spec = self.cache.spec
        k = self.spec_k
        lengths = self.cache.lengths.copy()
        plan: Dict[int, List[int]] = {}
        for slot, req in sorted(self.running.items()):
            k_s = min(
                len(proposals.get(slot) or ()),
                k,
                req.max_new_tokens - len(req.generated) - 1,
                spec.max_len - int(lengths[slot]) - 1,
            )
            plan[slot] = list(proposals.get(slot) or ())[: max(0, k_s)]
        participants = dict(self.running)

        def call(plan):
            tokens = np.zeros((spec.max_seqs, k + 1), dtype=np.int32)
            draft_lens = np.zeros(spec.max_seqs, dtype=np.int32)
            for slot, drafts in plan.items():
                tokens[slot, 0] = participants[slot].generated[-1]
                tokens[slot, 1 : 1 + len(drafts)] = drafts
                draft_lens[slot] = 1 + len(drafts)
            return self.engine.verify(self.params, tokens, draft_lens)

        logits = self._run_verify(plan, {s: 1 + len(d) for s, d in plan.items()}, call)
        if logits is None:
            return None
        return _VerifyStep(plan, lengths, participants, logits)

    def _commit_verify(self, step: _VerifyStep) -> None:
        """Per slot: accept a prefix of the drafts against the step's
        pre-step lengths, roll the cache to the accepted length (paged
        slots return surplus pages), and emit accepted + 1 tokens. EOS
        inside the accepted run retires the request at the EOS."""
        for slot in sorted(step.plan):
            req = step.participants[slot]
            if self.running.get(slot) is not req:
                continue
            drafts = step.plan[slot]
            old_len = int(step.lengths[slot])
            if not np.isfinite(step.logits[slot, : 1 + len(drafts)]).all():
                self._fail(req, f"non-finite logits at iteration {self._iter}")
                continue
            accepted, emitted = accept_drafts(
                step.logits[slot], drafts, slot=slot, base_len=old_len
            )
            # commit BEFORE emitting: _emit may retire the request, which
            # frees the slot
            self.cache.truncate(slot, old_len + accepted + 1)
            self.proposer.rollback(slot, old_len + accepted + 1)
            self.stats.draft_tokens_proposed += len(drafts)
            self.stats.draft_tokens_accepted += accepted
            self._emit_run(req, emitted)

    def _verify_tree_dispatch_step(self, trees) -> Optional[_VerifyStep]:
        """One tree speculative step up to its logits: prune each slot's
        tree to its budget (depth) and horizon (nodes), claim the pages
        its 1 + nodes rows need, and run one batched tree verify of fixed
        width 1 + spec_k * spec_branch."""
        spec = self.cache.spec
        w = 1 + self._tree_nodes
        lengths = self.cache.lengths.copy()
        plan: Dict[int, DraftTree] = {}
        for slot, req in sorted(self.running.items()):
            # every node writes a cache row (horizon cap), but accepted
            # tokens are bounded by the depth (request budget cap)
            max_nodes = min(self._tree_nodes, spec.max_len - int(lengths[slot]) - 1)
            max_depth = req.max_new_tokens - len(req.generated) - 1
            tree = trees.get(slot) or DraftTree([], [])
            plan[slot] = tree.prune(max(0, max_nodes), max(0, max_depth))
        participants = dict(self.running)

        def call(plan):
            tokens = np.zeros((spec.max_seqs, w), dtype=np.int32)
            draft_lens = np.zeros(spec.max_seqs, dtype=np.int32)
            # pad rows and columns keep a chain topology (parent j - 1)
            parents = np.tile(np.arange(-1, w - 1, dtype=np.int32), (spec.max_seqs, 1))
            for slot, tree in plan.items():
                tokens[slot, 0] = participants[slot].generated[-1]
                tokens[slot, 1 : 1 + tree.nodes] = tree.tokens
                parents[slot] = tree.row_parents(w)
                draft_lens[slot] = 1 + tree.nodes
            return self.engine.verify_tree(self.params, tokens, draft_lens, parents)

        logits = self._run_verify(plan, {s: 1 + t.nodes for s, t in plan.items()}, call)
        if logits is None:
            return None
        self.stats.tree_verify_steps += 1
        self.stats.tree_nodes_proposed += sum(t.nodes for t in plan.values())
        return _VerifyStep(plan, lengths, participants, logits)

    def _commit_verify_tree(self, step: _VerifyStep) -> None:
        """Per slot: walk the tree against the logits, accept the longest
        surviving root-to-leaf path, compact its scattered rows into
        contiguous positions (truncate with src_rows; dead branches' rows
        and pages go back in the same call), and emit len(path) + 1
        tokens. Proposed counts the tree's depth, accepted the path."""
        for slot in sorted(step.plan):
            req = step.participants[slot]
            if self.running.get(slot) is not req:
                continue
            tree = step.plan[slot]
            old_len = int(step.lengths[slot])
            if not np.isfinite(step.logits[slot, : 1 + tree.nodes]).all():
                self._fail(req, f"non-finite logits at iteration {self._iter}")
                continue
            path, emitted = accept_tree(step.logits[slot], tree, slot=slot, base_len=old_len)
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
        """One speculative iteration: draft (or take _fusable_steps' dry
        run's drafts), one batched verify, and the commit,
        synchronously."""
        cached, self._cached_proposals = self._cached_proposals, None
        if self.spec_branch > 1:
            trees = cached[1] if cached is not None and cached[0] == "tree" else self._propose_trees()
            step = self._verify_tree_dispatch_step(trees)
            if step is not None:
                self._commit_verify_tree(step)
        else:
            proposals = cached[1] if cached is not None and cached[0] == "linear" else self._propose(self.spec_k)
            step = self._verify_dispatch_step(proposals)
            if step is not None:
                self._commit_verify(step)

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
        self._reap_deadlines()

    def _end_iteration(self) -> None:
        self.stats.multistep_cache_entries = getattr(self.engine, "multistep_cache_entries", 0)
        if self.debug_invariants:
            self.cache.check_invariants()

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
    decodes; slots recycle the moment a request retires."""

    def step(self) -> None:
        self._begin_iteration()
        self._admit()
        if self.running:
            self._generate_once()
        self._end_iteration()


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
