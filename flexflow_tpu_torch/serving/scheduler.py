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
behind them keeps serving. Stats are plain attributes. The async loop,
speculative decoding, chunked prefill, multi-step decode, preemption,
swap, tenancy, journal and telemetry are not ported yet (ROADMAP, Port
queue: serving features).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.serving.kv_cache import PagePoolExhausted


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

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def occupancy(self) -> float:
        return self.busy_slot_steps / self.slot_steps if self.slot_steps else 0.0

    @property
    def mean_decode_step_s(self) -> float:
        return self.decode_s / self.decode_steps if self.decode_steps else 0.0


def _finite_rows(logits: torch.Tensor) -> np.ndarray:
    return torch.isfinite(logits).all(dim=-1).cpu().numpy()


class _SchedulerBase:
    """Shared admission/decode machinery."""

    def __init__(self, engine, params=None, debug_invariants: bool = False):
        self.engine = engine
        self.cache = engine.cache
        self.params = params if params is not None else engine.model.params
        self.debug_invariants = bool(debug_invariants)
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

    def _secure_pages(self, slots: Sequence[int]) -> None:
        """Claim the page each stepping slot writes this iteration before
        the step; under the reserve policy the claims are guaranteed, and
        a PagePoolExhausted fails just that slot."""
        if not getattr(self.cache, "paged", False):
            return
        for slot in sorted(slots):
            req = self.running.get(slot)
            if req is None:
                continue
            try:
                self.cache.ensure_position(slot, int(self.cache.lengths[slot]))
            except PagePoolExhausted as e:
                self._fail(req, str(e))

    def _decode_once(self) -> None:
        """One decode step over every running slot."""
        self._secure_pages(list(self.running))
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
        self.stats.slot_steps += spec.max_seqs
        self.stats.busy_slot_steps += int(active.sum())
        for slot, req in stepped.items():
            if self.running.get(slot) is not req:
                continue
            if not finite[slot]:
                self._fail(req, f"non-finite logits at iteration {self._iter}")
                continue
            self._emit(req, int(nxt[slot]))

    # -- the loop ------------------------------------------------------------

    def _begin_iteration(self) -> None:
        self._iter += 1
        self.stats.iterations += 1
        self._reap_deadlines()

    def _end_iteration(self) -> None:
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
            self._decode_once()
        self._end_iteration()


class StaticBatchingScheduler(_SchedulerBase):
    """Request-level batching baseline: a batch runs until every member
    finishes; freed slots stay idle until the batch drains."""

    def step(self) -> None:
        self._begin_iteration()
        if not self.running:
            self._admit()
        if self.running:
            self._decode_once()
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
