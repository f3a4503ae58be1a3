"""Continuous-batching request scheduler — counterpart of
``repro.serving.scheduler`` (host-side logic, ported almost verbatim).

:class:`RequestScheduler` runs a request lifecycle over ``slots``
full-batch-resident KV rows:

    submit()  -> admission queue (prompt, max_new_tokens)
    admit     -> :meth:`TierExecutor.prefill_rows` prefills waiting prompts
                 into freed cache rows in place; same-length prompts form
                 one prefill call padded up the bucket ladder with
                 out-of-bounds sentinel rows
    step      -> one decode step over the live slots (per-sequence
                 positions, dead slots pre-exited)
    retire    -> a request leaves when its token budget is spent (or at its
                 first early exit with ``stop_on_exit=True``)

It keeps the runtime's two contracts: one device-to-host sync per decode
step (admission leaves the first input token on the device), and each
request's token/exit trajectory independent of its slot and neighbours.
The next step's input token is the step result's ``tokens_dev``, which
the executor hands out as a tensor of its own (under CUDA graphs a clone
of the graph's output), so admission may write into it.

Admission is FIFO among arrived requests: ``policy="continuous"`` fills
any free slot, ``policy="gang"`` admits only when every slot is free (the
lock-step baseline).  ``submit(arrival_step=n)`` holds a request until the
step clock (``step_count``, idle ticks included) reaches n; its TTFT and
latency count from then.  ``on_step`` callbacks (the
``RepartitionController.observe`` hook) get every decode step's tier
result.

Under the fault plane a step may finalize rows from a fallback head below
a broken hop (``degraded``: the token is real, the request's
``degraded_tokens`` counts it and it retires ``"degraded"``) or fail them
(``failed``: no token).  A failed slot is always reclaimed; its request
retires ``"failed"``, or with ``requeue_on_fail`` goes back to the head of
the queue (at most ``max_requeues`` times) for a fresh admission.

``server.trace(tracer)`` turns on the spans of
:mod:`repro_torch.serving.trace` in the scheduler and its executor.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.multitier import bucket_for
from repro_torch.models import model as M

__all__ = [
    "Request",
    "RequestResult",
    "RequestScheduler",
    "SchedulerStepReport",
    "ServesRequests",
]


@dataclasses.dataclass
class Request:
    """One unit of serving work: a prompt and a decode budget."""

    prompt: np.ndarray  # (P,) int32 token ids
    max_new_tokens: int
    rid: int = -1
    #: Retire at the first token that exits at a side branch.
    stop_on_exit: bool = False
    #: Earliest step-clock value admission may happen at (0 = at once).
    arrival_step: int = 0
    #: When the request became admissible: submit() time, or the moment
    #: the step clock reaches ``arrival_step``.
    arrival_s: float = 0.0
    _arrived: bool = True  # arrival_s already stamped
    _requeues: int = 0  # times re-queued after a failed slot


@dataclasses.dataclass
class RequestResult:
    """Everything known about a finished (or in-flight) request."""

    rid: int
    prompt_len: int
    tokens: list[int]
    exit_tiers: list[int]  # per token: tier of the first exit, -1 = head
    exited: list[bool]
    slot: int = -1
    admitted_step: int = -1
    retired_step: int = -1
    ttft_s: float | None = None  # arrival -> first decoded token on host
    latency_s: float | None = None  # arrival -> retirement
    done: bool = False
    #: "ok"; "degraded" (finished with >= 1 token from a fallback head);
    #: "failed" (a failed slot ended it, requeues spent or off);
    #: "requeued" (the request went back to the queue; a fresh result
    #: replaces this one at its re-admission).
    status: str = "ok"
    degraded_tokens: int = 0  # tokens finalized from a fallback head


@dataclasses.dataclass
class SchedulerStepReport:
    """One decode step of the request loop (host-side bookkeeping)."""

    step: int
    live: int
    admitted: tuple[int, ...]
    retired: tuple[int, ...]
    emitted: dict[int, int]
    occupancy: float = 0.0  # live / slots
    server_report: Any = None
    #: rids whose token this step came from a fallback head, and rids
    #: whose slot failed (retired failed, or re-queued).
    degraded: tuple[int, ...] = ()
    failed: tuple[int, ...] = ()


class RequestScheduler:
    """Admission queue + slot allocator + decode loop over a tier server
    (anything exposing ``cfg``, ``executor`` and
    ``step(tok, pos, caches, active=...)``).  ``on_step`` callbacks get
    each decode step's tier result."""

    def __init__(
        self,
        server: Any,
        slots: int,
        context_len: int,
        *,
        policy: str = "continuous",
        reset_on_retire: bool = False,
        on_step: Sequence[Callable[[Any], Any]] = (),
        requeue_on_fail: bool = False,
        max_requeues: int = 1,
    ):
        if policy not in ("continuous", "gang"):
            raise ValueError(f"unknown admission policy: {policy!r}")
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        cfg = server.cfg
        if cfg.frontend != "none" or cfg.arch_type == "audio":
            # As the reference: patch embeds and encoder states are per
            # batch, not per slot.
            raise NotImplementedError("request scheduling covers text trunks")
        self.server = server
        self.executor = server.executor
        self.device = self.executor.device
        self.cfg = cfg
        self.slots = slots
        self.context_len = context_len
        self.policy = policy
        self.on_step = list(on_step)
        #: Mark a retired request's cache row empty (``reset_rows``);
        #: admission resets its row anyway, so this is hygiene only.
        self.reset_on_retire = reset_on_retire
        #: A request whose slot fails goes back to the queue head instead of
        #: retiring failed, up to ``max_requeues`` times; its slot is
        #: reclaimed either way.
        self.requeue_on_fail = requeue_on_fail
        self.max_requeues = max_requeues
        # A mesh-sharded executor places the slot caches under its policy.
        self.caches = self.executor.shard_caches(
            M.init_caches(cfg, slots, context_len, device=self.device))
        self.pos = np.zeros(slots, np.int32)  # next decode position per slot
        self.active = np.zeros(slots, bool)
        self.tok_dev = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)
        self.queue: collections.deque[Request] = collections.deque()
        self.step_count = 0  # the step clock (idle arrival ticks included)
        self.decode_steps = 0  # steps that decoded: one sync each
        self._next_rid = 0
        self._slot_req: list[Request | None] = [None] * slots
        self._remaining = np.zeros(slots, np.int64)
        self.results: dict[int, RequestResult] = {}
        self.finished: list[int] = []
        self.total_tokens = 0
        #: A :class:`~repro_torch.serving.trace.Tracer` while tracing
        #: (``ServesRequests.trace``); None = off.
        self.tracer = None

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens: int, *,
               stop_on_exit: bool = False, arrival_step: int = 0) -> int:
        """Queue one request; returns its rid."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.context_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + budget ({max_new_tokens}) "
                f"exceeds context_len {self.context_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(
            prompt=prompt, max_new_tokens=int(max_new_tokens), rid=rid,
            stop_on_exit=stop_on_exit, arrival_step=int(arrival_step),
            arrival_s=time.perf_counter(),
            _arrived=int(arrival_step) <= self.step_count,
        ))
        return rid

    # --------------------------------------------------------- admission
    def _free_slots(self) -> list[int]:
        return [s for s in range(self.slots) if not self.active[s]]

    def _mark_arrivals(self) -> None:
        """Stamp arrival_s when a held request's arrival step comes."""
        now = None
        for req in self.queue:
            if not req._arrived and req.arrival_step <= self.step_count:
                now = time.perf_counter() if now is None else now
                req.arrival_s = now
                req._arrived = True

    def _admit(self) -> tuple[int, ...]:
        """FIFO among arrived requests (a held queue head blocks no later
        arrival); same-length prompts group into one prefill call padded
        up the bucket ladder with sentinel rows."""
        free = self._free_slots()
        if self.policy == "gang" and len(free) < self.slots:
            return ()
        ready: list[Request] = []
        if free and self.queue:
            waiting: collections.deque[Request] = collections.deque()
            for req in self.queue:
                if len(ready) < len(free) and req._arrived:
                    ready.append(req)
                else:
                    waiting.append(req)
            self.queue = waiting
        if not ready:
            return ()
        admitted = []
        by_len: dict[int, list[Request]] = {}
        for req in ready:
            by_len.setdefault(len(req.prompt), []).append(req)
        for plen, group in by_len.items():
            rows = [free.pop(0) for _ in group]
            n = bucket_for(len(group), self.slots)
            toks = np.zeros((n, plen), np.int32)
            row_ids = np.full(n, self.slots, np.int32)  # OOB sentinel pad
            for i, req in enumerate(group):
                toks[i] = req.prompt
                row_ids[i] = rows[i]
            tr = self.tracer
            if tr is not None:
                sp = tr.open("admit.prefill", tuple(r.rid for r in group), plen=plen, rows=n)
                for req in group:
                    tr.record("request.queued", round(req.arrival_s * 1e9), sp.t0, (req.rid,))
            self.caches, tok0 = self.executor.prefill_rows(
                self.caches, toks, row_ids)
            # First decode input stays on the device: no sync at admission.
            self.tok_dev[torch.as_tensor(rows, device=self.device), 0] = \
                tok0[: len(group)]
            if tr is not None:
                tr.close(sp)
            for slot, req in zip(rows, group):
                self.active[slot] = True
                self.pos[slot] = plen
                self._remaining[slot] = req.max_new_tokens
                self._slot_req[slot] = req
                self.results[req.rid] = RequestResult(
                    rid=req.rid, prompt_len=plen, tokens=[], exit_tiers=[],
                    exited=[], slot=slot, admitted_step=self.step_count)
                admitted.append(req.rid)
        return tuple(admitted)

    # -------------------------------------------------------------- step
    def step(self) -> SchedulerStepReport | None:
        """Admit into freed rows, then run one decode step over the live
        slots.  Returns None when there is nothing to decode (an idle tick
        still advances the step clock toward held arrivals)."""
        tr = self.tracer
        sp = None if tr is None else tr.open("sched.step", step=self.step_count)
        try:
            rep = self._step(tr)
            if tr is not None:
                tr.note(live=rep.live if rep else 0, admitted=len(rep.admitted) if rep else 0)
            return rep
        finally:
            if tr is not None:
                tr.close(sp)

    def _step(self, tr) -> SchedulerStepReport | None:
        self._mark_arrivals()
        sp = None if tr is None else tr.open("sched.admit")
        admitted = self._admit()
        if tr is not None:
            tr.close(sp)
        if not self.active.any():
            if self.queue:
                self.step_count += 1
            return None
        rep, self.caches = self.server.step(
            self.tok_dev, self.pos.copy(), self.caches, active=self.active)
        now = time.perf_counter()
        self.step_count += 1
        self.decode_steps += 1
        res = getattr(rep, "tier_result", rep)
        tokens = np.asarray(res.tokens)
        exited = np.asarray(res.exited)
        exit_tier = np.asarray(res.exit_tier)
        deg_mask = getattr(res, "degraded", None)
        fail_mask = getattr(res, "failed", None)
        self.tok_dev = res.tokens_dev[:, None]

        sp = None if tr is None else tr.open("sched.retire")
        emitted: dict[int, int] = {}
        retired: list[int] = []
        degraded: list[int] = []
        failed: list[int] = []
        live = int(self.active.sum())
        for slot in np.flatnonzero(self.active):
            req = self._slot_req[slot]
            r = self.results[req.rid]
            if fail_mask is not None and fail_mask[slot]:
                # No token this step: the slot is reclaimed, and the request
                # re-queues (a fresh admission) or retires failed.
                self.active[slot] = False
                self._slot_req[slot] = None
                failed.append(req.rid)
                if self.requeue_on_fail and req._requeues < self.max_requeues:
                    req._requeues += 1
                    r.status = "requeued"
                    self.queue.appendleft(req)
                else:
                    r.done = True
                    r.status = "failed"
                    r.retired_step = self.step_count
                    r.latency_s = now - req.arrival_s
                    self.finished.append(req.rid)
                    retired.append(req.rid)
                continue
            tok = int(tokens[slot])
            emitted[req.rid] = tok
            r.tokens.append(tok)
            r.exited.append(bool(exited[slot]))
            r.exit_tiers.append(int(exit_tier[slot]))
            if deg_mask is not None and deg_mask[slot]:
                r.degraded_tokens += 1
                degraded.append(req.rid)
            if r.ttft_s is None:
                r.ttft_s = now - req.arrival_s
            self.pos[slot] += 1
            self._remaining[slot] -= 1
            self.total_tokens += 1
            if self._remaining[slot] <= 0 or (req.stop_on_exit and exited[slot]):
                r.done = True
                r.status = "degraded" if r.degraded_tokens else "ok"
                r.retired_step = self.step_count
                r.latency_s = now - req.arrival_s
                self.active[slot] = False
                self._slot_req[slot] = None
                self.finished.append(req.rid)
                retired.append(req.rid)
        if retired and self.reset_on_retire:
            rows = np.full(bucket_for(len(retired), self.slots), self.slots,
                           np.int32)
            rows[: len(retired)] = [self.results[r].slot for r in retired]
            self.caches = self.executor.reset_rows(self.caches, rows)
        if tr is not None:
            tr.close(sp)
        report = SchedulerStepReport(
            step=self.step_count, live=live, admitted=admitted,
            retired=tuple(retired), emitted=emitted,
            occupancy=live / self.slots, server_report=rep,
            degraded=tuple(degraded), failed=tuple(failed))
        for cb in self.on_step:
            cb(res)
        return report

    # --------------------------------------------------------------- run
    def run(self, max_steps: int | None = None) -> list[SchedulerStepReport]:
        """Step until drained, or for ``max_steps`` decode steps (idle
        ticks toward held arrivals do not count)."""
        out: list[SchedulerStepReport] = []
        while self.queue or self.active.any():
            if max_steps is not None and len(out) >= max_steps:
                break
            rep = self.step()
            if rep is not None:
                out.append(rep)
        return out

    def drain(self) -> list[RequestResult]:
        """Run to completion; finished requests in retirement order."""
        self.run()
        return [self.results[rid] for rid in self.finished]

    @property
    def occupancy(self) -> float:
        return float(self.active.sum()) / self.slots

    def pending(self) -> int:
        return len(self.queue)


class ServesRequests:
    """Mixin giving a tier server ``submit()`` / ``run()`` / ``drain()`` on a
    lazily built :class:`RequestScheduler` over its ``slots`` and
    ``context_len``."""

    _scheduler: RequestScheduler | None = None

    @property
    def scheduler(self) -> RequestScheduler:
        if self._scheduler is None:
            self._scheduler = RequestScheduler(self, self.slots, self.context_len)
        return self._scheduler

    def submit(self, prompt, max_new_tokens: int, *,
               stop_on_exit: bool = False, arrival_step: int = 0) -> int:
        return self.scheduler.submit(prompt, max_new_tokens,
                                     stop_on_exit=stop_on_exit,
                                     arrival_step=arrival_step)

    def run(self, max_steps: int | None = None) -> list[SchedulerStepReport]:
        return self.scheduler.run(max_steps)

    def drain(self) -> list[RequestResult]:
        return self.scheduler.drain()

    def trace(self, tracer) -> None:
        """Hand a :class:`~repro_torch.serving.trace.Tracer` to the
        scheduler and the executor (None takes it away: tracing off)."""
        self.scheduler.tracer = self.executor.tracer = tracer
