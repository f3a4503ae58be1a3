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
Admission is FIFO and continuous: any free slot takes the next request.

Not ported yet (see ROADMAP.md): the fault plane's failed/degraded slots
and re-queueing, simulated arrival steps, gang admission and step
callbacks.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

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
    arrival_s: float = 0.0


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


@dataclasses.dataclass
class SchedulerStepReport:
    """One decode step of the request loop (host-side bookkeeping)."""

    step: int
    live: int
    admitted: tuple[int, ...]
    retired: tuple[int, ...]
    emitted: dict[int, int]
    server_report: Any = None


class RequestScheduler:
    """Admission queue + slot allocator + decode loop over a tier server
    (anything exposing ``cfg``, ``executor`` and
    ``step(tok, pos, caches, active=...)``)."""

    def __init__(
        self,
        server: Any,
        slots: int,
        context_len: int,
        *,
        reset_on_retire: bool = False,
    ):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        cfg = server.cfg
        if cfg.frontend != "none":
            raise NotImplementedError("request scheduling covers text trunks")
        self.server = server
        self.executor = server.executor
        self.device = self.executor.device
        self.cfg = cfg
        self.slots = slots
        self.context_len = context_len
        #: Mark a retired request's cache row empty (``reset_rows``);
        #: admission resets its row anyway, so this is hygiene only.
        self.reset_on_retire = reset_on_retire
        self.caches = M.init_caches(cfg, slots, context_len, device=self.device)
        self.pos = np.zeros(slots, np.int32)  # next decode position per slot
        self.active = np.zeros(slots, bool)
        self.tok_dev = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)
        self.queue: collections.deque[Request] = collections.deque()
        self.decode_steps = 0  # the step clock: one sync each
        self._next_rid = 0
        self._slot_req: list[Request | None] = [None] * slots
        self._remaining = np.zeros(slots, np.int64)
        self.results: dict[int, RequestResult] = {}
        self.finished: list[int] = []
        self.total_tokens = 0

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens: int, *,
               stop_on_exit: bool = False) -> int:
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
            stop_on_exit=stop_on_exit, arrival_s=time.perf_counter(),
        ))
        return rid

    # --------------------------------------------------------- admission
    def _free_slots(self) -> list[int]:
        return [s for s in range(self.slots) if not self.active[s]]

    def _admit(self) -> tuple[int, ...]:
        """FIFO; same-length prompts group into one prefill call padded up
        the bucket ladder with sentinel rows."""
        free = self._free_slots()
        ready = [self.queue.popleft()
                 for _ in range(min(len(free), len(self.queue)))]
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
            self.caches, tok0 = self.executor.prefill_rows(
                self.caches, toks, row_ids)
            # First decode input stays on the device: no sync at admission.
            self.tok_dev[torch.as_tensor(rows, device=self.device), 0] = \
                tok0[: len(group)]
            for slot, req in zip(rows, group):
                self.active[slot] = True
                self.pos[slot] = plen
                self._remaining[slot] = req.max_new_tokens
                self._slot_req[slot] = req
                self.results[req.rid] = RequestResult(
                    rid=req.rid, prompt_len=plen, tokens=[], exit_tiers=[],
                    exited=[], slot=slot, admitted_step=self.decode_steps)
                admitted.append(req.rid)
        return tuple(admitted)

    # -------------------------------------------------------------- step
    def step(self) -> SchedulerStepReport | None:
        """Admit into freed rows, then run one decode step over the live
        slots.  Returns None when there is nothing to decode."""
        admitted = self._admit()
        if not self.active.any():
            return None
        rep, self.caches = self.server.step(
            self.tok_dev, self.pos.copy(), self.caches, active=self.active)
        now = time.perf_counter()
        self.decode_steps += 1
        res = getattr(rep, "tier_result", rep)
        tokens = np.asarray(res.tokens)
        exited = np.asarray(res.exited)
        exit_tier = np.asarray(res.exit_tier)
        self.tok_dev = res.tokens_dev[:, None]

        emitted: dict[int, int] = {}
        retired: list[int] = []
        live = int(self.active.sum())
        for slot in np.flatnonzero(self.active):
            req = self._slot_req[slot]
            r = self.results[req.rid]
            tok = int(tokens[slot])
            emitted[req.rid] = tok
            r.tokens.append(tok)
            r.exited.append(bool(exited[slot]))
            r.exit_tiers.append(int(exit_tier[slot]))
            if r.ttft_s is None:
                r.ttft_s = now - req.arrival_s
            self.pos[slot] += 1
            self._remaining[slot] -= 1
            self.total_tokens += 1
            if self._remaining[slot] <= 0 or (req.stop_on_exit and exited[slot]):
                r.done = True
                r.retired_step = self.decode_steps
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
        report = SchedulerStepReport(
            step=self.decode_steps, live=live, admitted=admitted,
            retired=tuple(retired), emitted=emitted, server_report=rep)
        return report

    # --------------------------------------------------------------- run
    def run(self, max_steps: int | None = None) -> list[SchedulerStepReport]:
        """Step until drained, or for ``max_steps`` decode steps."""
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
               stop_on_exit: bool = False) -> int:
        return self.scheduler.submit(prompt, max_new_tokens,
                                     stop_on_exit=stop_on_exit)

    def run(self, max_steps: int | None = None) -> list[SchedulerStepReport]:
        return self.scheduler.run(max_steps)

    def drain(self) -> list[RequestResult]:
        return self.scheduler.drain()
