"""In-memory spans of the serving runtime.

A :class:`Tracer` is handed to a server's scheduler and executor by
``server.trace(tracer)`` (:class:`~repro_torch.serving.scheduler.ServesRequests`)
and taken away by ``server.trace(None)``.  It is off by default: every
site in the runtime then costs one ``is None`` check, and makes no CUDA
event, no allocation and no host sync.

When on, the runtime opens and closes named spans where the work
happens; a span nests in the innermost span open when it opens:

    sched.step (step, live, admitted)        RequestScheduler.step
      sched.admit
        admit.prefill (rids; plen, rows)     one per prefill_rows call
      tiers.step                             TierExecutor.step
        tiers.plan                           uploads, probes, buckets
        tiers.snapshot (bytes)               the overflow snapshot
        tiers.segment (index, bucket, mode)  one per segment call:
                                             mode replay, eager or capture
        tiers.fetch                          the one device-to-host copy
        tiers.rerun                          one per overflow re-run (its
                                             segments and fetch inside)
        tiers.report                         host work after the last fetch
      sched.retire                           the per-slot loop
    request.queued (rid)                     from a request's arrival
                                             (``submit()``, or its arrival
                                             step) to the start of the
                                             admit.prefill that admits it

Stamps are ``time.perf_counter_ns()``.  On CUDA the executor also
records a pair of CUDA events around each graph replay and around the
snapshot's clones (events from a pool the tracer reuses); their device
time is read by :meth:`Tracer.finish`, after the traced steps, so the
steps themselves make no extra sync.

What admission and the snapshot did is in the spans' attributes: the
prompts, their length and the bucket rows of each ``admit.prefill``, the
bytes of each ``tiers.snapshot``; counts over a window are sums over the
spans in it.  The executor's own counters (``host_syncs``,
``overflow_retries``, ``trace_counts``, ``replays``) stay where they are.

Records stay in lists on the tracer (:attr:`Tracer.spans`); nothing is
exported or written.
"""

from __future__ import annotations

import dataclasses
from time import perf_counter_ns
from typing import Any

import torch

__all__ = ["Span", "Tracer"]


@dataclasses.dataclass(slots=True)
class Span:
    """One timed range: host stamps in ns, its own id and its parent's
    (-1 = none), the request ids it serves, a few attributes, and the
    device time of the CUDA events recorded inside it (None = none)."""

    name: str
    t0: int
    t1: int = -1
    sid: int = 0
    parent: int = -1
    rids: tuple[int, ...] = ()
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    device_ms: float | None = None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


class Tracer:
    """Spans, kept in memory until handed over.

    A closed span is kept as a plain tuple of numbers and strings (its
    attributes as (key, value) pairs): the collector stops tracking such a
    tuple within its first passes, so the records a long window piles up add
    nothing to the serving loop's own collections (kept as objects, they
    made each of them slower).  :attr:`spans` makes :class:`Span` objects
    of them when they are handed over."""

    def __init__(self):
        self._records: list[tuple] = []  # closed spans, in Span's field order
        self._open: list[Span] = []
        self._next_sid = 0
        self._device_ms: dict[int, float] = {}
        self._timed: list[tuple[int, Any, Any]] = []
        self._pool: list[tuple[Any, Any]] = []
        #: The stream the traced step's device work runs on: the executor
        #: sets it as a step opens (one lookup a step; a lookup costs ~9 us
        #: on an H100's host, more than recording an event).
        self.stream = None

    @property
    def spans(self) -> list[Span]:
        """The closed spans in the order they opened, with the device time
        of their events once :meth:`finish` has read it."""
        dev = self._device_ms
        return sorted((Span(*r[:6], dict(r[6]), dev.get(r[3])) for r in self._records),
                      key=lambda s: s.sid)

    # ------------------------------------------------------------ spans
    def open(self, name: str, rids: tuple[int, ...] = (), **attrs) -> Span:
        """Start a span inside the innermost open one."""
        stack = self._open
        sp = Span(name, perf_counter_ns(), -1, self._next_sid,
                  stack[-1].sid if stack else -1, rids, attrs)
        self._next_sid += 1
        stack.append(sp)
        return sp

    def close(self, sp: Span, **attrs) -> None:
        """End ``sp``, and any span still open inside it (one an exception
        left open ends with it)."""
        t1 = perf_counter_ns()
        if attrs:
            sp.attrs.update(attrs)
        stack = self._open
        while stack:
            top = stack.pop()
            self._records.append((top.name, top.t0, t1, top.sid, top.parent, top.rids,
                                  tuple(top.attrs.items())))
            if top is sp:
                return
        raise ValueError(f"span {sp.name!r} is not open")

    def record(self, name: str, t0: int, t1: int, rids: tuple[int, ...] = (),
               **attrs) -> None:
        """A span that has already ended (it has no parent)."""
        self._records.append((name, t0, t1, self._next_sid, -1, rids, tuple(attrs.items())))
        self._next_sid += 1

    def note(self, **attrs) -> None:
        """Set attributes of the innermost open span."""
        if self._open:
            self._open[-1].attrs.update(attrs)

    # ------------------------------------------------------- CUDA events
    def events_start(self):
        """Record the first of a pair of CUDA events on :attr:`stream`, for
        the innermost open span; :meth:`events_stop` records the second."""
        pair = (self._pool.pop() if self._pool else
                (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        pair[0].record(self.stream)
        return self._open[-1].sid, pair

    def events_stop(self, started) -> None:
        sid, pair = started
        pair[1].record(self.stream)
        self._timed.append((sid, *pair))

    def finish(self) -> list[Span]:
        """Wait for the recorded events, add each pair's time to its span's
        ``device_ms``, return the events to the pool; returns the spans."""
        dev = self._device_ms
        for sid, e0, e1 in self._timed:
            e1.synchronize()
            dev[sid] = dev.get(sid, 0.0) + e0.elapsed_time(e1)
            self._pool.append((e0, e1))
        self._timed = []
        return self.spans
