"""Fault injection and hop-failure policy for the tier runtime — the
port's own copy of ``repro.serving.faults`` (numpy only; the port imports
nothing of the reference package).  Its seeded draws replay the
reference's bit for bit.

The paper's premise is that the optimal cut depends on live network
bandwidth — which means the runtime has to survive the network
*changing underneath it*.  This module supplies the two halves of that
story:

  * `LinkFaultModel` — a deterministic, seeded fault injector for the
    simulated hops: per-hop bandwidth multipliers, latency spikes, drop
    probability, and scripted flap windows (hop hard-down for a step
    range).  Every draw is keyed by ``(seed, step, hop)`` so the same
    schedule replays bit-identically regardless of execution order,
    retry count, or how many hops a step actually exercises.
  * `HopPolicy` / `CircuitBreaker` — what the sender *does* about a bad
    hop: a per-attempt timeout, bounded retries with exponential backoff
    (+ optional seeded jitter), and a per-hop circuit breaker
    (closed → open after N consecutive failures, half-open single probe
    after a cooldown, closed again on probe success).

The executor consults these **before dispatch** (phase A of its fault
plane): hop health for a step is decided host-side from the worst-case
payload, so the decision is independent of the batch's live trajectory
and never costs an extra device sync.  `attempt_hop` below is that
pure decision function; it returns the outcome, the wall-clock overhead
the failed attempts would have burned, and a replayable event trace.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np

__all__ = [
    "LinkDownError",
    "FlapWindow",
    "HopCondition",
    "HEALTHY",
    "FaultEvent",
    "LinkFaultModel",
    "HopPolicy",
    "CircuitBreaker",
    "HopOutcome",
    "attempt_hop",
]


class LinkDownError(RuntimeError):
    """A wall-clock simulated hop must ship bytes but has no usable
    uplink and no fault model to degrade through.

    Raised by `TierExecutor.step` when ``simulate_network=True``, the
    hop's ``uplink_bps`` is unset/zero, bytes are queued on it, and no
    `LinkFaultModel` is attached (with one attached the step degrades
    instead).  Previously the hop was silently priced at zero seconds —
    a dead link looked *free*."""


@dataclasses.dataclass(frozen=True)
class FlapWindow:
    """Scripted hard-down window: ``hop`` is dead for steps in
    ``[start_step, end_step)`` (executor fault-step clock)."""

    hop: int
    start_step: int
    end_step: int

    def covers(self, step: int, hop: int) -> bool:
        return hop == self.hop and self.start_step <= step < self.end_step


@dataclasses.dataclass(frozen=True)
class HopCondition:
    """The sampled state of one hop at one step."""

    bandwidth_mult: float = 1.0  # effective bw = uplink_bps * mult
    latency_s: float = 0.0  # additive spike on a successful transfer
    flapped: bool = False  # scripted hard-down (flap window)


HEALTHY = HopCondition()


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One replayable entry in a step's fault trace.

    kinds: ``link_down`` / ``drop`` / ``timeout`` (failed attempts),
    ``retry`` (backoff before attempt N), ``exhausted`` (all attempts
    failed), ``breaker_open`` / ``breaker_half_open`` / ``breaker_closed``
    (state transitions), ``breaker_skip`` (open breaker short-circuited
    the hop without attempting it — *not* a link observation)."""

    step: int
    hop: int
    kind: str
    attempt: int = -1
    detail: float = 0.0


def _per_hop(value, hop: int, default: float) -> float:
    if isinstance(value, Mapping):
        return float(value.get(hop, default))
    return float(value)


@dataclasses.dataclass(frozen=True)
class LinkFaultModel:
    """Deterministic seeded fault injector.

    Each scalar knob also accepts a ``{hop: value}`` mapping (hops not
    listed get the healthy default).  ``draw(step, hop, attempts)``
    samples the hop condition plus per-attempt drop flags and a backoff
    jitter uniform from ``default_rng((seed, step, hop))`` — the PCG64
    stream is prefix-stable, so outcomes are identical across runs and
    independent of how many attempts the policy allows.
    """

    seed: int = 0
    drop_p: float | Mapping[int, float] = 0.0
    bandwidth_mult: float | Mapping[int, float] = 1.0
    spike_p: float | Mapping[int, float] = 0.0
    spike_s: float | Mapping[int, float] = 0.0
    flaps: tuple[FlapWindow, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "flaps", tuple(self.flaps))

    def flapped(self, step: int, hop: int) -> bool:
        return any(w.covers(step, hop) for w in self.flaps)

    def condition(self, step: int, hop: int) -> HopCondition:
        cond, _, _ = self.draw(step, hop, 0)
        return cond

    def draw(
        self, step: int, hop: int, attempts: int
    ) -> tuple[HopCondition, float, np.ndarray]:
        """-> (condition, backoff-jitter uniform, per-attempt drop flags)."""
        rng = np.random.default_rng((int(self.seed), int(step), int(hop)))
        u = rng.random(2 + attempts)
        spiked = u[0] < _per_hop(self.spike_p, hop, 0.0)
        cond = HopCondition(
            bandwidth_mult=_per_hop(self.bandwidth_mult, hop, 1.0),
            latency_s=_per_hop(self.spike_s, hop, 0.0) if spiked else 0.0,
            flapped=self.flapped(step, hop),
        )
        drops = u[2:] < _per_hop(self.drop_p, hop, 0.0)
        return cond, float(u[1]), drops


@dataclasses.dataclass(frozen=True)
class HopPolicy:
    """Per-hop failure policy: attempt timeout, bounded retries with
    exponential backoff (+ jitter), and circuit-breaker thresholds.

    ``timeout_s`` is an admission-control deadline evaluated against the
    *worst-case full-batch payload* (host-side, pre-dispatch), so the
    pass/fail decision is deterministic and trajectory-independent."""

    timeout_s: float = 1.0
    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    jitter_frac: float = 0.0
    breaker_threshold: int = 3
    breaker_cooldown_steps: int = 4

    def backoff(self, attempt: int, jitter_u: float = 0.0) -> float:
        """Backoff slept before retry ``attempt`` (1-based)."""
        base = self.backoff_s * self.backoff_mult ** (attempt - 1)
        return base * (1.0 + self.jitter_frac * jitter_u)


class CircuitBreaker:
    """Per-hop breaker: closed → open after ``breaker_threshold``
    consecutive failures; after ``breaker_cooldown_steps`` an open
    breaker admits a single half-open probe (no retries); probe success
    closes it, probe failure re-opens and restarts the cooldown."""

    def __init__(self, policy: HopPolicy):
        self.policy = policy
        self.state = "closed"
        self.failures = 0
        self._opened_step = -1
        self.transitions: list[tuple[int, str]] = []

    def _set(self, step: int, state: str) -> None:
        self.state = state
        self.transitions.append((int(step), state))

    def gate(self, step: int) -> str:
        """-> ``attempt`` (normal), ``probe`` (half-open, single try), or
        ``skip`` (open, cooling down: degrade without touching the link)."""
        if self.state == "open":
            if step - self._opened_step >= self.policy.breaker_cooldown_steps:
                self._set(step, "half_open")
                return "probe"
            return "skip"
        if self.state == "half_open":
            return "probe"
        return "attempt"

    def record(self, step: int, ok: bool) -> None:
        if ok:
            self.failures = 0
            if self.state != "closed":
                self._set(step, "closed")
            return
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.policy.breaker_threshold:
            if self.state != "open":
                self._set(step, "open")
            self._opened_step = step


@dataclasses.dataclass(frozen=True)
class HopOutcome:
    """Result of phase-A hop planning for one hop at one step."""

    ok: bool
    attempts: int  # attempts actually made
    overhead_s: float  # backoffs + failed-attempt timeouts (wall-clock)
    bandwidth_mult: float  # applies to the successful transfer, if any
    latency_s: float  # additive spike on the successful transfer
    events: tuple[FaultEvent, ...] = ()


def attempt_hop(
    policy: HopPolicy,
    cond: HopCondition,
    drops: Iterable[bool],
    jitter_u: float,
    *,
    step: int,
    hop: int,
    est_bytes: float,
    uplink_bps: float,
    attempts: int,
) -> HopOutcome:
    """Pure phase-A attempt loop for one hop.

    Each attempt fails on: hard-down link (flap or zero effective
    bandwidth), a sampled drop, or the estimated transfer exceeding
    ``policy.timeout_s``.  Failed attempts charge the timeout; retries
    charge their backoff.  Nothing here touches devices or the clock —
    the caller decides what to do with ``overhead_s``."""
    drops = np.asarray(list(drops), dtype=bool)
    events: list[FaultEvent] = []
    overhead = 0.0
    eff_bps = max(float(uplink_bps or 0.0), 0.0) * cond.bandwidth_mult
    down = cond.flapped or eff_bps <= 0.0
    ok = False
    made = 0
    for a in range(attempts):
        made = a + 1
        if a > 0:
            b = policy.backoff(a, jitter_u)
            overhead += b
            events.append(FaultEvent(step, hop, "retry", a, b))
        if down:
            overhead += policy.timeout_s
            events.append(FaultEvent(step, hop, "link_down", a, policy.timeout_s))
            continue
        if a < len(drops) and drops[a]:
            overhead += policy.timeout_s
            events.append(FaultEvent(step, hop, "drop", a, policy.timeout_s))
            continue
        est_s = cond.latency_s + est_bytes * 8.0 / eff_bps
        if est_s > policy.timeout_s:
            overhead += policy.timeout_s
            events.append(FaultEvent(step, hop, "timeout", a, est_s))
            continue
        ok = True
        break
    if not ok:
        events.append(FaultEvent(step, hop, "exhausted", made - 1, overhead))
    return HopOutcome(
        ok=ok,
        attempts=made,
        overhead_s=overhead,
        bandwidth_mult=cond.bandwidth_mult,
        latency_s=cond.latency_s,
        events=tuple(events),
    )
