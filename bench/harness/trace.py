"""Reduction of the profiled stretch: device operations, the union of
their intervals, and the idle gaps named by what the host was doing.

The stretch is a fixed run of steady steps that follows the window,
bracketed by device synchronizations, so every device operation in the
profile belongs to it.  The profiler records device activity only:
recording the host's operators too stretched a step by about 60%
(phi3-mini.reason on an H100, 30 against 18 ms), most of it in eager
admission, and would read as idle device time.  The harness times what
the host is doing itself (the scheduler's step, the admission and the
tier step) on the host clock, put on the device's clock by a marker
kernel; a gap between device operations is put down to the innermost of
those ranges that covers its midpoint."""

from __future__ import annotations

#: A tiny kernel the harness launches on the idle device as the stretch
#: opens: its start puts the host clock on the device's.
MARKER = "spin_kernel"


def reduce(events, device_type, h0: float, h1: float, ranges) -> dict:
    """``events``: the profiler's ``events()`` of the stretch, which the
    host clock saw open at ``h0`` and close at ``h1`` (seconds; the device
    synchronized at both ends); ``ranges``: the host's (label, start, end)
    in the stretch.  Returns its span (us, on the device's clock), its
    device operations [(name, start, end)] clipped to it, and the host
    ranges on the same clock."""
    kernels = [(e.name, float(e.time_range.start), float(e.time_range.end))
               for e in events if e.device_type == device_type
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return {}
    marks = [s for n, s, _ in kernels if MARKER in n]
    d0 = min(marks) if marks else min(s for _, s, _ in kernels)
    span = (d0, d0 + (h1 - h0) * 1e6)
    lo, hi = span
    kernels = [(n, max(s, lo), min(t, hi)) for n, s, t in kernels
               if t > lo and s < hi and MARKER not in n]
    labels = [(n, d0 + (a - h0) * 1e6, d0 + (b - h0) * 1e6) for n, a, b in ranges]
    return {"span": span, "kernels": kernels, "labels": labels}


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_us(prof: dict) -> float:
    return sum(t - s for s, t in union((s, t) for _, s, t in prof["kernels"]))


def gaps(prof: dict) -> list[tuple[float, float]]:
    lo, hi = prof["span"]
    out, at = [], lo
    for s, t in union((s, t) for _, s, t in prof["kernels"]):
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if hi > at:
        out.append((at, hi))
    return out


def breakdown(prof: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each [name, seconds], at most ``top``."""
    by_op: dict[str, float] = {}
    for name, s, t in prof["kernels"]:
        by_op[name] = by_op.get(name, 0.0) + (t - s)
    by_host: dict[str, float] = {}
    for s, t in gaps(prof):
        mid = 0.5 * (s + t)
        inside = [(b - a, n) for n, a, b in prof["labels"] if a <= mid <= b]
        name = min(inside)[1] if inside else "harness"
        by_host[name] = by_host.get(name, 0.0) + (t - s)

    def ranked(d):
        return [[n[:120], v * 1e-6] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
