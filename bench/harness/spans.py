"""The program's own spans (``repro_torch.serving.trace``) in a run of a
cell, and the per-layer quantities they give.

``run_cell`` does not turn the program's tracer on yet: that, a
``Run.spans`` field and a ``breakdown.idle_spans`` key are edits to
``runner.py`` that a later change to the benchmark makes, with the
metrics' entries in ``BENCHMARK.json``.  Until then
``experiments/program_trace.py`` does it from outside the harness, and
uses the pieces below: the readers, :func:`idle_spans`, and the anchor
that puts the program's spans on the profile's clock.

The anchor: as the runner launches the marker kernel, two cheap runtime
calls (``PROBE``) go first, and the host's clock around the second is
matched with that call's record in the profile (:func:`clock_offset_us`).
``trace.reduce`` puts the harness's ranges there by the marker's start on
the device instead, which on an H100 came 40-490 us after its launch call
in a warm process and 2-3 ms after it in a process's first launch of the
marker.

The readers below take a ``runner.Run`` with a ``spans`` field and return
None where it has no spans (or, for ``host_gap_ms``, no CUDA event times:
the CPU).  Each counts what lies inside the window: a step that started
in it and ended by its close, a request submitted in it.
"""

from __future__ import annotations

import bisect
import statistics

from bench.harness import runner, trace as trace_mod

#: Spans that are not work of the program's and name no idle time.
NOT_WORK = ("request.queued",)
#: The runtime call that anchors the host's clock in the profile: one the
#: profile records with its host times, cheap and without device work.
PROBE = "cudaStreamIsCapturing"


#: The harness's own breakdown, as imported (a caller may patch the module's).
_breakdown = trace_mod.breakdown


def ranges(spans, lo_ns: int, hi_ns: int) -> list:
    """(name, start s, end s) of the work spans that overlap [lo, hi] ns:
    the host ranges' form in ``trace.reduce``."""
    return [(s.name, s.t0 * 1e-9, s.t1 * 1e-9) for s in spans
            if s.name not in NOT_WORK and s.t1 >= lo_ns and s.t0 <= hi_ns]


def idle_spans(prof: dict, labels) -> list:
    """The stretch's idle device time by the innermost of ``labels`` (the
    program's spans on the device's clock) covering each gap's midpoint:
    ``trace.breakdown``'s ``idle_gaps`` for them."""
    return _breakdown({**prof, "labels": labels})["idle_gaps"]


def _in_window(run, name: str) -> list:
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    return [s for s in run.spans if s.name == name and lo <= s.t0 and s.t1 <= hi]


def host_gap_ms(run):
    """Median, over the window's scheduler steps that admitted nothing, of
    the ``sched.step`` span less the device time of the event-timed work
    inside it (segment graph replays, the snapshot's clones).  Moves
    ``tokens_per_s``.

    The device work that no event times stays in the gap: the step's
    small copies outside the graphs (the inputs' ``copy_`` into a graph's
    buffers, the host-to-device uploads of tokens, positions and masks,
    the clone of the chosen tokens) and the rows ``sched.retire`` resets,
    a few small kernels a step beside the host's own work."""
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    timed = sorted((s.t0, s.device_ms) for s in spans if s.device_ms is not None)
    if not timed:
        return None
    starts = [t for t, _ in timed]
    gaps = []
    for st in _in_window(run, "sched.step"):
        if st.attrs.get("admitted") == 0 and st.attrs.get("live"):
            a, b = bisect.bisect_left(starts, st.t0), bisect.bisect_right(starts, st.t1)
            gaps.append(st.ms - sum(ms for _, ms in timed[a:b]))
    return statistics.median(gaps) if gaps else None


def queue_ms_p95(run):
    """95th percentile (nearest rank) over the requests submitted in the
    window of ``request.queued``: arrival to the start of the admission
    that admits it.  Moves ``ttft_p95_ms``."""
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    ms = [s.ms for s in spans if s.name == "request.queued" and lo <= s.t0 < hi]
    return runner.percentile(ms, 95) if ms else None


def prompts_per_prefill(run):
    """Prompts admitted over ``prefill_rows`` calls in the window: the
    request ids over the number of the window's ``admit.prefill`` spans.
    Moves ``ttft_p95_ms``."""
    if not getattr(run, "spans", None):
        return None
    calls = _in_window(run, "admit.prefill")
    return sum(len(s.rids) for s in calls) / len(calls) if calls else None


def snapshot_gb_per_step(run):
    """GB the overflow snapshot cloned in the window (the ``bytes`` of
    its ``tiers.snapshot`` spans), over the window's decode steps.  Moves
    ``tokens_per_s``."""
    if not getattr(run, "spans", None):
        return None
    steps = [s for s in _in_window(run, "sched.step") if s.attrs.get("live")]
    if not steps:
        return None
    return sum(s.attrs["bytes"] for s in _in_window(run, "tiers.snapshot")) / 1e9 / len(steps)


def clock_offset_us(calls, anchor_ns) -> float | None:
    """The profile's clock less the host's at the stretch's anchor, in us:
    the midpoint of the anchor's own ``PROBE`` call in the profile's
    runtime calls (the stretch's second; the first takes the profiler's
    first-record cost) less ``anchor_ns``, the host's midpoint around it.
    None where either is missing (as on the CPU)."""
    probes = sorted((s, t) for n, s, t in calls if n == PROBE)
    if anchor_ns is None or len(probes) < 2:
        return None
    s, t = probes[1]
    return (s + t) / 2 - anchor_ns / 1e3


def end_offsets_us(prof: dict, labels, name: str, marks) -> list[float]:
    """For each span called ``name`` inside the profiled stretch, on the
    device's clock, its end less the nearest of ``marks`` (times on the
    same clock), in us.  With the ends of the profile's runtime calls that
    the span makes (``cudaGraphLaunch`` in ``tiers.segment``), what is left
    is the clocks' error and the few us the span takes after the call."""
    lo, hi = prof["span"]
    ends = [b for n, a, b in labels if n == name and lo <= a and b <= hi]
    return [b - min(marks, key=lambda t: abs(b - t)) for b in ends] if marks else []


READERS = {f.__name__: f for f in (host_gap_ms, queue_ms_p95, prompts_per_prefill,
                                   snapshot_gb_per_step)}
