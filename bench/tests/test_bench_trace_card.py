"""On the card: the program's own spans share the profile's clock.
A short traced run of phi3-mini.chat with the program's tracer on
(``experiments/program_trace.py::program_trace``), whose spans go on the
profile's clock by an anchor call of their own.  Over the profiled
stretch, on that clock:

* each ``tiers.segment`` span holds its ``cudaGraphLaunch`` call whole
  (the call's start and end, as the profile records them on the host,
  lie inside the span): the anchor puts the program's stamps within the
  few tens of us the span spends before and after the call, on either
  side;
* each ``tiers.fetch`` span ends near its device-to-host copy's end on
  the device, under 500 us apart (median of the distances; each span
  against the copy whose end lies nearest its own): the host returns
  from the wait 78-415 us after the copy ends under the profile on an
  H100, and in some processes the profile puts its device times a few
  hundred us later against its host times than in others, so that a
  span may even end before its copy does (signed distances printed).

The readers of the program's spans read something.  Run on the chip:

    PYTHONPATH=src python3 -m pytest -q -s -m card bench/tests
"""

from __future__ import annotations

import statistics
import time

import pytest

from bench.harness import runner, spans, spec
from experiments.program_trace import program_trace


def _held(rec, name, calls):
    """Per span called ``name`` in the profiled stretch, whether it holds a
    runtime call named like ``calls`` whole."""
    lo, hi = rec.prof["span"]
    marks = [(a, b) for n, a, b in rec.calls if calls in n]
    return [any(a0 <= a and b <= b0 for a, b in marks)
            for n, a0, b0 in rec.labels if n == name and lo <= a0 and b0 <= hi]


def _line(xs):
    return f"median {statistics.median(xs):.1f} us ({min(xs):.1f} to {max(xs):.1f})"


@pytest.mark.card
def test_program_spans_share_the_device_clock(card):
    with program_trace() as rec:
        res, _ = runner.run_cell(spec.cell("phi3-mini.chat"), 2 ** 31 + 5, 5.0, True,
                                 device="cuda", t_start=time.perf_counter())
    launch = _held(rec, "tiers.segment", "cudaGraphLaunch")
    copy = spans.end_offsets_us(rec.prof, rec.labels, "tiers.fetch",
                                [t for n, _, t in rec.prof["kernels"] if "DtoH" in n])
    sync = spans.end_offsets_us(rec.prof, rec.labels, "tiers.fetch",
                                [t for n, _, t in rec.calls if "cudaStreamSynchronize" in n])
    print(f"on the profile's clock by the anchor (trace.reduce puts host stamps "
          f"{rec.reduce_lag_us:.1f} us later), over the profiled stretch: "
          f"{sum(launch)} of {len(launch)} tiers.segment spans hold their cudaGraphLaunch "
          f"call; of {len(copy)} tiers.fetch spans, the span's end less its copy's end "
          f"{_line(copy)} ({sum(x < 0 for x in copy)} below 0; each: "
          f"{' '.join(f'{x:.0f}' for x in copy)}), less its cudaStreamSynchronize call's "
          f"end {_line(sync)}")
    assert res["correct"], res["check"]
    assert len(launch) >= 2 * runner.TRACE_STEPS and len(copy) >= runner.TRACE_STEPS
    assert all(launch)
    assert statistics.median(abs(x) for x in copy) < 500.0
    read = {name: f(rec.run) for name, f in spans.READERS.items()}
    print(f"readers of the program's spans: {read}; idle_spans "
          f"{res['breakdown']['idle_spans']}")
    assert None not in (read["host_gap_ms"], read["queue_ms_p95"], read["prompts_per_prefill"])
