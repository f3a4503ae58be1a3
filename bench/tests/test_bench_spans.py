"""CPU tests of the readers of the program's own spans
(``bench/harness/spans.py``): each gives a value computed by hand on a
synthetic run, none reads what is not there, the idle time goes to the
innermost program span, and a whole tiny run with the program's tracer on
(``experiments/program_trace.py::program_trace``) hands the readers its
spans and the breakdown its ``idle_spans``."""

from __future__ import annotations

import time

import pytest
import torch

from bench.harness import runner, spans
from bench.tests import tiny
from experiments.program_trace import program_trace
from repro_torch.serving.trace import Span

MS = 1_000_000  # ns


def _span(name, t0_ms, dur_ms, rids=(), device_ms=None, **attrs):
    t0 = 1_000 * MS + round(t0_ms * MS)  # the window opens at 1 s
    return Span(name, t0, t0 + round(dur_ms * MS), rids=tuple(rids), attrs=attrs,
                device_ms=device_ms)


def _run(spans_=None):
    run = runner.Run({}, 0, {}, 1.0, 2.0, [], [], {}, [])
    if spans_ is not None:
        run.spans = spans_
    return run


@pytest.fixture
def synthetic():
    """Window [1 s, 2 s): four steps inside it (one admits), one before,
    one that ends after the close; 20 requests submitted inside it, queued
    1..20 ms, and one before it."""
    s = [
        _span("sched.step", -100, 20, step=0, live=4, admitted=4),
        _span("admit.prefill", -99, 5, rids=(7, 8, 9, 10), plen=3, rows=4),
        _span("sched.step", 100, 20, step=1, live=4, admitted=0),
        _span("tiers.snapshot", 101, 3, device_ms=2.0, bytes=3_000_000_000),
        _span("tiers.segment", 104, 8, device_ms=8.0, index=0, bucket=4, mode="replay"),
        _span("tiers.segment", 112, 6, device_ms=5.0, index=1, bucket=2, mode="replay"),
        _span("sched.step", 200, 30, step=2, live=4, admitted=0),
        _span("tiers.segment", 201, 12, device_ms=10.0, index=0, bucket=4, mode="replay"),
        _span("sched.step", 300, 50, step=3, live=4, admitted=3),
        _span("admit.prefill", 301, 20, rids=(1, 2), plen=5, rows=2),
        _span("admit.prefill", 321, 10, rids=(3,), plen=9, rows=1),
        _span("tiers.segment", 332, 12, device_ms=10.0, index=0, bucket=4, mode="replay"),
        _span("sched.step", 400, 18, step=4, live=4, admitted=0),
        _span("tiers.snapshot", 401, 2, bytes=1_000_000_000),
        _span("tiers.segment", 403, 12, device_ms=10.0, index=0, bucket=4, mode="replay"),
        _span("sched.step", 995, 20, step=5, live=4, admitted=0),
        _span("tiers.segment", 996, 12, device_ms=1.0, index=0, bucket=4, mode="replay"),
        _span("request.queued", -500, 100, rids=(0,)),
    ]
    s += [_span("request.queued", 500 + k, k, rids=(100 + k,)) for k in range(1, 21)]
    return _run(s)


def test_readers_by_hand(synthetic):
    # Steps 1, 2 and 4 admit nothing: 20 - (2 + 8 + 5), 30 - 10, 18 - 10.
    assert spans.host_gap_ms(synthetic) == pytest.approx(8.0)
    # Nearest rank: the 19th of 20 queue times 1..20 ms.
    assert spans.queue_ms_p95(synthetic) == pytest.approx(19.0)
    # Two calls in the window admitted three prompts.
    assert spans.prompts_per_prefill(synthetic) == pytest.approx(1.5)
    # 4 GB cloned over the window's four decode steps.
    assert spans.snapshot_gb_per_step(synthetic) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(spans.READERS))
def test_readers_read_only_what_is_there(name):
    read = spans.READERS[name]
    assert read(_run()) is None and read(_run([])) is None
    no_events = _run([_span("sched.step", 100, 20, step=0, live=4, admitted=0),
                      _span("tiers.segment", 101, 8, index=0, bucket=4, mode="eager")])
    assert (read(no_events) is None) == (name in ("host_gap_ms", "queue_ms_p95",
                                                 "prompts_per_prefill"))


def test_idle_time_goes_to_the_innermost_program_span():
    prof = {"span": (0.0, 100.0), "kernels": [("k", 10.0, 20.0), ("k", 50.0, 60.0)],
            "labels": [("scheduler.step", 0.0, 100.0)]}
    labels = [("sched.step", 0.0, 100.0), ("tiers.segment", 5.0, 25.0),
              ("admit.prefill", 30.0, 55.0)]
    got = spans.idle_spans(prof, labels)
    assert [n for n, _ in got] == ["sched.step", "admit.prefill", "tiers.segment"]
    assert [v for _, v in got] == pytest.approx([40e-6, 30e-6, 10e-6])
    # The harness's own breakdown is untouched.
    ((name, idle),) = runner.trace_mod.breakdown(prof)["idle_gaps"]
    assert name == "scheduler.step" and idle == pytest.approx(80e-6)


def test_clock_offset_from_the_anchor_call():
    calls = [("cudaStreamIsCapturing", 1_000.0, 1_400.0),  # the profiler's first record
             ("cudaStreamIsCapturing", 2_000.0, 2_004.0),  # the anchor's own
             ("cudaLaunchKernel", 2_010.0, 2_030.0), ("cudaStreamIsCapturing", 9_000.0, 9_001.0)]
    # The host read 5,000,000 ns around the anchor's call, which the
    # profile puts at 2,002 us: its clock runs 2,002 - 5,000 us from the host's.
    assert spans.clock_offset_us(calls, 5_000_000) == pytest.approx(-2_998.0)
    assert spans.clock_offset_us(calls[:1], 5_000_000) is None
    assert spans.clock_offset_us(calls, None) is None


def test_end_offsets():
    prof = {"span": (0.0, 100.0), "kernels": []}
    labels = [("tiers.fetch", 9.0, 30.0), ("tiers.fetch", 55.0, 64.0),
              ("tiers.fetch", 90.0, 120.0),  # ends outside the stretch
              ("tiers.plan", 1.0, 2.0)]
    assert spans.end_offsets_us(prof, labels, "tiers.fetch", [12.0, 61.0]) == pytest.approx(
        [18.0, 3.0])
    assert spans.end_offsets_us(prof, labels, "tiers.fetch", []) == []


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.HYBRID], ids=["dense", "hybrid"])
@pytest.mark.parametrize("traced", [True, False], ids=["trace1", "trace0"])
def test_tiny_run_with_the_program_traced(model, traced):
    torch.set_num_threads(1)
    cell = tiny.cell(model, 0.9)  # about half the rows exit at the edge
    with pytest.MonkeyPatch.context() as mp, program_trace() as rec:
        mp.setattr(runner, "WARM_STEPS", 2)
        mp.setattr(runner, "TRACE_STEPS", 3)
        mp.setattr(runner, "MIN_TOKENS", 20)
        res, _ = runner.run_cell(cell, 2 ** 31 + 11, 0.3, traced, device="cpu",
                                 t_start=time.perf_counter())
    assert res["correct"]
    run = rec.run
    assert run.spans == rec.tracer.spans
    assert spans.host_gap_ms(run) is None  # no CUDA events on the CPU
    assert spans.queue_ms_p95(run) >= 0
    assert spans.prompts_per_prefill(run) >= 1
    assert spans.snapshot_gb_per_step(run) >= 0
    admits = [s for s in run.spans if s.name == "admit.prefill"]
    steps = [s for s in run.spans if s.name == "sched.step"]
    assert sum(len(s.rids) for s in admits) == sum(s.attrs["admitted"] for s in steps)
    assert min(s.t0 for s in steps) * 1e-9 >= run.t_open
    if traced:
        # On through the profiled stretch, which follows the window.
        assert max(s.t0 for s in steps) * 1e-9 > run.t_close
        own = {n for n, _ in res["breakdown"]["idle_spans"]}
        assert own and own <= {s.name for s in run.spans} | {"harness"}
        assert {n for n, _ in res["breakdown"]["idle_gaps"]} <= {
            "scheduler.step", "admission.prefill_rows", "tiers.step", "harness"}
    else:
        # Off as the window closes.
        assert max(s.t0 for s in steps) * 1e-9 < run.t_close
        assert "breakdown" not in res
