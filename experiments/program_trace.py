#!/usr/bin/env python3
"""The benchmark's cells with the program's own tracer on
(``repro_torch.serving.trace``), on one card.

    python3 experiments/program_trace.py window --cell zamba2.chat --seed 7 [--seconds 50]
    python3 experiments/program_trace.py cost --cell phi3-mini.chat --seed 7 [--seconds 60]
                                              [--arm bare]

``window``: a run of the cell as ``bench/run.py --trace 1`` makes it, with
the tracer on from the window's opening through the profiled stretch
(:func:`program_trace`).  Prints one JSON line: the harness's per-layer
metrics, the readers of the program's spans over the whole window
(``bench/harness/spans.py``: ``host_gap_ms``, ``queue_ms_p95``,
``prompts_per_prefill``, ``snapshot_gb_per_step``), the breakdown's
``idle_gaps`` and ``idle_spans``, what each span takes per
admission-free step of the window (host ms, and device ms where CUDA
events timed it), and on the device's clock (``spans.end_offsets_us``)
how far the profiled stretch's ``tiers.segment`` spans end after their
``cudaGraphLaunch`` calls and its ``tiers.fetch`` spans after their
``cudaStreamSynchronize`` calls and their device-to-host copies, in us.

``cost``: the tracer's own cost, in one process.  A traced run of the
cell whose window turns the tracer off and on in turn every ``--block``
steps; prints the harness's ``decode_step_ms`` (median host ms of the
steps that admitted nothing) and ``prefill_ms_per_ktok`` (the harness's
CUDA events around each ``prefill_rows`` call) for the steps with the
tracer off and those with it on.  With ``--arm bare`` the other turns
keep the tracer off too and step without the tracing wrappers of
``RequestScheduler.step`` and ``TierExecutor.step`` (what the two steps
were before the tracer): what the wrappers cost with tracing off.

:func:`program_trace` turns the tracer on inside ``runner.run_cell``
from outside it, by patching the harness's classes; the card test of the
shared clock uses it too.  It goes when ``runner.py`` turns the tracer on
itself.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path
from time import perf_counter_ns
from typing import Any
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [p for p in (str(ROOT), str(ROOT / "src")) if p not in sys.path]

from bench.harness import runner, spans, spec, trace as trace_mod  # noqa: E402


@dataclasses.dataclass
class Record:
    """What :func:`program_trace` kept of the last run: the tracer, the
    ``Run`` the readers got, and the profiled stretch reduced for the
    harness's ranges (``prof``) and for the program's spans (``labels``,
    on the device's clock by the anchor: ``reduce_lag_us`` earlier than
    ``trace.reduce`` puts host stamps)."""
    tracer: Any = None
    run: Any = None
    prof: dict | None = None
    labels: list | None = None
    calls: list | None = None  # the profile's runtime calls (name, start, end)
    anchor_ns: int | None = None
    reduce_lag_us: float | None = None  # how much later trace.reduce puts host stamps


@contextlib.contextmanager
def program_trace():
    """``runner.run_cell`` with the program's tracer on: from the window's
    opening through the profiled stretch (to the window's close in a run
    with ``traced`` False).  The ``Run`` gets the tracer's spans as
    ``run.spans``, and the breakdown an ``idle_spans`` key: the stretch's
    idle device time by the innermost program span that covers each gap's
    midpoint, in the form of ``idle_gaps``.  The harness's own readers
    and ``idle_gaps`` are computed as before.  Yields the :class:`Record`
    it fills."""
    import torch

    from repro_torch.serving.trace import Tracer

    rec = Record()

    class Loop(runner.Loop):
        def _off(self):
            self.server.trace(None)
            rec.tracer.finish()

        @property
        def in_window(self):
            return self._in_window

        @in_window.setter
        def in_window(self, on):
            self._in_window = on
            if on and rec.tracer is None:
                rec.tracer = Tracer()
                self.server.trace(rec.tracer)
            elif not on and rec.tracer is not None and not self.traced:
                self._off()

        @property
        def ranges(self):
            return self._ranges

        @ranges.setter
        def ranges(self, value):
            if value is None and getattr(self, "_ranges", None) is not None:
                self._off()  # the profiled stretch has ended
            self._ranges = value

    sleep = torch.cuda._sleep

    def marker(cycles):
        """The runner's marker kernel, after the anchor's calls."""
        torch.cuda.is_current_stream_capturing()  # spans.PROBE
        t0 = perf_counter_ns()
        torch.cuda.is_current_stream_capturing()  # spans.PROBE
        rec.anchor_ns = (t0 + perf_counter_ns()) // 2
        sleep(cycles)

    class Run(runner.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.spans = rec.tracer.spans if rec.tracer is not None else None
            rec.run = self

    reduce = trace_mod.reduce

    def traced_reduce(events, device_type, h0, h1, harness_ranges):
        rec.prof = reduce(events, device_type, h0, h1, harness_ranges)
        if rec.tracer is not None:
            own = spans.ranges(rec.tracer.spans, round(h0 * 1e9), round(h1 * 1e9))
            rec.calls = [(e.name, float(e.time_range.start), float(e.time_range.end))
                         for e in events if e.device_type != device_type]
            off = spans.clock_offset_us(rec.calls, rec.anchor_ns)
            if off is None:
                rec.labels = reduce(events, device_type, h0, h1, own).get("labels")
            else:
                rec.labels = [(n, a * 1e6 + off, b * 1e6 + off) for n, a, b in own]
                if rec.prof:
                    rec.reduce_lag_us = rec.prof["span"][0] - (h0 * 1e6 + off)
        return rec.prof

    def traced_breakdown(prof):
        out = spans._breakdown(prof)
        if rec.labels is not None:
            out["idle_spans"] = spans.idle_spans(prof, rec.labels)
        return out

    with mock.patch.object(runner, "Loop", Loop), mock.patch.object(runner, "Run", Run), \
            mock.patch.object(trace_mod, "reduce", traced_reduce), \
            mock.patch.object(trace_mod, "breakdown", traced_breakdown), \
            mock.patch.object(torch.cuda, "_sleep", marker):
        yield rec


def per_step(run) -> dict:
    """Per span name, the mean over the window's admission-free steps of
    its host ms, and of its device ms where events timed it."""
    spans_ = run.spans
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    steps = [s for s in spans_ if s.name == "sched.step" and lo <= s.t0 and s.t1 <= hi
             and s.attrs.get("admitted") == 0 and s.attrs.get("live")]
    quiet = {s.sid for s in steps}
    host, dev = collections.Counter(), collections.Counter()
    stack = {}  # span id -> its step's id
    for s in spans_:
        step = s.sid if s.sid in quiet else stack.get(s.parent)
        if step is None:
            continue
        stack[s.sid] = step
        host[s.name] += s.ms
        if s.device_ms is not None:
            dev[s.name] += s.device_ms
    n = max(len(steps), 1)
    return {"steps": len(steps),
            "host_ms": {k: v / n for k, v in host.items()},
            "device_ms": {k: v / n for k, v in dev.items()}}


def window(args, torch) -> dict:
    with program_trace() as rec:
        res, _ = runner.run_cell(spec.cell(args.cell), args.seed, args.seconds, True,
                                 device="cuda", t_start=time.perf_counter())
    def offsets(kind, name, mark):
        marks = [t for n, _, t in kind if mark in n]
        off = spans.end_offsets_us(rec.prof, rec.labels, name, marks) if rec.labels else []
        return {"n": len(off), "median": statistics.median(off) if off else None,
                "min": min(off) if off else None, "max": max(off) if off else None}
    return {
        "correct": res["correct"], "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "readers": {k: f(rec.run) for k, f in spans.READERS.items()},
        "idle_gaps": res["breakdown"]["idle_gaps"], "idle_spans": res["breakdown"]["idle_spans"],
        "per_step": per_step(rec.run),
        "reduce_lag_us": rec.reduce_lag_us,
        "segment_after_launch_us": offsets(rec.calls or [], "tiers.segment", "cudaGraphLaunch"),
        "fetch_after_sync_us": offsets(rec.calls or [], "tiers.fetch", "cudaStreamSynchronize"),
        "fetch_after_copy_us": offsets(rec.prof["kernels"], "tiers.fetch", "DtoH"),
        "device": res["device"],
    }


def cost(args, torch) -> dict:
    from repro_torch.serving.trace import Tracer

    out = {}

    class Loop(runner.Loop):
        """The tracer on every other turn of ``--block`` steps; each
        window step keeps its turn and the harness's prefill events it
        added (``Loop.prefill_ev``)."""

        def __init__(self, *a, **k):
            self.tracer, self.marks = Tracer(), []  # (on, Step, its prefill events)
            super().__init__(*a, **k)

        @property
        def in_window(self):
            return self._in_window

        @in_window.setter
        def in_window(self, on):
            if not on and getattr(self, "_in_window", False):
                self.server.trace(None)
                torch.cuda.synchronize()
                self.tracer.finish()
                out.update(arms(self.marks))
            self._in_window = on

        def step(self):
            on, n = False, len(self.prefill_ev)
            if self.in_window:
                on = (len(self.marks) // args.block) % 2 == 1
                if args.arm == "bare":
                    bare(self.server, on)
                else:
                    self.server.trace(self.tracer if on else None)
            st = super().step()
            if self.in_window:
                self.marks.append((on, st, self.prefill_ev[n:]))
            return st

    def bare(server, on: bool) -> None:
        """The scheduler's and the executor's steps without their tracing
        wrappers (instance attributes over the methods) while ``on``."""
        sched, ex = server.scheduler, server.executor
        if not on:
            sched.__dict__.pop("step", None)
            ex.__dict__.pop("step", None)
            return

        def ex_step(tok, pos, caches, *, active=None):
            with ex.mesh_context():
                return ex._step(tok, pos, caches, active, None)
        sched.step = lambda: sched._step(None)
        ex.step = ex_step

    name = "bare" if args.arm == "bare" else "on"

    def arms(marks) -> dict:
        res = {}
        for on in (False, True):
            quiet = [(s.t1 - s.t0) * 1e3 for o, s, _ in marks if o == on and not s.admitted]
            ev = [(e0.elapsed_time(e1), n) for o, _, evs in marks if o == on
                  for (e0, e1), n in evs]
            tokens = sum(n for _, n in ev)
            res[name if on else "off"] = {
                "steps": sum(1 for o, _, _ in marks if o == on), "quiet_steps": len(quiet),
                "decode_step_ms": statistics.median(quiet) if quiet else None,
                "admissions": len(ev),
                "prefill_ms_per_ktok": sum(t for t, _ in ev) / (tokens / 1e3) if tokens else None,
            }
        return res

    with mock.patch.object(runner, "Loop", Loop):
        res, _ = runner.run_cell(spec.cell(args.cell), args.seed, args.seconds, True,
                                 device="cuda", t_start=time.perf_counter())
    on, off = out[name], out["off"]
    return {"correct": res["correct"], "block": args.block, **out,
            f"decode_step_ms_{name}_over_off": on["decode_step_ms"] / off["decode_step_ms"],
            f"prefill_ms_per_ktok_{name}_over_off":
                on["prefill_ms_per_ktok"] / off["prefill_ms_per_ktok"],
            "e2e": {k: v["value"] for k, v in res["metrics"].items()},
            "device": res["device"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("window", "cost"))
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--block", type=int, default=20, help="cost: steps a turn")
    ap.add_argument("--arm", choices=("tracer", "bare"), default="tracer",
                    help="cost: what the other turns run (the tracer on, or bare steps)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as bench/run.py
    result = (window if args.mode == "window" else cost)(args, torch)
    print(json.dumps({"mode": args.mode, "cell": args.cell, "seed": args.seed, **result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
