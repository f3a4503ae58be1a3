"""One run of one cell: set-up, the measured window, the metrics, and the
check of what the window served.

Set-up: the program's kernels are built (cached under the checkout's
``build/kernels``), the weights are drawn on the device from ``--seed``,
the port's ``PartitionedServer`` (K = 2) and its ``RequestScheduler``
are made, every graph key the window can use is captured (the edge
segment and the cloud segment at every bucket of the ladder, at the
cell's batch, on the fresh caches, before any request holds a row), the
clients' warm-start requests are admitted and a few steps run.

The window: the harness calls ``scheduler.step()`` and stamps the host
clock after each call; a client whose request retired in a step submits
its next one at once (closed loop).  A token counts in the window when the
step that emitted it ended inside it.  After the close no request is
submitted, and the run steps on until every request submitted in the
window has its first token (for TTFT).

``--trace 1`` adds the spans and the profile the per-layer metrics read:
CUDA events around every admission (``TierExecutor.prefill_rows``) in the
window, and, over a fixed stretch of steps that follows the window at
once under the same load, a ``torch.profiler`` profile of the device with
the host's own times of the scheduler's step, the admission and the tier
step.  Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import numpy as np

from bench.harness import check, spec, trace as trace_mod, weights
from bench.harness.peaks import H100_SXM
from bench.work import counts

#: Steps run after the warm-start admissions, before the window opens.
WARM_STEPS = 4
#: Steps in the profiled stretch of a ``--trace 1`` run.
TRACE_STEPS = 24
#: Served tokens the check's sample holds at least.
MIN_TOKENS = 400


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Step:
    """One decode step: host clock at entry and exit, what it admitted,
    and the work it did."""
    t0: float
    t1: float
    admitted: list  # prompt lengths
    live: int
    edge_valid: int  # valid K/V slots over the live rows (edge layers)
    cloud_valid: int  # valid K/V slots over the surviving rows (cloud layers)
    survivors: int
    bucket: int
    cloud_held: int  # K/V positions the cloud layers hold over the live rows


@dataclasses.dataclass
class Run:
    """What a per-layer metric reader reads."""
    model: dict  # the configuration file's ``model``
    split: int
    peaks: dict
    t_open: float
    t_close: float
    steps: list  # Step, window steps only
    prefill_ms: list  # (device ms, prompt tokens) per admission call (trace)
    profile: dict  # trace.reduce() of the profiled stretch (trace)
    stretch: list  # Step, the profiled stretch's steps (trace)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


def end_to_end(submit_t: dict, first_t: dict, tok_t: dict, t_open: float,
               t_close: float) -> tuple[dict, dict]:
    """The window's end-to-end numbers from the harness's clocks: when each
    request was submitted, when the step that emitted its first token
    ended, and when each step that emitted one of its tokens ended.

    ``tokens_per_s``: every token emitted by a step that ended inside the
    window, over the window's seconds.  ``ttft_p95_ms``: over every request
    submitted in the window, submission to the end of the step that emitted
    its first token (a request with none counts as infinite).
    ``tpot_p95_ms``: over every request with two or more tokens inside the
    window, its mean gap between them there.  Returns (metrics, the counts
    behind them)."""
    in_win = {r: [t for t in ts if t_open <= t <= t_close] for r, ts in tok_t.items()}
    tokens = sum(len(ts) for ts in in_win.values())
    submitted = [r for r, t in submit_t.items() if t_open <= t < t_close]
    ttft = [(first_t[r] - submit_t[r]) * 1e3 if r in first_t else math.inf
            for r in submitted]
    tpot = [(ts[-1] - ts[0]) * 1e3 / (len(ts) - 1) for ts in in_win.values() if len(ts) >= 2]
    metrics = {
        "tokens_per_s": tokens / (t_close - t_open),
        "ttft_p95_ms": percentile(ttft, 95) if ttft else math.inf,
        "tpot_p95_ms": percentile(tpot, 95) if tpot else math.inf,
    }
    return metrics, {"tokens": tokens, "submitted": submitted, "n_tpot": len(tpot),
                     "attempted": set(submitted) | {r for r, ts in in_win.items() if ts}}


def percentile(values, q: float) -> float:
    """The nearest-rank percentile (no interpolation)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class Loop:
    """The closed loop around the scheduler, with the harness's clocks and
    the per-slot counts that the work arithmetic needs."""

    def __init__(self, server, gen, torch, traced: bool):
        self.torch = torch
        self.server, self.sched, self.gen = server, server.scheduler, gen
        self.ex = server.executor
        self.traced = traced
        self.client_of: dict[int, int] = {}
        self.submit_t: dict[int, float] = {}
        self.prompts: dict[int, np.ndarray] = {}
        self.first_t: dict[int, float] = {}
        self.tok_t: dict[int, list] = {}
        self.retire_t: dict[int, float] = {}
        self.tok0: dict[int, tuple] = {}
        self.cloud_len = np.zeros(self.sched.slots, np.int64)
        self.steps: list[Step] = []
        self.open = False  # clients submit while True
        self.in_window = False  # admissions are timed while True (trace)
        self.prefill_ev: list = []
        self.ranges: list | None = None  # host (label, start, end) while profiling
        self._calls: list = []
        self._wrap()

    def _wrap(self) -> None:
        """Instance wrappers: every admission's first decode input (to
        check it later) and, traced, CUDA events and host ranges."""
        torch, ex, srv = self.torch, self.ex, self.server
        prefill, step = ex.prefill_rows, srv.step
        cuda = ex.device.type == "cuda"

        def prefill_rows(caches, tokens, rows):
            t0, ev = time.perf_counter(), None
            if self.traced and self.in_window and cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = prefill(caches, tokens, rows)
            if ev is not None:
                ev[1].record()
                self.prefill_ev.append((ev, int(np.asarray(tokens).size)))
            self._calls.append((np.asarray(rows), out[1].clone()))
            if self.ranges is not None:
                self.ranges.append(("admission.prefill_rows", t0, time.perf_counter()))
            return out

        def server_step(*a, **k):
            t0 = time.perf_counter()
            out = step(*a, **k)
            if self.ranges is not None:
                self.ranges.append(("tiers.step", t0, time.perf_counter()))
            return out

        ex.prefill_rows = prefill_rows
        if self.traced:
            srv.step = server_step

    def submit(self, req, now: float) -> None:
        rid = self.sched.submit(req.prompt, req.max_new_tokens)
        self.client_of[rid] = req.client
        self.prompts[rid] = req.prompt
        self.submit_t[rid] = now

    def step(self) -> Step:
        sched = self.sched
        self._calls = []
        t0 = time.perf_counter()
        rep = sched.step()
        t1 = time.perf_counter()
        if self.ranges is not None:
            self.ranges.append(("scheduler.step", t0, t1))
        admitted = []
        for rid in rep.admitted:
            r = sched.results[rid]
            admitted.append(r.prompt_len)
            self.cloud_len[r.slot] = r.prompt_len
            for rows, tok0 in self._calls:
                hit = np.flatnonzero(rows == r.slot)
                if hit.size:
                    self.tok0[rid] = (tok0, int(hit[0]))
        srv_rep = rep.server_report
        exited = np.asarray(srv_rep.exited_on_edge, bool)
        live_slots = [sched.results[rid].slot for rid in rep.emitted]
        edge_valid = int(sum(sched.pos[s] for s in live_slots))
        surv = [s for s in live_slots if not exited[s]]
        cloud_valid = int(sum(self.cloud_len[s] + 1 for s in surv))
        for s in surv:
            self.cloud_len[s] += 1
        comp = srv_rep.compaction[0] if srv_rep.compaction else None
        st = Step(t0, t1, admitted, len(live_slots), edge_valid, cloud_valid,
                  len(surv), comp.bucket if comp else len(live_slots),
                  int(sum(self.cloud_len[s] for s in live_slots)))
        for rid in rep.emitted:
            self.first_t.setdefault(rid, t1)
            self.tok_t.setdefault(rid, []).append(t1)
        for rid in rep.retired:
            self.retire_t[rid] = t1
            if self.open:
                self.submit(self.gen.next(self.client_of[rid]), t1)
        self.steps.append(st)
        return st


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, *, device: str,
             t_start: float, control: bool = False) -> tuple[dict, list]:
    """One run.  Returns (the result object, the check's lines)."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving import PartitionedServer

    cfg_file, mix = cell["config_file"], cell["mix"]
    m, serving = cfg_file["model"], cfg_file["serving"]
    cuda = device == "cuda"
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if cuda:
        from repro_torch.kernels import build

        build.build()
    marks.append(("kernel build", time.perf_counter()))
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    # One slot a client, each as long as the mix's longest request.
    gen = spec.generator(mix["generator"]).ClosedLoop(mix, seed, m["vocab_size"])
    slots = gen.clients
    server = PartitionedServer(
        cfg, weights.make(m, seed, device), serving["split"], device=device,
        slots=slots, context_len=gen.context_len)
    marks.append(("weights and server", time.perf_counter()))
    sched, ex = server.scheduler, server.executor

    # Every key the window can use, on the fresh caches: the prefills
    # below overwrite every row they admit.
    from repro_torch.core.multitier import bucket_ladder

    tok = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((slots,), dtype=torch.int32, device=device)
    none_exited = torch.zeros((slots,), dtype=torch.bool, device=device)
    for b in bucket_ladder(slots):
        ex.dispatch(tok, pos, sched.caches, {1: b}, none_exited)
    if cuda:
        torch.cuda.synchronize()
    del tok, pos, none_exited
    marks.append(("graph captures", time.perf_counter()))

    loop = Loop(server, gen, torch, traced)
    loop.open = True
    now = time.perf_counter()
    for req in gen.first():
        loop.submit(req, now)
    for _ in range(WARM_STEPS):
        loop.step()
    if cuda:
        torch.cuda.synchronize()

    marks.append(("warm start", time.perf_counter()))
    keys0, syncs0 = dict(ex.trace_counts), ex.host_syncs
    retries0, decode0 = ex.overflow_retries, sched.decode_steps
    n_setup = len(loop.steps)
    loop.in_window = True
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's generations
    alloc0 = torch.cuda.memory_stats().get("num_alloc_retries", 0) if cuda else 0
    t_open = time.perf_counter()
    t_close = t_open + seconds
    setup_s = t_open - t_start
    while time.perf_counter() < t_close:
        loop.step()
    loop.in_window = False
    alloc = (torch.cuda.memory_stats().get("num_alloc_retries", 0) - alloc0) if cuda else 0
    prof_data, stretch = {}, []
    if traced:
        # The profiled stretch follows the window at once, under the same
        # load: tracing slows what runs after it, so it stays out of the
        # window's own numbers.
        from torch.profiler import ProfilerActivity, profile

        if cuda:
            torch.cuda.synchronize()
        loop.ranges = []
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            h0 = time.perf_counter()
            if cuda:
                torch.cuda._sleep(1000)  # trace.MARKER
            stretch = [loop.step() for _ in range(TRACE_STEPS)]
            if cuda:
                torch.cuda.synchronize()
            h1 = time.perf_counter()
        prof_data = trace_mod.reduce(
            prof.events(), torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU, h0, h1, loop.ranges)
        loop.ranges = None
        del prof
    loop.open = False
    window_steps = [s for s in loop.steps[n_setup:] if s.t1 <= t_close]
    window_decode = sched.decode_steps - decode0
    syncs, retries = ex.host_syncs - syncs0, ex.overflow_retries - retries0
    captured = {k: n - keys0.get(k, 0) for k, n in ex.trace_counts.items()
                if n != keys0.get(k, 0)}
    pending = [r for r, t in loop.submit_t.items()
               if t_open <= t < t_close and r not in loop.first_t]
    for _ in range(10_000):
        if not pending:
            break
        loop.step()
        pending = [r for r in pending if r not in loop.first_t]
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # --- end-to-end numbers (host clock) --------------------------------
    e2e, acc = end_to_end(loop.submit_t, loop.first_t, loop.tok_t, t_open, t_close)
    e2e["setup_s"] = setup_s
    submitted, attempted, tokens = acc["submitted"], acc["attempted"], acc["tokens"]
    failed = [r for r in attempted if sched.results[r].status == "failed"
              or r not in loop.first_t]
    exits = sum(s.live - s.survivors for s in window_steps)
    live = sum(s.live for s in window_steps)
    log(f"[{cell['name']} seed {seed}] window {seconds} s: {len(window_steps)} steps, "
        f"{tokens} tokens, {len(submitted)} requests submitted, {acc['n_tpot']} with "
        f"TPOT, {len(loop.retire_t)} retired; edge exit share "
        f"{exits / max(live, 1):.4f}; overflow re-runs {retries}")
    log(f"[{cell['name']} seed {seed}] host syncs {syncs} = decode steps "
        f"{window_decode} + overflow re-runs {retries}: "
        f"{'yes' if syncs == window_decode + retries else 'NO'}; "
        f"keys captured in the window: {captured or 'none'}; allocator retries {alloc}")
    steady = syncs == window_decode + retries and not captured
    split, ctx = serving["split"], gen.context_len
    held = [counts.cache_bytes(m, split, s.edge_valid, s.cloud_held, s.live)
            for s in window_steps] or [0.0]
    log(f"[{cell['name']} seed {seed}] caches: {slots} slots x {ctx} positions reserve "
        f"{counts.cache_bytes(m, split, slots * ctx, slots * ctx, slots) / 1e9:.2f} GB; "
        f"the traffic fills {np.mean(held) / 1e9:.2f} GB on average over the window's "
        f"steps, {max(held) / 1e9:.2f} GB at most; peak allocated {peak / 1e9:.2f} GB")

    run = Run(m, split, H100_SXM, t_open, t_close, window_steps,
              [], prof_data, stretch)
    if traced and cuda:
        run.prefill_ms = [(ev[0].elapsed_time(ev[1]), n) for ev, n in loop.prefill_ev]

    # --- the check: sample, free the program, run the reference ----------
    finished = [r for r, t in loop.retire_t.items() if t_open <= t <= t_close]
    sample = check.sample(finished, sched, seed, MIN_TOKENS)
    seqs = check.gather(sched, sample, loop.prompts, loop.tok0)
    del loop, sched, ex, server
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = check.judge(m, serving["split"], seed, seqs, device, control=control)
    log(f"[{cell['name']} seed {seed}] set-up seconds: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(marks, marks[1:]))
        + f"; the check took {time.perf_counter() - t_check:.2f} s")
    limits = cell["check"]["limits"]
    numbers, within = check.compare(readings, limits)
    sound = steady and not failed and bool(seqs) and all(len(s["served"]) for s in seqs)
    correct = sound and within
    lines = [f"check, not compared, {k}: {v!r}" for k, v in readings.items() if k not in limits]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in numbers.items()]
    lines.insert(0, f"check sampled {len(seqs)} requests, {sum(len(s['served']) for s in seqs)} "
                    f"served tokens; steady window: {steady}")

    # --- the metrics ------------------------------------------------------
    metrics = {}
    if not traced:
        for entry in cell["end_to_end"]:
            metrics[entry["name"]] = {"value": e2e[spec.quantity(entry["name"])],
                                      "unit": entry["unit"]}
    else:
        for entry in cell["per_layer"]:
            value = spec.metric_reader(entry["name"]).read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(attempted),
        "failed": len(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if traced and prof_data:
        busy = trace_mod.busy_us(prof_data) * 1e-6
        lo, hi = prof_data["span"]
        result["device"].update(busy_s=busy, window_s=(hi - lo) * 1e-6)
        result["breakdown"] = trace_mod.breakdown(prof_data)
    if control:
        result["control"] = {k: readings[k] for k in readings if k.startswith("control_")}
        # The same comparison that decides ``correct``, on the control's readings.
        result["control_correct"] = sound and check.compare(readings, limits, "control_")[1]
    result["check"] = numbers
    return result, lines
