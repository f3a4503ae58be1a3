#!/usr/bin/env python3
"""What a served segment's capture costs, captured through
``torch.cuda.graph`` (which synchronizes the device and empties the
device and pinned-host allocator caches on entry) against
``CUDAGraph.capture_begin`` / ``capture_end`` on the capture stream (what
``TierExecutor`` does), in one process on one card.

    python3 experiments/capture_sync_ab.py [--arch phi3_mini_3_8b mamba2_130m]

For each config (full width and depth, seed-0 random weights, threshold
0.5, split at three quarters of the trunk, 8 slots x 4096, 8 prompts of
128 tokens from numpy seed 0, 4 new tokens each), a fresh
``PartitionedServer`` on the same weights serves the prompts once per
trial, the two capture paths in the order context, begin, begin, context,
three times.  Each trial reads, on the host clock: the admission, the
first decode step (both segments' first use: an eager step and a capture
each), the median of the later steps (replays), the median TTFT, the
host syncs of the first decode step that ``set_sync_debug_mode("warn")``
reports (implicit ones only: an explicit ``torch.cuda.synchronize`` is not
reported), and one compacted dispatch that captures a new key, queued
behind a spin kernel of about a second: its host time, and whether the
spin still ran when it returned (a host that waited at any sync returns
after the spin).  The spin probe holds only while the dispatch enqueues
fewer launches than the card's launch queue holds: Zamba2-1.2B's cloud
segment fills it, and its host then blocks in ``cudaLaunchKernel``
("Command Buffer Full") with no sync at all, so ``chip_smoke.py`` lists
the synchronizing CUDA calls under the profiler instead.  The first step's
tokens must be equal in every trial.  Needs
one CUDA card and ``nvcc``; the last line is a JSON object with every
trial.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SLOTS, CONTEXT, PROMPT, NEW_TOKENS, SEED = 8, 4096, 128, 4, 0
SPIN_CYCLES = 2_000_000_000  # about 1 s at 1.98 GHz


def context_capture(self, fn, args, caches, binding):
    """``TierExecutor._capture`` with the capture inside
    ``torch.cuda.graph``."""
    import torch

    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.serving.tiers import _Graph

    if self._stream is None:
        self._stream = torch.cuda.Stream(self.device)
    stream, cur = self._stream, torch.cuda.current_stream(self.device)
    inputs = tuple(a.clone() for a in args)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = self._run_segment(fn, caches, *inputs)
    cur.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with kernel_ops.recording() as recorded, torch.cuda.device(self.device), \
            torch.cuda.graph(graph, stream=stream):
        static = self._run_segment(fn, caches, *inputs)
    return out, _Graph(binding, graph, inputs, static, recorded)


def trial(torch, cfg, wparams, split, path: str) -> dict:
    import numpy as np

    from repro_torch.serving import PartitionedServer, TierExecutor

    begin_capture = TierExecutor._capture
    if path == "context":
        TierExecutor._capture = context_capture
    try:
        srv = PartitionedServer(cfg, wparams, split, device="cuda", slots=SLOTS,
                                context_len=CONTEXT)
        rng = np.random.default_rng(SEED)
        rids = [srv.submit(rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32),
                           NEW_TOKENS) for _ in range(SLOTS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.scheduler._admit()
        admit_ms = (time.perf_counter() - t0) * 1e3
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                rep = srv.run(max_steps=1)[0]
                first_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
        tokens = rep.server_report.tier_result.tokens.tolist()
        # A compacted dispatch (a new bucket-4 key: an eager step and a
        # capture) behind a spin kernel: a host that waited for the card at
        # any sync returns after the spin has finished.
        ex, sched = srv.executor, srv.scheduler
        pos_t = ex._upload(sched.pos.copy(), torch.int32)
        exited0 = ex._upload(~sched.active, torch.bool)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        spin = torch.cuda.Event()
        spin.record()
        t0 = time.perf_counter()
        ex.dispatch(sched.tok_dev, pos_t, sched.caches, {1: SLOTS // 2}, exited0)
        capture_ms = (time.perf_counter() - t0) * 1e3
        spinning = not spin.query()
        torch.cuda.synchronize()
        later = []
        while srv.scheduler.active.any():
            t0 = time.perf_counter()
            srv.run(max_steps=1)
            later.append((time.perf_counter() - t0) * 1e3)
        out = dict(path=path, admit_ms=admit_ms, first_step_ms=first_ms,
                   capture_dispatch_ms=capture_ms, spin_outlived_dispatch=spinning,
                   later_step_ms=statistics.median(later),
                   ttft_s=statistics.median(srv.scheduler.results[r].ttft_s
                                            for r in rids),
                   first_step_syncs=syncs, captured=sum(ex.trace_counts.values()),
                   replays=sum(ex.replays.values()), tokens=tokens)
    finally:
        TierExecutor._capture = begin_capture
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["phi3_mini_3_8b", "mamba2_130m"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serving import PartitionedServer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build()
    result = {"card": card, "torch": torch.__version__, "configs": {}}
    for arch in args.arch:
        cfg = dataclasses.replace(get_config(arch), exit_threshold=0.5)
        split = cfg.num_layers * 3 // 4
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = init_params(cfg, gen, "cuda")
        # The compute copies, which every later server shares.
        wparams = PartitionedServer(cfg, params, split, device="cuda").params
        del params
        trial(torch, cfg, wparams, split, "begin")  # loads kernels, cuBLAS
        runs = []
        for _ in range(3):
            for path in ("context", "begin", "begin", "context"):
                runs.append(trial(torch, cfg, wparams, split, path))
                r = runs[-1]
                print(f"{cfg.name} {path:8s} admission {r['admit_ms']:8.3f} ms, first "
                      f"step {r['first_step_ms']:8.3f} ms ({r['first_step_syncs']} "
                      f"syncs), later steps {r['later_step_ms']:7.3f} ms, TTFT "
                      f"{r['ttft_s']:.4f} s; a capturing dispatch "
                      f"{r['capture_dispatch_ms']:8.3f} ms, spin outlived it: "
                      f"{r['spin_outlived_dispatch']}; {r['captured']} captured, "
                      f"{r['replays']} replays", flush=True)
        if any(r["tokens"] != runs[0]["tokens"] for r in runs):
            raise SystemExit(f"FAILED: {cfg.name}: first-step tokens differ between trials")
        summary = {}
        for path in ("context", "begin"):
            mine = [r for r in runs if r["path"] == path]
            summary[path] = {k: statistics.median(r[k] for r in mine)
                             for k in ("admit_ms", "first_step_ms", "later_step_ms",
                                       "ttft_s", "first_step_syncs",
                                       "capture_dispatch_ms")}
            summary[path]["spin_outlived_dispatch"] = [
                r["spin_outlived_dispatch"] for r in mine]
            print(f"{cfg.name} {path}: medians {json.dumps(summary[path])}", flush=True)
        result["configs"][cfg.name] = {"split": split, "median": summary,
                                       "trials": [{k: v for k, v in r.items()
                                                   if k != "tokens"} for r in runs]}
        del wparams
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
