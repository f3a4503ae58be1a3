#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--log PATH]

Drives the port (``src/repro_torch``) on the card and fails (non-zero
exit) if any phase fails:

  1. device — the card's name and ``nvidia-smi`` power limit; TF32 off;
  2. build — compiles every CUDA kernel of the port from ``src`` with
     ``nvcc`` (sm_90a), one process per source, all at once, into
     ``build/kernels``;
  3. kernels — each Hopper kernel against its plain PyTorch version at the
     main paths' shapes, with the tolerance stated beside each check, and
     its time (``torch.profiler`` device time per call, three windows of
     30 calls, two of which must hold whole event counts and agree, a
     fourth taken when two are short, at most four left out in the run;
     and it may not read below the bound), the plain
     version's time, the time of one PyTorch library call computing the
     same function where one exists, and its bound (the largest of bytes /
     3.35 TB/s, fp32 operations / 67 TFLOP/s and TF32 tensor-core
     operations / 495 TFLOP/s, counted on these inputs: flash_decode's
     bytes are those of the valid slots only).  flash_decode is also held
     at the serving shape (~136 valid slots of 4096), on a fully masked
     row, a wrapped ring, B = 1 over a full cache and every head layout
     its wrapper accepts (G, even D, K/V aligned or not), and each row of
     the serving batch must equal, bit for bit, the same row computed
     alone; ssd_scan also with fp32 B, C and misaligned token strides;
     the exit kernel at both load widths its launcher picks (16-byte and
     scalar: V = 5003, 5002, logits 2 and 4 bytes off 16-byte alignment,
     bitwise equal to the aligned launch), with splits of pad lanes only and empty splits,
     each K=2 and K=3 head slice equal to its K=1 launch and each row to the
     row alone, bit for bit; Qwen3-8B's shapes too: the exit kernel at
     V = 151,936 (K = 2 and 3, B = 8) and flash_decode at its serving
     layout (Kh = 8, G = 4, D = 128, ~1,100 valid slots of 4096), each with
     its device time and bound (and SDPA's GQA mode beside flash_decode);
     the train_branchy example's serving leg's shapes: the exit kernel at
     K = 1, B = 16, V = 512 and flash_decode at B = 16, Kh = 4, G = 1,
     D = 64 over a 96-slot ring; the later served layouts: the exit kernel
     at Phi-3-medium's V = 100,352 (K = 2, 3), InternVL2's V = 128,256
     (K = 3), DeepSeek-V3's V = 129,280 (K = 2) and Whisper's 51,865
     padded to 51,968 (K = 3 and 2, 103 pad lanes), flash_decode at
     Phi-3-medium's Kh = 10, G = 4,
     Qwen3-30B-A3B's Kh = 4, G = 8 and InternVL2's Kh = 8, G = 8 (D = 128)
     and Whisper's Kh = 16, G = 1, D = 64,
     each bitwise per head and per row, with device time and bound (and
     SDPA's GQA time); flash_decode's two routes (the grouped route: G in
     {4, 8}, D % 16 == 0, aligned K/V; the split route: every other
     layout) logged per case, and two grouped cases with many valid
     slots: "G=8 full cache" (B = 1, Kh = 4, G = 8, D = 128, all 4096
     slots valid) and "G=4 wide" (B = 8, Kh = 8, G = 4, D = 128, q_pos in
     [C/2, C), 10% holes), each held at one bf16 ulp, row by row against
     the row alone, and timed beside SDPA;
  3b. mla layer — one DeepSeek-V3 MLA layer at its published width (d
     7168, 128 heads of 128, q_rank 1536, kv_rank 512, rope 64), bf16,
     8 rows: a 128-token prompt into a latent ring of 4096 slots, then 16
     absorbed decode steps, each held within 8 bf16 ulps at the output's
     scale of the naive expanded form on the same ring (per-head K/V
     through ``prefill_attention``); the ring's bytes per slot against a
     GQA ring of the same heads, and both forms' device time (plain
     PyTorch: MLA has no kernel in either package);
  4. end to end — seven paths, each a ``PartitionedServer`` at full
     published width (and depth, but for DeepSeek-V3) with random
     weights from a seeded
     ``torch.Generator``, 8 slots x 4096 context:
       * Phi-3-mini 3.8B (dense GQA), split 24, edge branches 8 and 16;
       * Zamba2-1.2B (Mamba2 trunk + shared attention block after every 6th
         layer), split 24, edge branches 9 and 19, sites 6..24 on the edge
         and 30, 36 in the cloud;
       * Mamba2-130M (attention-free, tied embeddings, 152 vocabulary pad
         lanes), split 18, edge branches 6 and 12;
       * Qwen3-8B (dense GQA with qk-norm, bf16 params, vocabulary
         151,936), split 20, edge branches 9 and 18;
       * Phi-3-medium 14B (dense GQA, Kh = 10, bf16 params, vocabulary
         100,352), split 21, edge branches 10 and 20, served at the median
         threshold only;
       * Qwen3-30B-A3B (48 GQA + routed-expert layers: 128 experts, top-8,
         the reference's einsum dispatch; bf16 params, 61 GB), split 25,
         edge branches 12 and 24;
       * DeepSeek-V3 (MLA, 256 routed experts of moe_d_ff 2048, top-8, 1
         shared; vocabulary 129,280; bf16 params, 54.4 GB) at full width
         and 5 of 61 layers: 3 dense MLA layers (d_ff 18,432), then 2 MoE
         layers; branches 2 and 4, split 4 (the edge runs both stacks and
         decides branch 2; 4 sits at the cut), and the swap goes to split
         3, the stack boundary.  Its only kernel is the exit kernel.
         Kernel vs plain on both MoE paths: their first steps are
         also run on eager twins of both paths that record every MoE
         layer's router logits and top-k; a row whose logits (or entropy,
         or exit mask) differ beyond the bound is listed instead of
         compared only when its routing (top-k set or kept experts) differs
         at some layer and the first layer where a top-k set differs shows
         a flip at a near-tie: each differing token's top-k margin within
         8 bf16 ulps of its k-th logit, the two paths' router logits within
         8 bf16 ulps of their scale at every layer up to that one.
     The bf16-param cells log ``init_params``' peak memory beside the
     params' size.
     For each: the admission's last-position logits and the first decode
     step on the kernel path against the plain path (logits within 8 bf16
     ulps at their scale, pad lanes left out; a row whose first decode input
     flipped at an admission near-tie is listed, not compared; at the median
     threshold, exit masks equal away from the threshold), one
     compacted step's dispatch replaying its segment graphs under
     ``torch.cuda.set_sync_debug_mode("error")``, then 8 requests of
     128-token prompts through ``submit`` / ``run`` at two exit thresholds
     (never-exit 0.5, and the median first-branch entropy, where rows exit
     on the edge and the cloud runs compacted buckets), asserting that
     every kernel of the path launched.  The served step replays a CUDA
     graph per cached segment: each run is held bitwise (tokens, exit
     masks, takes, entropies, logits, buckets, re-runs) against a
     ``graphs=False`` twin serving the same requests (where the graphed
     side replays its admission rungs, the twin calls the same padded body
     directly), at the median
     threshold with the hints pinned low at the third step (a forced
     overflow re-run on both), no key may be captured twice in a run, and
     the decode step's host-clock ms, device ms per step (profiler), idle
     share and tokens/s are printed for both.  Phi-3-mini adds a short run
     with ``heads_batched=False`` for the single-head exit kernel, and
     ``set_split`` 16 -> 24 -> 16 -> 24 whose last two legs capture
     nothing; DeepSeek-V3 the same swap 3 -> 4 -> 3 -> 4.  Kernel launch
     counts are reset just before each run and
     read just after it; a graph replay adds the launches its capture
     recorded.
  5. partition — the paper's control plane on the resident weights, at the
     median threshold: Phi-3-mini's 32 layers profiled in measure mode
     (each layer captured as a CUDA graph with the kernels, 10 replays
     between CUDA events) and analyze mode (FLOP and byte counters over
     the plain lowering), each measured t_c at or above its H100 floor and
     within twice the device time of a layer of its kind, the first and
     last layer's at or above their own device time, each capture holding
     one launch of each kernel its layer runs and a replay showing those
     kernels' device events, and each alpha ==
     8 x 3072 x 2 bytes; the K=1 ``ServingEngine`` (all three
     heads in one exit launch) calibrates p_k over 8 steps, its first step
     held against the plain path; the cut solved for 3g, 4g and wifi
     (gamma 25, a 32 KiB raw input) with Dijkstra = brute force =
     ``solve_chain_torch`` in float64 on the card, plus a 64-point
     bandwidth sweep in one vmapped call; each distinct solved split served
     once by one ``PartitionedServer`` (finite ``est_latency_s``, exact bytes, one host
     sync per step) and the example's K=3 lattice plan by a
     ``MultiTierServer`` (exact bytes on every hop); a K=3 cut move
     (8, 24) -> (16, 24) at threshold 0.5 captures only the two changed
     segments (the cloud replays its graph); the ``RepartitionController``
     on the 4g profile installs solve_phase's 4g split, moves to its 3g
     split on ``update_network``, and re-solves from measured exits as the
     scheduler's ``on_step`` hook (drift check every 4 steps, a probe step
     every 3rd); and two servers on equal caches, one probing (all heads,
     then half the rows sampled), keep tokens, exits and every cache
     tensor bitwise equal.  Zamba2-1.2B's 38
     layers are profiled (the same checks; site layers against the first
     site layer) and one preset solved inside its e2e phase.
  4b. link and faults (Qwen3-8B, on its resident weights) — split 20
     served without simulation, then with ``simulate_network`` over an
     uplink that ships the batch in one graphed step, serial and
     pipelined, on the same requests (the hints pinned at the third step:
     a forced re-run, paid serially by the pipelined server): tokens,
     masks, bytes and sim seconds bitwise equal across the three, host
     syncs = steps + re-runs, ``pipeline_fallbacks`` = re-runs, the step
     ms of both modes printed beside device ms and ``est_latency_s``; a
     zero uplink raises ``LinkDownError``; a benign fault model is bitwise
     invisible; a link kill at split 18 degrades through head 18 (graphed
     == eager twin bitwise, one sync per step, the degrade key captured
     once and replayed, each forced token the argmax of head 18's logits);
     at split 8 a kill fails the step with no sync, capture, replay or
     launch and the slots are reclaimed, and with ``requeue_on_fail``
     after a finite flap every request completes; K=3 on the example's
     fault fleet: the breaker opens and the controller moves the cut off
     the killed hop.
  6. alexnet (run after phase 3, before the end-to-end paths) — the
     paper's B-AlexNet at batch 1 in fp32, random weights from a seeded
     ``torch.Generator``, with cuDNN and cuBLAS TF32 switched on around
     the phase so that the model must turn them off itself: each layer and
     both logits on the card within 1e-4 of the same weights on the CPU;
     its measure-mode profile (graph replays), each t_c at or above its
     H100 floor (fp32 FLOPs at 67 TFLOP/s or weight, input and output
     bytes at 3.35 TB/s) and its device time; the Fig. 4 and Fig. 5
     sweeps of ``repro_torch.benchmarks`` on that profile, holding E[T]
     non-increasing in p and the split non-increasing in gamma on every
     curve and logging the profile-dependent claims; Dijkstra ==
     ``solve_chain_torch`` == the sweep at both ends of every Fig. 5 curve.

  4c. vlm engine — InternVL2 (d 8192, 64 heads and 8 KV heads of 128,
     d_ff 28,672, vocabulary 128,256) at full width with its depth cut to
     16 of 80 layers (branches 4, 8, 12), bf16 params, on the K=1
     ``ServingEngine``: ``start`` on 8 prompts of 1,024 seeded patch
     embeddings and 128 tokens (``pos`` = 1,152), then 16 decode steps on a
     graphed engine held bitwise against its eager twin; the first step
     against a plain engine (logits within 8 bf16 ulps, branch entropies
     within 1e-5 + 2 x each row's first-order bound); one exit launch a
     step for all three heads, ``flash_decode`` in every layer.
  4d. whisper — Whisper-medium (24 encoder and 24 decoder layers, d 1024,
     16 heads of 64, d_ff 4096 GELU, vocabulary 51,865 padded to 51,968) at
     full width and depth, fp32 params, 8 prompts of 128 tokens each with
     1,500 seeded frame embeddings: the K=1 engine (branches 6, 12, 18 in
     one exit launch) as InternVL2's, ``start`` (encoder, cross K/V,
     decoder prefill) logged as the path's TTFT with its peak memory; the
     K=2 ``PartitionedServer`` at split 18 (``prefill`` then
     ``server.step``: the scheduler refuses audio; ``hint_window`` 1) at
     threshold 0.5 and at the K=1 engine's median smaller edge entropy
     (compacted cloud buckets of survivors), graphed == eager twin bitwise
     with a
     forced overflow re-run, one host sync a step plus one per re-run, 24
     ``flash_decode`` launches and one exit launch per dispatch, device ms
     and idle share from three profiled steps; the 24 decoder layers
     profiled in measure mode (graph replays over caches holding the cross
     K/V) and the split solved once for 4g.
  4e. sharded — mesh-sharded tiers on Qwen3-8B at full width and depth:
     ``profile_decode_layers`` in analyze mode at 1, 2, 4 and 8 devices
     (each t_c(d) == t_c(1) / d + the collective term) and in measure mode
     at 4 (the plain path) beside 1 (the kernels), the K=2 cut solved with
     the cloud as one card and as four over NVLink (and over a small
     gamma / uplink grid); the sharding policy over all ten configs at
     full size on duck-typed meshes (model 8; data 16 x model 16), a walk
     over meta tensors: per-card param and cache bytes, replicated leaves,
     every leaf sharded evenly or replicated, what fits 80 GB; then the
     unsharded K=2 server at split 20 (eager, plain path) at 0.5 and at
     step 0's median branch-9 entropy, freed, and the same server on a
     (1, 2) mesh of two ranks that share this one card over gloo
     (``RankPool``; the functional all-gather gloo's CUDA path does not
     return from moves through host tensors), each rank drawing the same
     params and sharding them, fed the baseline's tokens: tokens, exit
     masks, shipped counts, logits within 8 bf16 ulps and entropies within
     their rows' first-order bounds step by step, one host sync a step per
     rank, no kernel launched, kernels and graphs resolved off, a
     ``Shard``-placed leaf; the step ms of the two ranks (not a two-card
     time) and each rank's bytes and peak.
  4f. dryrun — the launch layer's dry run (``repro_torch.launch.dryrun.
     run_one``) at full published size on the (16, 16) production mesh of
     a fake 256-rank process group, every leaf a DTensor whose local shard
     lives on the ``meta`` device.  Host work only: it runs in two spawned
     processes beside the sharded phases (4e, 4g), and this phase waits
     for them after 4g and checks their records.  Every configuration at
     ``decode_32k``, OLMo-1B and Qwen3-8B at ``train_4k``, Qwen3-8B at
     ``prefill_32k``: each ``ok``, with ``torch.cuda.memory_allocated()``
     unchanged and no process group left behind, and its per-device param
     bytes equal to the policy walk's (data 16 x model 16, in the params'
     own dtypes); Whisper at ``long_500k`` comes back ``skipped``.  Each
     record's argument bytes, eager peak, dot FLOPs x 256 beside 2 x
     active params x tokens (6 x for a train step) and collective bytes
     are printed.  No kernel runs: the dry run computes nothing.
  4g. sharded train — OLMo-1B at full width and depth (bf16 params and
     compute, fp32 moments, remat on): 3 AdamW steps of 4 x 256 tokens at
     accum 1 and at accum 2, unsharded in this process from the seed-0 state and
     batch (then freed), then by two ranks sharing the card over gloo
     (``RankPool``) on a (1, 2) and a (2, 1) mesh, each from the same
     seeded state placed by the policy: every step's loss and grad_norm,
     every param and each rank's shard of every AdamW moment leaf after
     the last step, within the bounds at ``STRAIN_*`` of the unsharded
     run's; every optimizer-state leaf in
     its ``opt_state_shardings`` placement after the last step; no kernel
     launched.  Step ms per rank (host clock: two ranks on one card, not a
     two-card time) and each rank's peak GB.

  7. example — ``python -m repro_torch.examples.serve_partitioned`` on the
     card at its smoke size, in a process of its own; it must exit 0.
  8. train — OLMo-1B (16 layers, d 2048, tied vocabulary 50304, branches
     4 / 8 / 12, grad_accum 2: the dense attention backward) and
     Zamba2-1.2B (38 Mamba2 layers and the shared block, branches 9 / 19 /
     29, grad_accum 4: the SSD backward) at published widths and depth,
     seed-0 weights, fp32 params, bf16 compute, remat on: 6 AdamW steps
     with a cosine schedule on one global batch of 8 x 1024 tokens from
     ``make_batch``.  The loss falls, every grad_norm and param is finite,
     ``step == 6``, a params checkpoint saved and restored on the card is
     bitwise equal; OLMo-1B's first step at accum 1 within 5e-3 of the
     accum-2 loss, remat off at the same loss, and one step with the
     trunk's old per-layer indexing of the stacks beside the unbinding one.
     Printed with the card's name and power limit: step ms (median of
     steps 2-6, host clock), tokens/s, peak GB beside the static 16
     B/param, profiler device ms of one more step with its top kernels,
     model FLOPs and their share of 989 TFLOP/s.  No kernel of the port
     runs in training, as none of the reference's does.
  9. fig6 — the paper's Fig. 6 (``repro_torch.benchmarks.
     fig6_calibration``): B-AlexNet trained 30 SGD steps of 16 synthetic
     images, 48 evaluation images at blur kernels 5 / 15 / 65, 20
     thresholds; one SGD step at batch 2 held against float64 on the CPU
     (2e-2 of its scale; TF32 would miss by ~0.17) with TF32 switched on
     outside the model; each curve finite and monotone; the
     ordering low >= mid >= high reported, not asserted.
  10. train example — ``python -m repro_torch.examples.train_branchy``
     with its defaults, in a process of its own: it exits 0, prints its
     checkpoint round trip, and its ``ServingEngine`` leg launches
     ``flash_decode`` and the exit kernel (the ``kernels`` line counts
     those launches under ``train_branchy``).  Then that serving leg
     again in this process, on the checkpoint the example wrote: its
     graphed engine bitwise equal to an eager twin, and held step by step
     against a ``use_kernels=False`` twin (logits, entropies, exit masks,
     tokens; the exit kernel also against its plain version on the path's
     own branch logits).

``--log PATH`` also writes every printed line to PATH, whole, for runs
whose output is cut to its end.  The line before the last is the JSON
``kernels`` record (``launches``: the
sum over the end-to-end and partition runs of the kernels the card ran,
counted by the wrappers where Python launches a kernel; a graph replay
reruns the captured kernels without Python: a served segment's replay
adds the launches its capture recorded (the capture runs nothing), and
the measure-mode profile adds ``iters`` launches for each launch it
captured (its untimed replay stands for the capture); ``launches_by_path``
splits it); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src`` beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
_log_file = None

HBM_BPS = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores
TF32_TC_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value
SEED = 0
N_REQ, PROMPT, NEW_TOKENS = 8, 128, 16
SLOTS, CONTEXT = 8, 4096


@dataclasses.dataclass(frozen=True)
class E2EPath:
    """One end-to-end path: the configuration, its cut, the new tokens per
    request, the branch whose median entropy sets the mixed threshold, and
    the kernels it must launch."""

    arch: str
    split: int
    new_tokens: int
    branch: int
    kernels: tuple[str, ...]
    single_head: bool = False
    partition: str = ""  # "full": profile, calibrate, solve, serve; "profile"
    link: bool = False  # the link, pipelined overlap and the fault plane
    bf16_params: bool = False  # the config's fp32 params would not fit
    median_only: bool = False  # serve at the median threshold only
    swap_to: int = 0  # set_split to this cut and back (swap_phase)
    reduced: tuple = ()  # (field, value) pairs cutting the config's depth


PATHS = (
    E2EPath("phi3_mini_3_8b", 24, NEW_TOKENS, 8,
            ("flash_decode", "entropy_exit_argmax_heads"), single_head=True,
            partition="full", swap_to=16),
    E2EPath("zamba2_1_2b", 24, NEW_TOKENS, 9,
            ("ssd_update", "ssd_scan", "flash_decode", "entropy_exit_argmax_heads"),
            partition="profile"),
    E2EPath("mamba2_130m", 18, 4, 6,
            ("ssd_update", "ssd_scan", "entropy_exit_argmax_heads")),
    E2EPath("qwen3_8b", 20, NEW_TOKENS, 9,
            ("flash_decode", "entropy_exit_argmax_heads"), link=True),
    E2EPath("phi3_medium_14b", 21, NEW_TOKENS, 10,
            ("flash_decode", "entropy_exit_argmax_heads"), bf16_params=True,
            median_only=True),
    E2EPath("qwen3_moe_30b_a3b", 25, NEW_TOKENS, 12,
            ("flash_decode", "entropy_exit_argmax_heads"), bf16_params=True),
    # DeepSeek-V3 at full width, 5 of its 61 layers (671 B params are 1.34
    # TB in bf16): the 3 dense MLA layers, then 2 MoE layers.  Split 4 puts
    # the stack boundary inside the edge tier, which decides branch 2 (4
    # sits at the cut and is discarded); the swap to 3 cuts at the boundary.
    # MLA runs no kernel, in either package.
    E2EPath("deepseek_v3_671b", 4, NEW_TOKENS, 2, ("entropy_exit_argmax_heads",),
            bf16_params=True, swap_to=3,
            reduced=(("num_layers", 5), ("first_k_dense", 3), ("branch_layers", (2, 4)))),
)


_T0 = time.perf_counter()


def stamp(what: str) -> None:
    """A phase boundary, with the seconds since the script started."""
    log(f"[{time.perf_counter() - _T0:.1f} s] {what}")


def log(msg: str) -> None:
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


def rotating(fn, sets):
    """A call taking the next of ``sets`` each time.  The sets together
    exceed the 50 MB L2, so each timed call finds its operands cold, as the
    decode step does (it touches the whole model between two launches of
    one layer's kernel)."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


WINDOW_SPREAD = 1.5  # largest / smallest whole window a kernel may show
#: Profiled windows short of the full event count that one device_ms
#: measurement may leave out (so it takes at most 2 + this many), and that
#: the whole run may leave out.
MAX_SHORT, MAX_SHORT_RUN = 2, 4
SHORT_WINDOWS: list = []  # (match, events kept, full events) of each one left out
#: CUDA API calls (runtime `cuda*`, low-level `cu*`) that make the host wait
#: for the card.
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
              "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
              "cudaFree", "cudaFreeHost", "cuMemFree", "cuMemFreeHost", "cudaMemcpy",
              "cudaMemset")


def sync_calls(torch, fn) -> list[str]:
    """Run ``fn`` under ``set_sync_debug_mode("error")`` (which raises at a
    stream sync, such as a blocking copy) and ``torch.profiler``, and return
    the synchronizing CUDA API calls (SYNC_CALLS, by exact name) made
    between its start and end: an explicit ``torch.cuda.synchronize`` or an
    allocator flush shows there, unseen by the debug mode.  The profiler's
    own start and stop fall outside that window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function("sync_calls window"):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    win = [e.time_range for e in prof.events() if e.name == "sync_calls window"
           and e.device_type == torch.autograd.DeviceType.CPU]
    if len(win) != 1:
        raise SystemExit(f"FAILED: sync_calls found {len(win)} profiled windows")
    lo, hi = win[0].start, win[0].end
    return [e.name for e in prof.events()
            if e.name in SYNC_CALLS and lo <= e.time_range.start <= hi]


def device_ms(fn, match: str | None = None, iters: int = 30):
    """Device time of one call from ``torch.profiler``: the device events
    (kernels, copies, fills) whose name contains ``match`` (None: all of
    them) over ``iters`` calls, divided by ``iters``, in three profiled
    windows.  With ``match`` (a kernel's own events) each window must hold
    the same whole number of events per call: a window with fewer has lost
    events in the profiler, is logged with its count and left out, and a
    fourth window is taken when only one of three is whole; the run fails
    unless two windows are whole and agree within WINDOW_SPREAD (so at most
    MAX_SHORT are short), and ``main`` fails it when more than
    MAX_SHORT_RUN windows were left out over the whole run
    (``SHORT_WINDOWS``).  Without ``match`` (a plain version or a library
    call: all device events) it takes the median window.  Returns (ms, source, events per
    call: the most any window recorded, over ``iters``); falls back to
    :func:`time_ms` (CUDA events, which include host launch gaps; no
    events) when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    windows = []  # (events, ms per call)

    def whole_windows():
        return sum(n == max(m for m, _ in windows) for n, _ in windows)

    while len(windows) < 3 or (match is not None and whole_windows() < 2
                               and len(windows) < 2 + MAX_SHORT):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (match is None or match in e.name)]
        windows.append((len(ev), sum(ev) / iters / 1e3))
    if max(ms for _, ms in windows) <= 0:
        return time_ms(fn, iters), "cuda-events", 0
    full = max(n for n, _ in windows)
    if match is None:
        return statistics.median(ms for _, ms in windows), "profiler", full // iters
    whole = [ms for n, ms in windows if n == full]
    for i, (n, ms) in enumerate(windows):
        if n != full:
            log(f"  profiler window {i} of {match!r} kept {n} of {full} device "
                f"events ({ms:.5f} ms per call): left out")
            SHORT_WINDOWS.append((match, n, full))
    check(full % iters == 0 and len(whole) >= 2,
          f"{match}: {len(whole)} of {len(windows)} profiler windows whole "
          f"({[n for n, _ in windows]} events for {iters} calls)")
    check(max(whole) <= WINDOW_SPREAD * min(whole),
          f"{match}: whole profiler windows agree within {WINDOW_SPREAD}x "
          f"({', '.join(f'{ms:.5f}' for ms in whole)} ms per call)")
    left = len(windows) - len(whole)
    src = "profiler" if not left else f"profiler, {left} window(s) left out"
    return statistics.mean(whole), src, full // iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"  ok: {what}")


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate,
    fp32 operations over the fp32 peak, or TF32 tensor-core operations over
    their own peak, whichever is largest (the units run side by side)."""
    tb, tf = nbytes / HBM_BPS, max(flops / FP32_FLOPS, tc_flops / TF32_TC_FLOPS)
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def kernel_row(name, source, replaces, err, call, match, plain, nbytes, flops,
               library_ms=None, tc_flops=0.0, **extra) -> dict:
    """Time the kernel and its plain version and make its JSON row."""
    ms, src, _ = device_ms(call, match)
    wall = time_ms(call)
    plain_ms, _, _ = device_ms(plain)
    bound_ms, by = bound(nbytes, flops, tc_flops)
    check(ms >= bound_ms, f"{name}: device time {ms:.5f} ms is not below its "
          f"bound {bound_ms:.5f} ms (a reading below it is a measurement fault)")
    log(f"  {name}: kernel {ms:.4f} ms on the device ({src}; {wall:.4f} ms "
        f"between CUDA events with launch overhead), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({by})")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=library_ms,
                ms_source=src, wall_ms=wall, **extra)


# ---------------------------------------------------------------- phase 3
def exit_kernel_phase(torch, dev, gen) -> list[dict]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.entropy_exit import (
        entropy_exit_argmax_heads_cuda,
        entropy_exit_cuda,
        load_width,
        split_plan,
    )

    widths = set()

    def compare(label, lg, th, argmax=True):
        """Kernel against the plain version: H within 1e-5 (fp32 sums in
        another order than log_softmax), tokens exact with ties to the
        first index, flags exact where |H - thr| >= 1e-5.  Returns (max
        |dH|, the kernel's outputs)."""
        widths.add(load_width(lg))
        if argmax:
            out = entropy_exit_argmax_heads_cuda(lg, th)
            want = ref.entropy_exit_argmax_heads_ref(lg, th)
        else:
            out = entropy_exit_cuda(lg, th)
            want = ref.entropy_exit_ref(lg, th)
        torch.cuda.synchronize()
        h, flag, hr, flr = out[0], out[1], want[0], want[1]
        err = float((h - hr).abs().max())
        thv = torch.as_tensor(th, device=dev).reshape(-1, *[1] * (hr.dim() - 1)).expand_as(hr)
        clear = (hr - thv).abs() >= 1e-5
        check(err <= 1e-5, f"{label} (V={lg.shape[-1]}, {load_width(lg)}-element "
              f"loads): |dH| = {err:.3g} <= 1e-5 (fp32 split sums vs the plain softmax)")
        if argmax:
            check(bool(torch.equal(out[2], want[2])),
                  f"{label}: tokens exact, ties to the first index")
        check(bool(torch.equal(flag[clear], flr[clear])),
              f"{label}: flags exact where |H - thr| >= 1e-5 "
              f"({int((~clear).sum())} rows at the edge)")
        return err, out

    def same(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    k, b, v = 2, 8, 32064
    split, splits = split_plan(v)
    log(f"entropy_exit: each row of V={v} in {splits} splits of {split} "
        "(one cluster of 8 blocks per row; the plan depends on V only)")
    logits = (torch.randn((k, b, v), generator=gen, device=dev) * 4).to(torch.bfloat16)
    logits[0, 0, -64:] = -1e30  # pad lanes inside the width
    logits[1, 1, 100] = logits[1, 1, 30000] = 40.0  # tie across the row
    logits[0, 2, 7] = logits[0, 2, 9] = 40.0  # tie inside one group
    logits[1, 3, split - 1] = logits[1, 3, split] = 40.0  # tie across a split edge
    h_ref0, _, _ = ref.entropy_exit_argmax_heads_ref(logits, 0.5)
    thr = h_ref0.median(dim=1).values.float()  # per-head (K,): mixed flags
    main_cases = (
        ("entropy_exit_argmax_heads", logits, thr,
         "src/repro/kernels/entropy_exit.py:296"),
        ("entropy_exit_argmax", logits[:1], float(thr[0]),
         "src/repro/kernels/entropy_exit.py:191"),
    )
    errs = {}
    for name, lg, th, _ in main_cases:
        log(f"{name}: K={lg.shape[0]} B={b} V={v} bf16")
        errs[name], _ = compare(name, lg, th)
    # Bitwise invariants of the split plan: each head's slice of the K=2
    # launch equals its K=1 launch, and each row of the batch equals the
    # row launched alone.
    whole = entropy_exit_argmax_heads_cuda(logits, thr)
    heads_ok = all(same([o[kk] for o in whole],
                        [o[0] for o in entropy_exit_argmax_heads_cuda(
                            logits[kk:kk + 1], thr[kk:kk + 1])]) for kk in range(k))
    rows_ok = all(same([o[kk, i] for o in whole],
                       [o[0, 0] for o in entropy_exit_argmax_heads_cuda(
                           logits[kk, i:i + 1][None], thr[kk:kk + 1])])
                  for kk in range(k) for i in range(b))
    torch.cuda.synchronize()
    check(heads_ok, "entropy_exit_argmax_heads: each K=2 head slice bitwise equal "
          "to its K=1 launch")
    check(rows_ok, f"entropy_exit_argmax_heads: each of the {k * b} rows bitwise "
          "equal to the row launched alone")
    # The K=1 engine's launch: all three branch heads of Phi-3-mini in one
    # (3, 8, 32064) pile.  The third head draws from its own generator, so
    # every other case keeps its inputs.
    third = (torch.randn((1, b, v), generator=torch.Generator(device=dev).manual_seed(
        SEED + 2), device=dev) * 4).to(torch.bfloat16)
    logits3 = torch.cat([logits, third])
    thr3 = torch.cat([thr, ref.entropy_exit_argmax_heads_ref(third, 0.5)[0].median(
        dim=1).values.float()])
    log(f"entropy_exit_argmax_heads: K=3 B={b} V={v} bf16 (the K=1 engine's launch)")
    err3, whole3 = compare("entropy_exit_argmax_heads K=3", logits3, thr3)
    errs["entropy_exit_argmax_heads"] = max(errs["entropy_exit_argmax_heads"], err3)
    heads3_ok = all(same([o[kk] for o in whole3],
                         [o[0] for o in entropy_exit_argmax_heads_cuda(
                             logits3[kk:kk + 1], thr3[kk:kk + 1])]) for kk in range(3))
    torch.cuda.synchronize()
    check(heads3_ok, "entropy_exit_argmax_heads: each K=3 head slice bitwise equal "
          "to its K=1 launch")
    # Both instantiations the launcher can pick, each against the plain
    # version; the scalar loads do the same arithmetic, so at V=32064 they
    # must give the 16-byte loads' bits.  These cases draw from their own
    # generator, so the later phases see the inputs they always did.
    own = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = max(errs.values())
    for off in (1, 2):
        lg = offset_copy(torch, logits, off)
        label = f"entropy_exit_argmax_heads, logits {2 * off} bytes off 16-byte alignment"
        e, out = compare(label, lg, thr)
        check(load_width(lg) == 1 and same(out, whole),
              f"{label}: scalar loads, bitwise equal to the aligned launch")
        worst = max(worst, e)
    for label, kk, bb, vv, pad in (
        ("V=5003 (odd width)", 1, b, 5003, 0),
        ("V=5002 (even, not a multiple of 8)", 2, b, 5002, 0),
        ("V=8192, last 2048 lanes -1e30 (splits 6 and 7 all pad)", 2, b, 8192, 2048),
        ("V=40 (splits 5..7 empty)", 2, 3, 40, 0),
        # The train_branchy example's serving leg: one branch head of the
        # OLMo-1B smoke config over its 16 rows.
        ("K=1 B=16 V=512 (the train_branchy example's serving leg)", 1, 16, 512, 0),
    ):
        lg = (torch.randn((kk, bb, vv), generator=own, device=dev) * 4).to(torch.bfloat16)
        if pad:
            lg[..., -pad:] = -1e30
        if vv == 40:
            lg[1, 1, 9] = lg[1, 1, 12] = 40.0  # a tie inside one split
        th = ref.entropy_exit_argmax_heads_ref(lg, 0.5)[0].median(dim=1).values.float()
        e, _ = compare(f"entropy_exit_argmax_heads {label}", lg, th)
        worst = max(worst, e)
    check(widths == {1, 8}, f"every load width the launcher picks ran: {sorted(widths)}")
    # The served configs' vocabularies, each from a generator of its own:
    # Qwen3-8B's and Qwen3-30B-A3B's V = 151,936 (18,992 logits per cluster
    # block) at the K=2 decision of the served edge and a K=3 pile (the
    # degraded step's fallback joins the stack; the K=1 engine's three
    # heads); Phi-3-medium's V = 100,352 at K = 2 and 3; InternVL2's
    # V = 128,256 at K = 3 (its K=1 engine: all three heads in one launch);
    # DeepSeek-V3's V = 129,280 at K = 2; Whisper's 51,865 padded to
    # 51,968 (103 pad lanes at -1e30) at K = 3 (its K=1 engine) and K = 2
    # (its K=2 edge).
    wide = {}
    for label, key, vq, ks, seed in (("Qwen3-8B", "qwen3", 151936, (2, 3), SEED + 3),
                                     ("Phi-3-medium", "phi3_medium", 100352, (2, 3),
                                      SEED + 6),
                                     ("InternVL2", "internvl2", 128256, (3,), SEED + 7),
                                     ("DeepSeek-V3", "deepseek_v3", 129280, (2,),
                                      SEED + 8),
                                     ("Whisper", "whisper", 51968, (3, 2), SEED + 14)):
        lq = (torch.randn((3, b, vq), generator=torch.Generator(device=dev).manual_seed(
            seed), device=dev) * 4).to(torch.bfloat16)
        if key == "whisper":
            lq[..., WHISPER_VOCAB:] = -1e30
        thq = ref.entropy_exit_argmax_heads_ref(lq, 0.5)[0].median(dim=1).values.float()
        log(f"entropy_exit: {label} V={vq} in {split_plan(vq)[1]} splits of "
            f"{split_plan(vq)[0]}")
        for kk in ks:
            lg, th = lq[:kk], thq[:kk]
            e, out = compare(f"entropy_exit_argmax_heads {label} K={kk} B={b}", lg, th)
            worst = max(worst, e)
            heads = all(same([o[h] for o in out],
                             [o[0] for o in entropy_exit_argmax_heads_cuda(lg[h:h + 1],
                                                                           th[h:h + 1])])
                        for h in range(kk))
            alone = all(same([o[h, i] for o in out],
                             [o[0, 0] for o in entropy_exit_argmax_heads_cuda(
                                 lg[h, i:i + 1][None], th[h:h + 1])])
                        for h in range(kk) for i in range(b))
            torch.cuda.synchronize()
            check(heads and alone, f"{label} K={kk}: each head slice bitwise equal to "
                  f"its K=1 launch and each of the {kk * b} rows to the row launched alone")
            ms, src, _ = device_ms(
                lambda lg=lg, th=th: entropy_exit_argmax_heads_cuda(lg, th),
                "entropy_exit_argmax_kernel")
            bms, by = bound(lg.numel() * 2 + kk * 4 + kk * b * (4 + 1 + 4), 5 * lg.numel())
            check(ms >= bms, f"{label} K={kk}: device time {ms:.5f} ms not below its "
                  f"bound {bms:.5f} ms")
            log(f"  entropy_exit_argmax_heads {label} K={kk}: {ms:.4f} ms on the device "
                f"({src}), bound {bms:.5f} ms ({by})")
            wide[f"{key}_k{kk}_ms"], wide[f"{key}_k{kk}_bound_ms"] = ms, bms
    errs["entropy_exit_argmax_heads"] = worst
    rows = []
    for name, lg, th, replaces in main_cases:
        n = lg.numel()
        rows.append(kernel_row(
            name, "src/repro_torch/kernels/csrc/entropy_exit.cu", replaces, errs[name],
            lambda lg=lg, th=th: entropy_exit_argmax_heads_cuda(lg, th),
            "entropy_exit_argmax_kernel",
            lambda lg=lg, th=th: ref.entropy_exit_argmax_heads_ref(lg, th),
            nbytes=n * 2 + lg.shape[0] * 4 + lg.shape[0] * b * (4 + 1 + 4),
            flops=5 * n,  # max, sub, exp, add, fma per element
            **(wide if name == "entropy_exit_argmax_heads" else {})))

    # The no-argmax form: Zamba2's width, and Mamba2-130M's padded width
    # whose 152 pad lanes (-1e30) still count in the log-width normalizer.
    worst = 0.0
    for v2, pad in ((32000, 0), (50432, 152)):
        lg = (torch.randn((b, v2), generator=gen, device=dev) * 4).to(torch.bfloat16)
        if pad:
            lg[:, -pad:] = -1e30
        th = float(ref.entropy_exit_ref(lg, 0.5)[0].median())
        log(f"entropy_exit: B={b} V={v2} bf16, {pad} pad lanes")
        e, out = compare(f"entropy_exit V={v2}", lg, th, argmax=False)
        worst = max(worst, e)
    alone = [entropy_exit_cuda(lg[i:i + 1], th) for i in range(b)]
    torch.cuda.synchronize()
    check(all(same([o[i:i + 1] for o in out], a) for i, a in enumerate(alone)),
          f"entropy_exit V={lg.shape[1]}: each row bitwise equal to the row alone")
    rows.append(kernel_row(
        "entropy_exit", "src/repro_torch/kernels/csrc/entropy_exit.cu",
        "src/repro/kernels/entropy_exit.py:90", worst,
        lambda: entropy_exit_cuda(lg, th), "entropy_exit_argmax_kernel",
        lambda: ref.entropy_exit_ref(lg, th),
        nbytes=lg.numel() * 2 + 4 + b * (4 + 1), flops=4 * lg.numel(),
        shape=f"B={b} V={lg.shape[1]}"))
    return rows


def flash_case(torch, dev, gen, b, bc, c, kh, g, d, window, sentinel=True):
    """Inputs: permuted rows with one out-of-bounds sentinel, per-row q_pos,
    k_pos with -1 holes."""
    h = kh * g
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((bc, c, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((bc, c, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    k_pos = torch.arange(c, dtype=torch.int32, device=dev).expand(bc, c).clone()
    holes = torch.rand((bc, c), generator=gen, device=dev) < 0.1
    k_pos[holes] = -1
    q_pos = torch.randint(c // 2, c, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    rows = torch.randperm(bc, generator=gen, device=dev)[:b].to(torch.int32)
    if sentinel:
        rows[-1] = bc
    return q, k, v, k_pos, q_pos, rows


def serving_case(torch, dev, gen, b=SLOTS, c=CONTEXT, kh=32, d=96, g=1):
    """The serving path's attention inputs: each of B rows holds its
    request's positions 0..q_pos in slots 0..q_pos (a 128-token prompt and
    up to 16 decoded tokens, q_pos in 128..143) and -1 beyond; the last
    query row is the compacted runtime's out-of-bounds sentinel.  ``g``
    query heads share each of the ``kh`` KV heads."""
    q = torch.randn((b, kh * g, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, c, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, c, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    q_pos = torch.randint(PROMPT, PROMPT + NEW_TOKENS, (b,), generator=gen,
                          device=dev, dtype=torch.int32)
    rows = torch.randperm(b, generator=gen, device=dev).to(torch.int32)
    slots = torch.arange(c, dtype=torch.int32, device=dev).expand(b, c)
    k_pos = torch.where(slots <= q_pos[rows.argsort()][:, None], slots, -1).contiguous()
    rows[-1] = b
    return q, k, v, k_pos, q_pos, rows


def attn_bytes(q, k_pos, valid, kh, d):
    """Bytes one call must move: q in and out, every k_pos, q_pos and rows,
    and K and V of the valid slots only."""
    b = q.shape[0]
    return 2 * q.numel() * 2 + k_pos[0].numel() * b * 4 + 2 * b * 4 + 2 * valid * kh * d * 2


def attn_cost(q, k, k_pos, q_pos, rows):
    """(bytes, operations) of one call: the valid slots' K and V read once
    per KV head, two products of D per query head and valid slot."""
    valid = valid_slots(k_pos, q_pos, rows)
    kh, d = k.shape[2], q.shape[-1]
    return attn_bytes(q, k_pos, valid, kh, d), 4 * valid * q.shape[1] * d


def valid_slots(k_pos, q_pos, rows):
    """Slots with 0 <= k_pos <= q_pos over the rows the query rows read."""
    kp = k_pos[rows.long().clamp(max=k_pos.shape[0] - 1)]
    return int(((kp >= 0) & (kp <= q_pos[:, None])).sum())


def offset_copy(torch, t, elems: int):
    """A contiguous copy of ``t`` whose storage starts ``elems`` elements
    into a larger buffer: the same values at another address alignment."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


def layout_sweep(torch, dev, gen) -> float:
    """flash_decode at every head layout its wrapper accepts: G in
    {1, 2, 4, 8} and every even D up to 256, on a small cache of two splits
    (the second ragged), half the cases with a window.  Each layout runs
    twice: with 16-byte aligned K/V and k_pos rows (the 16-byte loads where
    D is a multiple of 8), and with K/V 4 bytes off 16-byte alignment and a
    k_pos row length that breaks the int4 load (bf16-pair loads, scalar
    k_pos).  Together they reach every kernel instantiation the launcher
    can pick.  Each output within one bf16 ulp of the fp32 plain version;
    one check per (G, alignment) names the worst D."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_cuda

    worst_all = 0.0
    for g in (1, 2, 4, 8):
        for aligned, c in ((True, 700), (False, 702)):
            worst, worst_d, bad = 0.0, 0, []
            for d in range(2, 257, 2):
                window = 200 if d % 4 == 0 else 0
                q, k, v, k_pos, q_pos, rows = flash_case(torch, dev, gen, 2, 3, c, 2, g, d,
                                                         window)
                if not aligned:
                    k, v = offset_copy(torch, k, 2), offset_copy(torch, v, 2)
                out = flash_decode_cuda(q, k, v, k_pos, q_pos, rows, window=window)
                want = ref.flash_decode_ref(q.float(), k.float(), v.float(), k_pos,
                                            q_pos, rows, window)
                e = (out.float() - want).abs()
                if not bool((e <= BF16_ULP * want.abs() + 1e-5).all()):
                    bad.append(d)
                if float(e.max()) > worst:
                    worst, worst_d = float(e.max()), d
            torch.cuda.synchronize()
            check(not bad, f"flash_decode G={g}, D=2..256 (128 layouts), K/V "
                  f"{'16-byte aligned' if aligned else '4 bytes off 16'}, C={c}: "
                  f"|out - fp32 plain| <= 1 bf16 ulp (max err {worst:.3g} at D={worst_d}; "
                  f"failing D: {bad or 'none'})")
            worst_all = max(worst_all, worst)
    return worst_all


def flash_kernel_phase(torch, dev, gen) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import call_plan, flash_decode_cuda, split_plan

    def compare(label, args, window):
        q, k, v, k_pos, q_pos, rows = args
        out = flash_decode_cuda(q, k, v, k_pos, q_pos, rows, window=window)
        want = ref.flash_decode_ref(q.float(), k.float(), v.float(), k_pos,
                                    q_pos, rows, window)
        torch.cuda.synchronize()
        err = (out.float() - want).abs()
        tol = BF16_ULP * want.abs() + 1e-5
        check(bool((err <= tol).all()),
              f"flash_decode {label}: |out - fp32 plain| <= 1 bf16 ulp "
              f"(max err {float(err.max()):.3g})")
        return float(err.max())

    def sdpa_inputs(q, k, v, k_pos, q_pos, rows):
        """SDPA's operands: the rows gathered (outside the timed call) and
        the validity mask."""
        r = rows.long().clamp(max=k.shape[0] - 1)
        kp = k_pos[r]
        mask = ((kp >= 0) & (kp <= q_pos[:, None].long()))[:, None, None, :]
        return (q[:, :, None, :], k[r].permute(0, 2, 1, 3), v[r].permute(0, 2, 1, 3),
                mask, q.shape[1] != k.shape[2])

    def sdpa(qs, kg, vg, mask, gqa):
        """Library yardstick, never called by the port: SDPA on gathered
        rows with the validity mask (its GQA mode where query heads share
        KV heads)."""
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask, enable_gqa=gqa)

    def sdpa_ms(*args):
        """SDPA's device time on one input set, over and over (its operands
        stay in L2 where they fit)."""
        inputs = sdpa_inputs(*args)
        ms, _, _ = device_ms(lambda: sdpa(*inputs))
        return ms

    split, splits = split_plan(CONTEXT)
    gsplit, gsplits = split_plan(CONTEXT, 8, 128)
    log(f"flash_decode: C split into {splits} splits of {split} slots on the split "
        f"route, {gsplits} of {gsplit} on the grouped route (G in {{4, 8}}, D % 16 == "
        "0, K/V 16-byte aligned); each plan depends on (C, G, D) and alignment only")

    def routed(label, args):
        """Log and return the route and split one call takes."""
        rt, sp, n = call_plan(*args[:3])
        log(f"flash_decode {label}: {rt} route, {n} splits of {sp} slots")
        return rt, sp

    def rows_alone(label, args):
        """Each row of the batch bitwise equal to the same row alone."""
        q, k, v, k_pos, q_pos, rows = args
        whole = flash_decode_cuda(q, k, v, k_pos, q_pos, rows)
        alone = torch.cat([flash_decode_cuda(q[i:i + 1], k, v, k_pos, q_pos[i:i + 1],
                                             rows[i:i + 1]) for i in range(q.shape[0])])
        torch.cuda.synchronize()
        check(bool(torch.equal(whole, alone)), f"flash_decode {label}: every row of the "
              f"batch of {q.shape[0]} bitwise equal to the row alone")
    b, bc, c, kh, d = 8, 8, 4096, 32, 96
    # The serving shape: ~136 valid slots per row, four input sets (1.6 GB
    # of cache, 54 MB of valid K/V) in turn, so each call finds them cold.
    serve_sets = [serving_case(torch, dev, gen) for _ in range(4)]
    sq, sk, sv, skp, sqp, srows = serve_sets[0]
    log(f"flash_decode: serving shape B=Bc={b} C={c} Kh={kh} D={d} bf16, q_pos "
        f"{sqp.tolist()}, one sentinel row")
    err = compare("serving shape", serve_sets[0], 0)
    # Row independence: each row computed in the batch equals the same row
    # computed alone (B = 1, the same rows entry), bit for bit.
    whole = flash_decode_cuda(sq, sk, sv, skp, sqp, srows)
    alone = torch.cat([flash_decode_cuda(sq[i:i + 1], sk, sv, skp, sqp[i:i + 1],
                                         srows[i:i + 1]) for i in range(b)])
    torch.cuda.synchronize()
    check(bool(torch.equal(whole, alone)),
          "flash_decode: every row of the batch of 8 bitwise equal to the row alone")
    main = flash_case(torch, dev, gen, b, bc, c, kh, 1, d, 0)
    log(f"flash_decode: phase shape B={b} Bc={bc} C={c} Kh={kh} D={d} "
        "bf16, q_pos in [C/2, C), 10% holes, one sentinel row")
    err = max(err, compare("phase shape (D=96)", main, 0))
    small = flash_case(torch, dev, gen, 4, 6, 1000, 8, 2, 128, 300)
    err = max(err, compare("G=2, window=300, C=1000", small, 300))
    z = flash_case(torch, dev, gen, b, bc, c, 32, 1, 64, 0)
    err = max(err, compare("Zamba2 shared block (D=64, Kh=32, G=1)", z, 0))
    # A fully masked row (every k_pos past its q_pos): the uniform average.
    fm = list(serving_case(torch, dev, gen))
    fm[3] = fm[3].clone()
    fm[3][fm[5][2].clamp(max=bc - 1)] = -1
    err = max(err, compare("one fully masked row", fm, 0))
    # A wrapped ring: q_pos >= C, slot s holds the newest position = s mod C.
    wq = torch.randint(c + 100, 3 * c, (b,), generator=gen, device=dev, dtype=torch.int32)
    wrows = torch.randperm(bc, generator=gen, device=dev).to(torch.int32)
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    qw = wq[wrows.argsort()][:, None]
    wkp = (qw - ((qw - slot) % c)).contiguous()
    wrap = (sq, sk, sv, wkp, wq, wrows)
    err = max(err, compare("wrapped ring (q_pos >= C)", wrap, 0))
    err = max(err, compare("wrapped ring, window=1000", wrap, 1000))
    # B = 1 over a full cache: Kh * S blocks fill the card.
    one = (sq[:1], sk, sv, torch.arange(c, dtype=torch.int32, device=dev).expand(bc, c)
           .contiguous(), torch.tensor([c - 1], dtype=torch.int32, device=dev),
           torch.tensor([3], dtype=torch.int32, device=dev))
    err = max(err, compare("B=1, all 4096 slots valid", one, 0))
    # The train_branchy example's decode: the OLMo-1B smoke config's Kh = 4
    # heads of D = 64 over a 96-slot ring, 16 rows, from a generator of its
    # own so that the cases below keep their inputs.
    tb = flash_case(torch, dev, torch.Generator(device=dev).manual_seed(SEED + 5),
                    16, 16, 96, 4, 1, 64, 0)
    err = max(err, compare("train_branchy decode (B=16, Kh=4, G=1, D=64, C=96)", tb, 0))
    err = max(err, layout_sweep(torch, dev, gen))

    # The served layouts, ~136 valid slots of 4096 a row, each from a
    # generator of its own, four input sets in turn: at D = 128 Qwen3-8B
    # (Kh = 8 KV heads, G = 4 query heads on each), Phi-3-medium (Kh = 10,
    # G = 4), Qwen3-30B-A3B (Kh = 4, G = 8) and InternVL2 (Kh = 8, G = 8);
    # Whisper's decoder at Kh = 16, G = 1, D = 64.
    layouts = {}
    for label, key, lkh, lg_, ld, seed in (
            ("Qwen3-8B", "qwen3", 8, 4, 128, SEED + 4),
            ("Phi-3-medium", "phi3_medium", 10, 4, 128, SEED + 9),
            ("Qwen3-30B-A3B", "qwen3_moe", 4, 8, 128, SEED + 10),
            ("InternVL2", "internvl2", 8, 8, 128, SEED + 11),
            ("Whisper", "whisper", 16, 1, 64, SEED + 15)):
        lgen = torch.Generator(device=dev).manual_seed(seed)
        sets = [serving_case(torch, dev, lgen, kh=lkh, d=ld, g=lg_) for _ in range(4)]
        qq, qk, qv, qkp, qqp, qrows = sets[0]
        log(f"flash_decode: {label} serving layout B=Bc={b} C={c} Kh={lkh} G={lg_} "
            f"D={ld} bf16, q_pos {qqp.tolist()}, one sentinel row")
        err = max(err, compare(f"{label} serving layout (Kh={lkh}, G={lg_}, D={ld})",
                               sets[0], 0))
        rows_alone(f"{label} layout", sets[0])
        layouts[key] = (label, sets, routed(f"{label} layout", sets[0]))

    # Two grouped cases with many valid slots, each from a generator of its
    # own: "G=8 full cache", B = 1 over all 4096 slots at Qwen3-30B-A3B's
    # Kh = 4, G = 8 (eight one-row caches in turn, 67 MB, so each call finds
    # its 8.4 MB cold), and "G=4 wide", the phase shape's q_pos in [C/2, C)
    # with 10% holes at Kh = 8, G = 4 (two input sets in turn).
    fgen = torch.Generator(device=dev).manual_seed(SEED + 12)
    full_sets = []
    for _ in range(8):
        fq, fk, fv, _, _, _ = flash_case(torch, dev, fgen, 1, 1, c, 4, 8, 128, 0,
                                         sentinel=False)
        full_sets.append((fq, fk, fv, torch.arange(c, dtype=torch.int32, device=dev)
                          .expand(1, c).contiguous(),
                          torch.tensor([c - 1], dtype=torch.int32, device=dev),
                          torch.zeros(1, dtype=torch.int32, device=dev)))
    err = max(err, compare("G=8 full cache (B=1, Kh=4, G=8, D=128, all 4096 slots valid)",
                           full_sets[0], 0))
    # Row independence at this layout: four rows over one shared 4-row cache.
    fq, fk, fv, _, _, _ = flash_case(torch, dev, fgen, 4, 4, c, 4, 8, 128, 0,
                                     sentinel=False)
    rows_alone("G=8 full cache layout", (
        fq, fk, fv, torch.arange(c, dtype=torch.int32, device=dev).expand(4, c).contiguous(),
        torch.tensor([c - 1, c - 2, c // 2, 1000], dtype=torch.int32, device=dev),
        torch.arange(4, dtype=torch.int32, device=dev)))
    wgen = torch.Generator(device=dev).manual_seed(SEED + 13)
    wide_sets = [flash_case(torch, dev, wgen, b, bc, c, 8, 4, 128, 0) for _ in range(2)]
    err = max(err, compare("G=4 wide (B=8, Kh=8, G=4, D=128, q_pos in [C/2, C), 10% holes)",
                           wide_sets[0], 0))
    rows_alone("G=4 wide", wide_sets[0])
    layouts["g8_full"] = ("G=8 full cache", full_sets, routed("G=8 full cache", full_sets[0]))
    layouts["g4_wide"] = ("G=4 wide", wide_sets, routed("G=4 wide", wide_sets[0]))

    def timed(args_sets, label):
        ms, _, _ = device_ms(rotating(flash_decode_cuda, args_sets), "flash_decode")
        q, k, v, k_pos, q_pos, rows = args_sets[0]
        nbytes, flops = attn_cost(q, k, k_pos, q_pos, rows)
        bms, _ = bound(nbytes, flops)
        log(f"  flash_decode {label}: {ms:.4f} ms on the device, bound {bms:.5f} ms "
            f"over {valid_slots(k_pos, q_pos, rows)} valid slots")
        return ms, bms

    phase_ms, phase_bound = timed([main], "phase shape")
    d64_ms, _ = timed([z], "D=64 (Zamba2)")
    b1_ms, b1_bound = timed([one], "B=1 full cache")
    per_layout = {}
    for key, (label, sets, (rt, sp)) in layouts.items():
        lms, lbound = timed(sets, f"{label} ({rt} route)")
        q, k, v, k_pos, q_pos, rows = sets[0]
        per_layout.update({f"{key}_ms": lms, f"{key}_bound_ms": lbound,
                           f"{key}_valid_slots": valid_slots(k_pos, q_pos, rows),
                           f"{key}_route": rt, f"{key}_split": sp})
    valid = valid_slots(skp, sqp, srows)
    row = kernel_row(
        "flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:99", err,
        rotating(flash_decode_cuda, serve_sets), "flash_decode",
        lambda: ref.flash_decode_ref(sq, sk, sv, skp, sqp, srows),
        nbytes=attn_bytes(sq, skp, valid, kh, d), flops=4 * valid * kh * d,
        shape=f"serving: B=Bc={b} C={c} Kh={kh} D={d}, {valid} valid slots",
        phase_shape_ms=phase_ms, phase_shape_bound_ms=phase_bound, d64_ms=d64_ms,
        b1_full_ms=b1_ms, b1_full_bound_ms=b1_bound,
        kernel_route=routed("serving shape", serve_sets[0])[0], split=split,
        **per_layout)
    # The library yardsticks, after every kernel time: SDPA on one input
    # set (in L2 where it fits) and, at the GQA layouts, like for like on
    # the kernel's own input sets in turn.
    row["library_ms"] = sdpa_ms(*serve_sets[0])
    row["phase_shape_library_ms"] = sdpa_ms(*main)
    row["b1_full_library_ms"] = sdpa_ms(*one)
    log(f"  SDPA on gathered rows: {row['library_ms']:.4f} ms at the serving shape, "
        f"{row['phase_shape_library_ms']:.4f} ms at the phase shape, "
        f"{row['b1_full_library_ms']:.4f} ms at B=1 over the full cache")
    for key, (label, sets, _) in layouts.items():
        lib_ms = sdpa_ms(*sets[0])
        lib_cold, _, _ = device_ms(rotating(sdpa, [sdpa_inputs(*a) for a in sets]))
        row.update({f"{key}_library_ms": lib_ms, f"{key}_library_cold_ms": lib_cold})
        log(f"  SDPA (GQA) on gathered rows at the {label} layout: {lib_ms:.4f} ms on "
            f"one input set, {lib_cold:.4f} ms on the kernel's {len(sets)} in turn "
            f"(kernel {row[f'{key}_ms'] / lib_cold:.2f}x of that)")
    return [row]


def ssd_inputs(torch, dev, gen, b, l, h, p, n, g, dtype=None, pad=0):
    """Inputs as the model hands them over: dt-scaled fp32 x (B, L, H, P),
    fp32 log decays a = dt * A (B, L, H), and B, C (B, L, G, N) as bf16
    (or ``dtype``) slices of one wider xBC activation (a token stride, not
    contiguous); ``pad`` extra elements per token change that stride."""
    inner = h * p
    xbc = (torch.randn((b, l, inner + 2 * g * n + pad), generator=gen, device=dev)
           * 0.5).to(dtype or torch.bfloat16)
    bm = xbc[..., inner:inner + g * n].reshape(b, l, g, n)
    cm = xbc[..., inner + g * n:inner + 2 * g * n].reshape(b, l, g, n)
    dt = torch.rand((b, l, h), generator=gen, device=dev) * 0.1 + 1e-3
    a_log = torch.rand((h,), generator=gen, device=dev) * math.log(16.0)
    x = torch.randn((b, l, h, p), generator=gen, device=dev) * dt[..., None]
    return x, -dt * torch.exp(a_log), bm, cm


def ssd_update_phase(torch, dev, gen) -> list[dict]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_update_cuda

    worst = 0.0
    for label, bc, b, h, n, g, compact in (
        ("Zamba2-1.2B, full batch", 8, 8, 64, 64, 1, False),
        ("Zamba2-1.2B, compacted 5 of 8", 8, 5, 64, 64, 1, True),
        ("Mamba2-130M, compacted 5 of 8", 8, 5, 24, 128, 1, True),
        ("G=2, compacted 5 of 8", 8, 5, 64, 64, 2, True),
    ):
        p = 64
        state = torch.randn((bc, h, p, n), generator=gen, device=dev)
        x, a, bm, cm = ssd_inputs(torch, dev, gen, b, 1, h, p, n, g)
        x, a, bm, cm = x[:, 0], a[:, 0], bm[:, 0], cm[:, 0]
        rows = None
        if compact:
            rows = torch.randperm(bc, generator=gen, device=dev)[:b].to(torch.int32)
            rows[-1] = bc  # the compacted runtime's out-of-bounds sentinel
        got, want = state.clone(), state.clone()
        y = ssd_update_cuda(got, x, a, bm, cm, rows)
        yr = ref.ssd_update_ref(want, x, a, bm, cm, rows)
        torch.cuda.synchronize()
        named = torch.arange(b, device=dev) if rows is None else rows.long()
        live = named < bc
        untouched = torch.ones(bc, dtype=torch.bool, device=dev)
        untouched[named[live]] = False
        dy = float((y - yr)[live].abs().max())
        dh = float((got - want).abs().max())
        worst = max(worst, dy, dh)
        log(f"ssd_update: {label}: Bc={bc} B={b} H={h} P={p} N={n} G={g}")
        # fp32 on both sides; the kernel fuses multiply-adds and sums y's N
        # products in another order: a few fp32 ulps at the values' scale.
        check(dh <= 1e-6 * float(want.abs().max()),
              f"ssd_update {label}: state |dh| {dh:.3g} <= 1e-6 max|h|")
        check(dy <= 1e-5 * float(yr.abs().max()),
              f"ssd_update {label}: |dy| {dy:.3g} <= 1e-5 max|y| on live rows")
        check(bool(torch.equal(got[untouched], state[untouched])),
              f"ssd_update {label}: {int(untouched.sum())} rows not named "
              "bitwise untouched")
    # Time at Zamba2-1.2B's decode shape: every row of the batch, eight
    # resident states (67 MB) in turn.
    bc = b = 8
    h, p, n, g = 64, 64, 64, 1
    x, a, bm, cm = (t[:, 0] for t in ssd_inputs(torch, dev, gen, b, 1, h, p, n, g))
    sets = [(torch.randn((bc, h, p, n), generator=gen, device=dev), x, a, bm, cm)
            for _ in range(8)]
    return [kernel_row(
        "ssd_update", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:166", worst,
        rotating(ssd_update_cuda, sets), "ssd_update_kernel",
        rotating(ref.ssd_update_ref, sets),
        nbytes=2 * bc * h * p * n * 4 + 2 * b * h * p * 4 + b * h * 4
        + 2 * b * g * n * 2 + b * 4,
        flops=5 * b * h * p * n, shape=f"Bc=B={b} H={h} P={p} N={n} G={g}")]


def ssd_scan_phase(torch, dev, gen) -> list[dict]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models.mamba import ssd_chunked

    worst = 0.0
    # The main paths' layouts (bf16 B, C at a 16-byte token stride), then
    # the kernel's other staging and precision paths: fp32 B, C (3xTF32 in
    # every product) and token strides that are not a multiple of 16 bytes
    # (element-wise staging instead of cp.async), at the same bounds.
    f32 = torch.float32
    for label, b, l, h, n, g, dtype, pad in (
        ("Zamba2-1.2B admission", 8, 128, 64, 64, 1, None, 0),
        ("ragged L=100", 8, 100, 64, 64, 1, None, 0),
        ("Mamba2-130M", 8, 128, 24, 128, 1, None, 0),
        ("G=2", 4, 128, 64, 64, 2, None, 0),
        ("fp32 B, C", 8, 128, 64, 64, 1, f32, 0),
        ("fp32 B, C, N=128", 8, 128, 24, 128, 1, f32, 0),
        ("bf16 B, C, token stride 2 bytes off 16, ragged L=100", 8, 100, 64, 64, 1,
         None, 1),
        ("fp32 B, C, token stride 4 bytes off 16, N=128, G=2", 4, 128, 24, 128, 2,
         f32, 1),
    ):
        p, chunk = 64, 64
        x, a, bm, cm = ssd_inputs(torch, dev, gen, b, l, h, p, n, g, dtype, pad)
        y, hf = ssd_scan_cuda(x, a, bm, cm, chunk=chunk)
        yr, hr = ref.ssd_scan_ref(x, a, bm, cm)
        yc, hc = ssd_chunked(x, a, bm, cm, chunk)
        torch.cuda.synchronize()
        log(f"ssd_scan: {label}: B={b} L={l} H={h} P={p} N={n} G={g} chunk={chunk} "
            f"{str(bm.dtype)[6:]} B/C, token stride {bm.stride(1)}")
        ys, hs = float(yr.abs().max()), float(hr.abs().max())
        dy, dh = float((y - yr).abs().max()), float((hf - hr).abs().max())
        worst = max(worst, dy, dh)
        # The same sequential recurrence in fp32: rounding (fused
        # multiply-adds, y's sum order) stays within 1e-5 of the scale.
        check(dy <= 1e-5 * ys and dh <= 1e-5 * hs,
              f"ssd_scan {label} vs ssd_scan_ref: |dy| {dy:.3g}, |dh| {dh:.3g} "
              f"<= 1e-5 of max|y| {ys:.3g}, max|h| {hs:.3g}")
        # The chunked form sums exp(cumsum) decays in (chunk x chunk) blocks.
        dyc, dhc = float((y - yc).abs().max()), float((hf - hc).abs().max())
        check(dyc <= 1e-4 * ys and dhc <= 1e-4 * hs,
              f"ssd_scan {label} vs ssd_chunked: |dy| {dyc:.3g}, |dh| {dhc:.3g} "
              "<= 1e-4 of max|y|, max|h|")
    # A layout whose block outgrows the SM's shared memory raises.
    try:
        ssd_scan_cuda(*ssd_inputs(torch, dev, gen, 1, 64, 1, 256, 128, 1, f32))
    except RuntimeError as e:
        check("cudaError 1" in str(e), "ssd_scan P=256, N=128, fp32 B/C (over 227 KB "
              "of shared memory) raises")
    else:
        check(False, "ssd_scan P=256, N=128, fp32 B/C raises")
    # Time at Zamba2-1.2B's admission shape, four input sets (90 MB) in turn.
    b, l, h, p, n, g, chunk = 8, 128, 64, 64, 64, 1, 64
    sets = [ssd_inputs(torch, dev, gen, b, l, h, p, n, g) for _ in range(4)]
    chunked_ms, _, _ = device_ms(rotating(
        lambda *t: ssd_chunked(*t, chunk), sets))
    log(f"  ssd_chunked (the model's plain prefill scan) {chunked_ms:.4f} ms")
    # Mamba2-130M's admission shape.
    msets = [ssd_inputs(torch, dev, gen, 8, l, 24, p, 128, 1) for _ in range(4)]
    m_ms, _, _ = device_ms(rotating(lambda *t: ssd_scan_cuda(*t, chunk=chunk), msets),
                        "ssd_scan_kernel")
    m_bound, m_by = bound(scan_bytes(8, l, 24, p, 128, 1), 0,
                          scan_tc_flops(8, l, 24, p, 128, chunk))
    log(f"  ssd_scan at Mamba2-130M's shape (H=24, N=128): {m_ms:.4f} ms on the "
        f"device, bound {m_bound:.5f} ms ({m_by})")
    return [kernel_row(
        "ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:98", worst,
        rotating(lambda *t: ssd_scan_cuda(*t, chunk=chunk), sets), "ssd_scan_kernel",
        rotating(ref.ssd_scan_ref, sets),
        nbytes=scan_bytes(b, l, h, p, n, g), flops=0,
        tc_flops=scan_tc_flops(b, l, h, p, n, chunk), chunked_ms=chunked_ms,
        mamba2_130m_ms=m_ms, mamba2_130m_bound_ms=m_bound,
        shape=f"B={b} L={l} H={h} P={p} N={n} G={g} chunk={chunk}")]


def scan_bytes(b, l, h, p, n, g):
    """x in and y out (fp32), a, bf16 B and C, the final state out."""
    return 2 * b * l * h * p * 4 + b * l * h * 4 + 2 * b * l * g * n * 2 + b * h * p * n * 4


def scan_tc_flops(b, l, h, p, n, chunk):
    """TF32 tensor-core operations of the chunked form with bf16 B and C:
    per chunk and head C B^T once (exact operands), (S o decay) X in
    3xTF32, the state update (decay on X) in two products, C h_prev^T in
    two (none before the first chunk, where h_prev = 0)."""
    nc = -(-l // chunk)
    mm = 2 * chunk * chunk
    per_head = nc * (mm * n * 1 + mm * p * 3 + 2 * chunk * p * n * 2) \
        + (nc - 1) * 2 * chunk * n * p * 2
    return b * h * per_head


# ---------------------------------------------------------------- phase 4
def prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
            for _ in range(N_REQ)]


def first_step(torch, srv, sync_check: bool = False):
    """Admit the prompts into fresh caches and decode one step; with
    ``sync_check`` also run two compacted dispatches, the first capturing
    its key and the second replaying, each under
    ``set_sync_debug_mode("error")`` and :func:`sync_calls`: neither may
    wait for the card."""
    from repro_torch.serving import RequestScheduler

    sched = RequestScheduler(srv, SLOTS, CONTEXT)
    for p in prompts(srv.cfg):
        sched.submit(p, NEW_TOKENS)
    sched._admit()  # the step below then only decodes
    tok0 = sched.tok_dev[:, 0].cpu().numpy()
    rep = sched.step()
    res = rep.server_report.tier_result
    out = dict(tok0=tok0, tokens=res.tokens.copy(), exited=res.exited.copy(),
               ents={l: e.copy() for l, e in res.branch_entropy.items()},
               takes={l: t.copy() for l, t in res.branch_take.items()},
               logits=res.last_logits.float().clone())
    if sync_check:
        ex = srv.executor

        def dispatch():
            pos_t = ex._upload(sched.pos.copy(), torch.int32)
            exited0 = ex._upload(~sched.active, torch.bool)
            ex.dispatch(sched.tok_dev, pos_t, sched.caches, {1: SLOTS // 2}, exited0)

        def debugged():
            """dispatch() through :func:`sync_calls`; returns the keys it
            captured, the graphs it replayed, and its synchronizing CUDA
            calls."""
            counts, replays = dict(ex.trace_counts), sum(ex.replays.values())
            syncs = sync_calls(torch, dispatch)
            new = [k for k, n in ex.trace_counts.items() if n != counts.get(k, 0)]
            return new, sum(ex.replays.values()) - replays, syncs

        n_seg = sum(not seg.is_empty for seg in ex.segments)
        # The compacted key's first use: the eager step and its capture.
        new, replays, syncs = debugged()
        check(len(new) == 1 and new[0][1] == SLOTS // 2 and replays == n_seg - 1
              and not syncs,
              f"a compacted step's first dispatch captured its bucket-{SLOTS // 2} "
              f"key {new} and replayed the other {replays} segment graph(s) under "
              f"set_sync_debug_mode('error') with no synchronizing CUDA call "
              f"{syncs}: the capture makes no host sync")
        new, replays, syncs = debugged()
        check(new == [] and replays == n_seg and not syncs,
              f"the next compacted dispatch replayed its {n_seg} segment graphs "
              f"under set_sync_debug_mode('error') with no synchronizing CUDA "
              f"call {syncs}: no sync, no capture")
    del sched
    torch.cuda.empty_cache()
    return out


def serve(torch, srv, n_tokens: int, label: str, trace: list | None = None,
          pin_at: int | None = None) -> dict:
    """Submit the requests and run them through ``run``; launch counts
    are reset just before and read just after.  With ``trace``, each
    decode step appends (server report, host seconds, host syncs, overflow
    re-runs) to it.  ``pin_at``: the bucket hints are pinned to 1 before
    that step (a forced overflow re-run when more rows survive).  Under
    graphs, no key may be captured twice in the run."""
    from repro_torch.kernels import ops

    ex, sched = srv.executor, srv.scheduler
    syncs0, retries0, steps0 = ex.host_syncs, ex.overflow_retries, sched.decode_steps
    counts0, replays0 = dict(ex.trace_counts), sum(ex.replays.values())
    rids = [srv.submit(p, n_tokens) for p in prompts(srv.cfg)]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    step_s, reports = [], []
    while sched.queue or sched.active.any():
        if pin_at == len(step_s):
            ex._hints = {i: 1 for i, seg in enumerate(ex.segments)
                         if i and not seg.is_empty}
        ts = time.perf_counter()
        syncs_s, retries_s = ex.host_syncs, ex.overflow_retries
        new = srv.run(max_steps=1)
        step_s.append(time.perf_counter() - ts)
        reports += new
        if trace is not None and new:
            trace.append((new[0].server_report, step_s[-1], ex.host_syncs - syncs_s,
                          ex.overflow_retries - retries_s))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    results = [sched.results[r] for r in rids]
    syncs, retries = ex.host_syncs - syncs0, ex.overflow_retries - retries0
    steps = sched.decode_steps - steps0
    check(all(r.done and len(r.tokens) == n_tokens for r in results),
          f"{label}: all {N_REQ} requests got {n_tokens} tokens")
    check(all(0 <= t < srv.cfg.vocab_size for r in results for t in r.tokens),
          f"{label}: every token inside the vocabulary")
    check(syncs == steps + retries,
          f"{label}: host syncs {syncs} == decode steps {steps} + overflow "
          f"retries {retries}")
    # A degraded step runs no head tier: the last step that did.
    last = next(r.server_report.tier_result.last_logits for r in reversed(reports)
                if r.server_report.tier_result.last_logits is not None)
    check(bool(torch.isfinite(last).all()) and tuple(last.shape) ==
          (SLOTS, srv.cfg.padded_vocab_size), f"{label}: final logits finite, (8, V)")
    exits = sum(sum(r.exited) for r in results)
    buckets = sorted({c.bucket for rep in reports
                      for c in rep.server_report.compaction})
    decode_ms = statistics.median(s * 1e3 for s in step_s[1:])
    ttft = statistics.median(r.ttft_s for r in results)
    captured = {k: n - counts0.get(k, 0) for k, n in ex.trace_counts.items()
                if n != counts0.get(k, 0)}
    if ex.graphs:
        check(all(n == 1 for n in captured.values()),
              f"{label}: no key captured twice in the run ({len(captured)} captured)")
    out = dict(label=label, graphs=ex.graphs, launches=launches, decode_steps=steps,
               exits=int(exits), tokens=N_REQ * n_tokens, wall_s=wall,
               ttft_s=ttft, decode_step_ms=decode_ms,
               tokens_per_s=N_REQ * n_tokens / wall, cloud_buckets=buckets,
               overflow_retries=retries, captured=len(captured),
               captured_keys=sorted(captured, key=repr),
               replays=sum(ex.replays.values()) - replays0)
    log(f"  {label}: {json.dumps(out)}")
    return out


def same_runs(torch, trace_g: list, trace_e: list, label: str, sim: bool = False,
              what: str = "graphed run == eager twin") -> None:
    """A graphed run against its ``graphs=False`` twin (same weights,
    prompts, budgets and fresh hints), or two other runs that must agree
    (``what``): every step's tokens, exit masks, per-branch takes and
    entropies, main-head logits, bytes per hop, degraded and failed rows,
    fault events, buckets and overflow re-runs bitwise equal, and with
    ``sim`` the simulated transfer seconds.  The first difference is
    named."""
    import numpy as np

    first = None
    for i, ((rg, _, _, og), (re_, _, _, oe)) in enumerate(zip(trace_g, trace_e)):
        a, b = rg.tier_result, re_.tier_result
        fields = [("tokens", a.tokens, b.tokens), ("exited", a.exited, b.exited),
                  ("exit tiers", a.exit_tier, b.exit_tier)]
        for layer in a.branch_take:
            fields += [(f"branch {layer} take", a.branch_take[layer],
                        b.branch_take.get(layer)),
                       (f"branch {layer} entropy", a.branch_entropy[layer],
                        b.branch_entropy.get(layer))]
        diff = [n for n, x, y in fields if y is None or not np.array_equal(x, y)]
        for name in ("degraded", "failed"):
            x, y = getattr(a, name), getattr(b, name)
            if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
                diff.append(f"{name} rows")
        la, lb = a.last_logits, b.last_logits
        if (la is None) != (lb is None) or (la is not None and not torch.equal(la, lb)):
            diff.append("main-head logits")
        if a.bytes_per_hop != b.bytes_per_hop or a.fault_events != b.fault_events:
            diff.append("bytes per hop or fault events")
        if sim and a.sim_transfer_s != b.sim_transfer_s:
            diff.append("simulated transfer seconds")
        if (og, [c.bucket for c in a.compaction]) != (oe, [c.bucket for c in b.compaction]):
            diff.append("buckets or overflow re-runs")
        if diff and first is None:
            first = (i, diff)
    check(len(trace_g) == len(trace_e) and first is None,
          f"{label}: {what} bitwise on all {len(trace_g)} steps (tokens, exit masks, "
          f"takes, entropies, logits, bytes, fault rows and events, buckets, re-runs"
          + (", sim seconds)" if sim else ")")
          + ("" if first is None else f"; first difference at step {first[0]}: {first[1]}"))


def swap_phase(torch, srv, other: int) -> list[dict]:
    """``set_split`` to ``other``, back, and again (A -> B -> A -> B -> A),
    4 tokens of the same requests at each: once both plans have served,
    the swaps capture nothing, every step replays cached graphs."""
    home = srv.split_layer
    runs = []
    for leg, split in enumerate((other, home, other, home)):
        srv.set_split(split)
        run = serve(torch, srv, 4, f"{srv.cfg.name} swap leg {leg + 1}: split {split}")
        if leg >= 2:
            check(run["captured"] == 0 and run["replays"] > 0,
                  f"swap back to split {split}: nothing captured, {run['replays']} "
                  f"graph replays")
        runs.append(run)
    return runs


#: The device kernels each wrapper's launch runs (flash_decode: its split
#: and merge kernels; the three exit wrappers share one kernel).
LAUNCH_EVENTS = {
    # flash_decode's two routes: (split, merge) or (grouped, grouped merge)
    "flash_decode": (("flash_decode_split_kernel", "flash_decode_gqa_kernel"),
                     ("flash_decode_merge_kernel", "flash_decode_gqa_merge_kernel")),
    "ssd_update": ("ssd_update_kernel",),
    "ssd_scan": ("ssd_scan_kernel",),
    ("entropy_exit_argmax_heads", "entropy_exit_argmax", "entropy_exit"):
        ("entropy_exit_argmax_kernel",),
}


def profile_decode(torch, srv, label: str, steps: int = 3) -> dict:
    """Device busy share and the largest device consumers over ``steps``
    steady decode steps (after admission and one warm step) of requests
    served through ``srv``'s scheduler (:func:`profile_window`)."""
    def warm():
        for p in prompts(srv.cfg):
            srv.submit(p, steps + 3)
        srv.run(max_steps=2)

    return profile_window(torch, srv.executor, label, warm,
                          lambda: srv.run(max_steps=steps), srv.run, steps)


def profile_window(torch, ex, label: str, warm, go, drain, steps: int) -> dict:
    """Device busy share and the largest device consumers over the
    ``steps`` decode steps ``go()`` runs on executor ``ex``, after
    ``warm()``.  The window's device events of each kernel are checked
    equal to the launches the wrappers counted in it: under graphs those
    are the launches each replayed capture recorded, so a graph that lost a
    kernel fails here.  torch.profiler now and then drops an event from a
    window (as :func:`device_ms` finds); such a window is logged and
    another (``drain()``, then ``warm()`` again) is profiled, up to three in
    all: a kernel a graph lost is missing from every window.  ``drain()``
    ends the run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    windows = 3
    for window in range(1, windows + 1):
        warm()
        torch.cuda.synchronize()
        before, replays = dict(ops.launches), sum(ex.replays.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict[str, float] = {}
        n_events: dict[str, int] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
                n_events[e.name] = n_events.get(e.name, 0) + 1
        counted = {}
        for names, kernels in LAUNCH_EVENTS.items():
            names = (names,) if isinstance(names, str) else names
            n = sum(ops.launches[k] - before[k] for k in names)
            got = [sum(c for nm, c in n_events.items()
                       if any(k in nm for k in ((kern,) if isinstance(kern, str) else kern)))
                   for kern in kernels]
            counted[names[0]] = (n, got)
        replays = sum(ex.replays.values()) - replays
        whole = all(g == n for n, got in counted.values() for g in got)
        if whole or window == windows or not all(
                g <= n for n, got in counted.values() for g in got):
            break
        drain()
        log(f"  {label}: profiler window {window} lost device events {counted} "
            f"(launches, [events]); profiling another window")
    check(whole,
          f"{label}: over {steps} profiled decode steps ({replays} graph replays) "
          f"each kernel's device events equal the launches counted "
          f"{ {k: v for k, v in counted.items() if v[0]} } (launches, [events "
          f"per kernel it runs]; window {window} of at most {windows})")
    drain()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # Where the host's own time goes: operators by self CPU time.
    host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda kv: -kv[1])[:8]
    out = dict(steps=steps, replayed=replays, wall_ms_per_step=wall_us / steps / 1e3,
               device_ms_per_step=busy / steps / 1e3,
               device_idle_share=1.0 - busy / wall_us if wall_us else None,
               top_device_ms_per_step=[(n[:80], t / steps / 1e3) for n, t in top],
               top_host_self_ms_per_step=[(n[:80], t / steps / 1e3) for n, t in host])
    log(f"  profiled decode: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 5
#: Cost-profile inputs of the deployment story in examples/serve_partitioned.py:
#: an edge 25x slower than the profiled card, a 32 KiB raw input.
GAMMA, RAW_INPUT_BYTES = 25.0, 32 * 1024.0
PRESETS = ("3g", "4g", "wifi")
#: examples/serve_partitioned.py's K=3 fleet: device -> wifi -> edge -> 3g ->
#: cloud; the phase also solves it with the edge's backhaul at the example's
#: "degraded-3g" 0.4 Mb/s.
K3_TIERS = (("device", 60.0, 18.8e6), ("edge", 12.0, 1.10e6), ("cloud", 1.0))


def counted(torch, label: str, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after; returns (its result, {"label", "launches"})."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(label=label, launches=dict(ops.launches))


def layer_floor(cfg, wparams, i: int, pos: int) -> float:
    """The least seconds layer ``i`` (0-based) of a profiled decode step
    could take on the card (H100_SXM roofline): its weights read once, the
    K/V of the ``pos + 1`` valid slots of each attention it runs (its own,
    and the shared block at a hybrid site), a Mamba2 layer's SSM state read
    and written, a Whisper decoder layer's cross K/V over every encoder
    frame (its cross-attention's K and V projections are not read: the
    admission computed the cross K/V); 2 B operations per weight in
    bf16."""
    from repro_torch.core import H100_SXM
    from repro_torch.models.mamba import _dims
    from repro_torch.models.model import hybrid_sites, trunk_layout

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    (name, kind, _), = trunk_layout(cfg)
    stack = wparams[name]
    if kind.cross_attention:
        stack = dict(stack, xattn={k: stack["xattn"][k] for k in ("wq", "wo")})
    layer = [t[i] for t in leaves(stack)]
    kv = 2 * SLOTS * (pos + 1) * cfg.num_kv_heads * cfg.head_dim * 2
    if kind.mixer == "gqa":
        state = kv
    else:
        _, h, p, n, _, _ = _dims(cfg)
        state = 2 * SLOTS * h * p * n * 4
    if kind.cross_attention:
        state += 2 * SLOTS * cfg.encoder_seq_len * cfg.num_kv_heads * cfg.head_dim * 2
    if i + 1 in hybrid_sites(cfg):
        layer += list(leaves(wparams["shared_attn"]))
        state += kv
    weights = sum(t.numel() for t in layer)
    nbytes = sum(t.numel() * t.element_size() for t in layer) + state
    return H100_SXM.roofline_time(2 * SLOTS * weights, nbytes)


#: Kernel -> the name its device events carry (flash_decode: split and merge).
KERNEL_EVENTS = {"flash_decode": "flash_decode", "ssd_update": "ssd_update_kernel"}


def profile_phase(torch, cfg, wparams, name: str) -> tuple[list, list, dict]:
    """Measure-mode and analyze-mode profiles of every trunk layer at the
    serving shape (8 slots x 4096, the query mid-context).  Measure mode
    times CUDA-graph replays of each layer: each t_c is held at or above
    its H100 floor and below twice the device time of a layer of its kind,
    the profiled layers' at or above their own device time, and the
    captures are shown to hold the kernels (one Python launch per layer
    that runs one, and their device events in a replay).  Each alpha is
    held against B d 2."""
    from repro_torch.core import (
        H100_SXM,
        capture_layer,
        decode_layer_fns,
        measure_layer_times,
        profile_decode_layers,
    )
    from repro_torch.kernels import ops
    from repro_torch.models.model import hybrid_sites, trunk_layout

    t0 = time.perf_counter()
    iters, warmup = 10, 2
    (_, kind, n), = trunk_layout(cfg)
    sites = hybrid_sites(cfg)

    def kernels_of(i: int) -> dict:
        """Launches of each kernel in one call of layer i (0-based)."""
        return {"flash_decode": int(kind.mixer == "gqa") + int(i + 1 in sites),
                "ssd_update": int(kind.mixer == "mamba")}

    # profile_decode_layers(mode="measure") is decode_layer_fns +
    # measure_layer_times; the layers are wrapped here to read the
    # launches each makes while its graph is captured.
    fns, inputs = decode_layer_fns(cfg, wparams, SLOTS, CONTEXT)
    captured = []

    def wrap(fn):
        def call(args):
            before = dict(ops.launches)
            out = fn(args)
            if torch.cuda.is_current_stream_capturing():
                captured.append({k: ops.launches[k] - before[k] for k in KERNEL_EVENTS})
            return out
        return call

    measured, run = counted(torch, f"{name} measure-mode profile", lambda:
                            measure_layer_times([(nm, wrap(f)) for nm, f in fns],
                                                inputs, iters=iters, warmup=warmup))
    analyzed = profile_decode_layers(cfg, wparams, SLOTS, CONTEXT, mode="analyze",
                                     hardware=H100_SXM)
    torch.cuda.empty_cache()
    pos = CONTEXT // 2
    log(f"  profiled {len(measured)} layers in {time.perf_counter() - t0:.1f} s "
        f"(B={SLOTS}, C={CONTEXT}, query at {pos} with {pos} earlier positions in "
        f"every KV ring; measure mode: {warmup} eager calls, one capture, one "
        f"untimed and {iters} timed replays per layer); launches {run['launches']}")
    check(captured == [kernels_of(i) for i in range(n)],
          f"{name}: each layer's capture launched its kernels once per kernel it "
          f"runs ({sum(c['flash_decode'] for c in captured)} flash_decode, "
          f"{sum(c['ssd_update'] for c in captured)} ssd_update over {n} captures)")
    want = {k: (warmup + 1) * sum(kernels_of(i)[k] for i in range(n))
            for k in KERNEL_EVENTS}
    check(all(run["launches"][k] == v for k, v in want.items()),
          f"{name}: measure mode launched each kernel {warmup} eager + 1 captured "
          f"times per layer that runs it, the replays none from Python ({want})")
    # From here the run counts the kernels the card ran: a capture records
    # its launch and runs nothing; the one untimed and the timed replays
    # each run it.
    for k in KERNEL_EVENTS:
        run["launches"][k] += iters * sum(c[k] for c in captured)
    # Device time of single layers (all device events of an eager call,
    # profiler): the first and last layer and the first site layer.
    picks = sorted({0, n - 1, *(s - 1 for s in sites[:1])})
    dev_ms = {}
    for i in picks:
        dev_ms[i], src, _ = device_ms(lambda i=i: fns[i][1](inputs[i]))
        log(f"  {name} {fns[i][0]}: {dev_ms[i]:.5f} ms of device time per eager "
            f"call ({src})")
    # The captures hold the kernels: profiler windows over replays of a
    # layer of each kind show each of its kernels' device events, as many
    # per replay as per eager call of the layer.  Each call finds its
    # operands cold, as in a served step (the whole model runs between two
    # launches of one layer's kernel): back to back, a layer's 8.4 MB
    # Mamba2 state can stay in the 50 MB L2 in one window and not in the
    # next (ssd_update read 0.0069 then 0.0033 ms per call, faster than
    # HBM allows).
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def cold(fn):
        def call():
            flush.zero_()
            fn()
        return call

    for i in sorted({0, *(s - 1 for s in sites[:1])}):
        graph, _ = capture_layer(fns[i][1], inputs[i], warmup=1)
        for k, per_call in kernels_of(i).items():
            if not per_call:
                continue
            _, _, eager = device_ms(cold(lambda i=i: fns[i][1](inputs[i])),
                                    KERNEL_EVENTS[k])
            _, _, replay = device_ms(cold(graph.replay), KERNEL_EVENTS[k])
            check(replay == eager > 0,
                  f"{name} {fns[i][0]}: one replay of its graph ran {k} ({replay} "
                  f"device events, as one eager call: {eager})")
        del graph
    del fns, inputs, flush
    torch.cuda.empty_cache()
    floors = []
    for i, (m, a) in enumerate(zip(measured, analyzed)):
        floors.append(layer_floor(cfg, wparams, i, pos))
        log(f"    {m.name}{' (site)' if i + 1 in sites else ''}: graph-replay t_c "
            f"{m.time_s * 1e3:.5f} ms"
            + (f", device {dev_ms[i]:.5f} ms" if i in dev_ms else "")
            + f", floor {floors[-1] * 1e3:.5f} ms; plain lowering "
            f"{a.flops / 1e9:.4f} GFLOP, {a.bytes_accessed / 1e6:.2f} MB, roofline "
            f"{a.time_s * 1e3:.5f} ms")
    alpha = SLOTS * cfg.d_model * 2
    check(all(m.time_s >= f for m, f in zip(measured, floors)),
          f"{name}: every layer's measured t_c at or above its H100 floor (worst "
          f"ratio {min(m.time_s / f for m, f in zip(measured, floors)):.2f})")
    check(all(c.output_bytes == alpha for c in measured + analyzed),
          f"{name}: every alpha_i == {SLOTS} x {cfg.d_model} x 2 = {alpha} bytes")
    check(all(m.name == a.name for m, a in zip(measured, analyzed))
          and len(measured) == cfg.num_layers,
          f"{name}: both modes profile all {cfg.num_layers} layers")
    for i in picks:
        check(measured[i].time_s * 1e3 >= dev_ms[i],
              f"{name} {measured[i].name}: measured t_c {measured[i].time_s * 1e3:.5f} "
              f"ms at or above the layer's device time {dev_ms[i]:.5f} ms")
    # Every layer has the shapes of layer 1 or, at a site, of the first
    # site layer: its t_c stays within twice that layer's device time.
    kin = [sites[0] - 1 if i + 1 in sites else 0 for i in range(n)]
    ratios = [m.time_s * 1e3 / dev_ms[k] for m, k in zip(measured, kin)]
    worst = max(range(n), key=lambda i: ratios[i])
    check(max(ratios) <= 2.0,
          f"{name}: every layer's graph-replay t_c within 2x the device time of its "
          f"kind (worst {measured[worst].name}: {ratios[worst]:.3f}x)")
    if sites:
        on = [m.time_s for i, m in enumerate(measured) if i + 1 in sites]
        off = [m.time_s for i, m in enumerate(measured) if i + 1 not in sites]
        log(f"  {name}: site layers {list(sites)} measured "
            f"{[round(t * 1e3, 5) for t in on]} ms; the other layers' median "
            f"{statistics.median(off) * 1e3:.5f} ms")
    summary = dict(measured_ms=[m.time_s * 1e3 for m in measured],
                   floor_ms=[f * 1e3 for f in floors],
                   analyzed_ms=[a.time_s * 1e3 for a in analyzed],
                   analyzed_flops=[a.flops for a in analyzed],
                   analyzed_bytes=[a.bytes_accessed for a in analyzed],
                   device_ms={measured[i].name: dev_ms[i] for i in picks},
                   t_c_over_device=ratios)
    return measured, [run], summary


def calibrate_phase(torch, dev, cfg, wparams, compare: bool) -> tuple:
    """K=1 ``ServingEngine`` (every branch head in one exit launch) over
    the prompts for 8 decode steps; with ``compare``, its first step on the
    kernel path is first held against the plain path."""
    import numpy as np

    from repro_torch.serving import ServingEngine

    inputs = {"tokens": np.stack(prompts(cfg))}
    thr = cfg.exit_threshold
    engine = ServingEngine(cfg, wparams, context_len=CONTEXT, device=dev)
    check(engine.executor.segments[0].branches == cfg.branch_layers,
          f"K=1 engine evaluates every branch {cfg.branch_layers} in place")

    def first(eng):
        state = eng.start(inputs)
        tok = state["last_logits"].argmax(-1).to(torch.int32)[:, None]
        res, _ = eng.step(tok, state["pos"], state["caches"])
        del state
        return tok[:, 0].cpu().numpy(), res

    if compare:
        k_tok, kern = first(engine)
        plain_eng = ServingEngine(cfg, wparams, context_len=CONTEXT, device=dev,
                                  use_kernels=False)
        p_tok, plain = first(plain_eng)
        del plain_eng
        torch.cuda.empty_cache()
        near = k_tok != p_tok
        for layer, e in plain.branch_entropy.items():
            near |= (e < thr) != (kern.branch_entropy[layer] < thr)
        far = ~near
        for layer, e in plain.branch_entropy.items():
            de = float(np.abs(kern.branch_entropy[layer] - e)[far].max(initial=0.0))
            check(de < 1e-4, f"K=1 engine, first step: branch {layer} |dH| kernel vs "
                  f"plain {de:.3g} < 1e-4")
        check(bool((kern.exited == plain.exited)[far].all()) and all(
            bool((kern.branch_take[l] == plain.branch_take[l])[far].all())
            for l in plain.branch_take),
            f"K=1 engine, first step: exit masks kernel vs plain equal on rows whose "
            f"entropies do not straddle {thr:.6f} (rows at the edge: "
            f"{near.nonzero()[0].tolist()})")
    state = engine.start(inputs)
    syncs0 = engine.host_syncs
    (toks, stats), run = counted(torch, f"{cfg.name} K=1 calibration",
                                 lambda: engine.decode(state, 8))
    del state
    torch.cuda.empty_cache()
    check(engine.host_syncs - syncs0 == 8, "K=1 engine: one host sync per decode step")
    check(run["launches"]["entropy_exit_argmax_heads"] == 8,
          f"K=1 engine: one K={len(cfg.branch_layers)} exit launch per step "
          f"({run['launches']})")
    check(toks.shape == (SLOTS, 8) and bool((toks < cfg.vocab_size).all()),
          "K=1 engine: 8 tokens per row inside the vocabulary")
    p_k = stats.conditional_probs()
    log(f"  calibration at threshold {thr:.6f}: exit counts {stats.counts.tolist()} "
        f"(branches {cfg.branch_layers} + head), conditional p_k {p_k.tolist()}, "
        f"from the entropies {stats.calibrate(thr).conditional_p.tolist()}")
    return stats, [run], dict(counts=stats.counts.tolist(), p_k=p_k.tolist())


def solve_phase(torch, dev, cfg, measured, p_k, presets) -> dict:
    """Dijkstra on G'_BDNN, brute force and ``solve_chain_torch`` (float64 on
    the card) agree per preset, and a 64-point bandwidth sweep in one
    vmapped call agrees point by point with brute force."""
    import numpy as np

    from repro_torch.core import (
        NetworkProfile,
        Partitioner,
        brute_force_split,
        build_cost_profile,
        solve_chain_torch,
    )

    f64 = torch.float64
    out = {}
    for preset in presets:
        prof = build_cost_profile(measured, cfg.branch_layers, p_k, preset,
                                  gamma=GAMMA, raw_input_bytes=RAW_INPUT_BYTES)
        plan = Partitioner(prof, method="dijkstra").solve()
        oracle = brute_force_split(prof)
        args = [torch.tensor(x, dtype=f64, device=dev) for x in
                (prof.t_c, prof.alpha, prof.branch_exit_probs(), GAMMA,
                 prof.network.bandwidth_bps)]
        s_t, c_t = solve_chain_torch(*args)
        rel = max(abs(plan.expected_time_s - oracle.expected_time_s),
                  abs(float(c_t) - oracle.expected_time_s)) / oracle.expected_time_s
        check(plan.split_layer == oracle.split_layer == int(s_t) and rel <= 1e-9,
              f"{preset}: Dijkstra, brute force and solve_chain_torch (float64, "
              f"{dev}) agree on split {oracle.split_layer}, E[T] "
              f"{oracle.expected_time_s * 1e3:.4f} ms (rel diff {rel:.2g} <= 1e-9)")
        log(f"    {preset}: {plan.describe()}")
        out[preset] = dict(profile=prof, plan=plan)
    bws = np.logspace(5, 10, 64)
    sweep = torch.func.vmap(solve_chain_torch, in_dims=(None,) * 4 + (0,))
    s_sw, c_sw = sweep(*args[:4], torch.tensor(bws, dtype=f64, device=dev))
    s_sw, c_sw = s_sw.cpu().tolist(), c_sw.cpu().tolist()
    bad = []
    for bw, s, c in zip(bws, s_sw, c_sw):
        o = brute_force_split(dataclasses.replace(
            prof, network=NetworkProfile("sweep", float(bw))))
        if s != o.split_layer or abs(c - o.expected_time_s) > 1e-9 * o.expected_time_s:
            bad.append(float(bw))
    check(not bad, f"64-point bandwidth sweep 0.1 Mb/s .. 10 Gb/s in one vmapped "
          f"solve_chain_torch call equals brute force at every point (splits "
          f"{sorted(set(s_sw))}; failing: {bad or 'none'})")
    edges = [(float(bws[i]), s_sw[i]) for i in range(len(bws))
             if i == 0 or s_sw[i] != s_sw[i - 1]]
    log("    sweep: " + ", ".join(f"split {s} from {bw / 1e6:.4g} Mb/s" for bw, s in edges))
    # Each split the sweep reaches that no preset chose, at the first
    # (slowest) bandwidth that picks it: served beside the presets.
    chosen = {v["plan"].split_layer for v in out.values()}
    for bw, s in zip(bws, s_sw):
        if s not in chosen:
            chosen.add(s)
            swept = dataclasses.replace(prof, network=NetworkProfile(
                f"sweep {bw / 1e6:.3g} Mb/s", float(bw)))
            out[swept.network.name] = dict(profile=swept,
                                           plan=Partitioner(swept).solve())
    return out


def serve_plans_phase(torch, dev, cfg, wparams, solved) -> tuple[list, dict]:
    """One ``PartitionedServer`` with a cost profile serves each distinct
    solved split once; every step has a finite estimate, exact byte
    accounting and one host sync (plus overflow re-runs).  A preset that
    solves to a split already served re-prices that served trace under its
    own cost profile (only the estimate reads the profile)."""
    from repro_torch.serving import PartitionedServer, bytes_per_sequence

    first = next(iter(solved.values()))
    srv = PartitionedServer(cfg, wparams, first["plan"].split_layer, device=dev,
                            slots=SLOTS, context_len=CONTEXT)
    runs, out, traces = [], {}, {}
    for preset, sol in solved.items():
        prof, split = sol["profile"], sol["plan"].split_layer
        srv.cost_profile = prof
        wall = None
        if split in traces:
            trace = traces[split]
            est = [srv._estimate(split, r.tier_result) for r, *_ in trace]
            check(all(e is not None and math.isfinite(e) for e in est),
                  f"{preset}: est_latency_s finite on every step of the split-"
                  f"{split} trace, re-priced under the {preset} profile")
            est = [e * 1e3 for e in est]
            log(f"    {preset} split {split}: the served trace re-priced, "
                f"est_latency_s median {statistics.median(est):.4f} ms")
        else:
            srv.set_split(split)
            trace = traces[split] = []
            run = serve(torch, srv, NEW_TOKENS,
                        f"{cfg.name} {preset} plan, split {split}", trace)
            per_seq = bytes_per_sequence(cfg, split)
            check(all(r.est_latency_s is not None and math.isfinite(r.est_latency_s)
                      for r, *_ in trace), f"{preset}: est_latency_s finite every step")
            check(all(r.bytes_shipped == r.shipped * per_seq for r, *_ in trace),
                  f"{preset}: bytes_shipped == shipped x {per_seq:g} every step "
                  f"(shipped {[r.shipped for r, *_ in trace]})")
            check(all(syncs == 1 + retries for _, _, syncs, retries in trace),
                  f"{preset}: one host sync per step plus overflow re-runs")
            branchy = any(seg.branches for seg in srv.executor.segments)
            check(run["launches"]["flash_decode"] > 0 and
                  (run["launches"]["entropy_exit_argmax_heads"] > 0) == branchy,
                  f"{preset}: flash_decode launched, and the exit kernel launched "
                  f"{'since' if branchy else 'not at all: no branch runs before'} "
                  f"split {split} ({run['launches']})")
            est = [r.est_latency_s * 1e3 for r, *_ in trace]
            wall = [t * 1e3 for _, t, _, _ in trace]
            log(f"    {preset} split {split}: est_latency_s median "
                f"{statistics.median(est):.4f} ms (model: edge {GAMMA:g}x this card "
                f"+ {preset}) beside step wall time median "
                f"{statistics.median(wall):.3f} ms (this card, both tiers)")
            runs.append(run)
        out[preset] = dict(split=split, est_ms=est, step_ms=wall,
                           est_ms_median=statistics.median(est),
                           step_ms_median=wall and statistics.median(wall))
    del srv, traces
    torch.cuda.empty_cache()
    return runs, out


def k3_phase(torch, dev, cfg, wparams, prof, tiers, label) -> tuple[list, dict]:
    """A K=3 fleet solved on the lattice and served."""
    from repro_torch.core import solve_multitier
    from repro_torch.serving import MultiTierServer, bytes_per_sequence

    plan = solve_multitier(prof.t_c, prof.alpha, prof.branch_exit_probs(), tiers)
    log(f"  K=3 plan, {label} ({' -> '.join(f'{t.name} {t.gamma:g}x' for t in tiers)}, "
        f"uplinks {[t.uplink_bps for t in tiers[:-1]]} b/s): cuts after "
        f"{plan.cut_after}, E[T] {plan.expected_time_s * 1e3:.4f} ms")
    srv = MultiTierServer.from_plan(cfg, wparams, plan, tiers,
                                    cost=(prof.t_c, prof.alpha), device=dev,
                                    slots=SLOTS, context_len=CONTEXT)
    trace: list = []
    run = serve(torch, srv, NEW_TOKENS, f"{cfg.name} K=3 plan {plan.cut_after}", trace)
    for j, cut in enumerate(srv.cuts[:len(trace[0][0].bytes_per_hop)]):
        per_seq = bytes_per_sequence(cfg, cut)
        check(all(r.bytes_per_hop[j] == r.shipped_per_hop[j] * per_seq
                  for r, *_ in trace),
              f"K=3 hop {tiers[j].name}->{tiers[j + 1].name} (cut after {cut}): "
              f"bytes == shipped x {per_seq:g} every step (shipped "
              f"{[r.shipped_per_hop[j] for r, *_ in trace]})")
        check(cut == 0 or per_seq * SLOTS == prof.alpha[cut],
              f"K=3 hop {j}: per-row bytes x {SLOTS} rows == the profile's alpha")
    check(all(math.isfinite(r.est_latency_s) for r, *_ in trace)
          and all(syncs == 1 + retries for _, _, syncs, retries in trace),
          "K=3: est_latency_s finite and one host sync per step plus re-runs")
    branchy = any(seg.branches for seg in srv.executor.segments)
    check(run["launches"]["flash_decode"] > 0 and
          (run["launches"]["entropy_exit_argmax_heads"] > 0) == branchy,
          f"K=3: flash_decode launched, and the exit kernel "
          f"{'launched' if branchy else 'not: no tier before the last runs a branch'} "
          f"({run['launches']})")
    est = statistics.median(r.est_latency_s * 1e3 for r, *_ in trace)
    log(f"    K=3: est_latency_s median {est:.4f} ms, step wall median "
        f"{statistics.median(t * 1e3 for _, t, _, _ in trace):.3f} ms, exit tiers of "
        f"the last step {trace[-1][0].exit_tier.tolist()}")
    del srv
    torch.cuda.empty_cache()
    return [run], dict(label=label, cuts=list(plan.cut_after),
                       expected_ms=plan.expected_time_s * 1e3, est_ms_median=est,
                       hops=len(trace[0][0].bytes_per_hop))


def k3_move_phase(torch, dev, cfg, wparams) -> list[dict]:
    """K=3 at threshold 0.5 (no exits, so every bucket is the full batch):
    cuts (8, 24) served, then the first cut moved to 16: only the two
    segments whose key changed are captured again; the cloud segment
    (layers 24-32) replays the graph it already had."""
    from repro_torch.core import TierSpec
    from repro_torch.serving import MultiTierServer

    cfg0 = dataclasses.replace(cfg, exit_threshold=0.5)
    srv = MultiTierServer(cfg0, wparams, [TierSpec(*t) for t in K3_TIERS], (8, 24),
                          device=dev, slots=SLOTS, context_len=CONTEXT)
    ex = srv.executor
    run1 = serve(torch, srv, 4, f"{cfg.name} K=3 cuts (8, 24)")
    srv.install_cuts((16, 24))
    replays0 = dict(ex.replays)
    run2 = serve(torch, srv, 4, f"{cfg.name} K=3 cuts moved to (16, 24)")
    spans = sorted({key[0][:2] for key in run2["captured_keys"]})
    cloud = {k: n - replays0.get(k, 0) for k, n in ex.replays.items()
             if k[0][:2] == (24, 32)}
    check(spans == [(0, 16), (16, 24)] and sum(cloud.values()) > 0,
          f"K=3 cut move (8, 24) -> (16, 24): captured only the changed segments "
          f"{spans}; the cloud segment (24, 32) replayed its cached graph "
          f"{sum(cloud.values())} times")
    del srv, ex
    gc.collect()
    torch.cuda.empty_cache()
    return [run1, run2]


def controller_phase(torch, dev, cfg, wparams, solved, stats) -> tuple[list, dict]:
    """``RepartitionController`` at full width on the partition phase's
    profile: ``update`` on the 4g profile installs the split ``solve_phase``
    solved for 4g; ``update_network`` to 3g moves it to the 3g split; then
    a served run with the controller as the scheduler's ``on_step`` hook
    (a drift check every 4 steps at KL threshold 0, a probe step every 3rd)
    re-solves from the measured exits."""
    from repro_torch.core import Partitioner
    from repro_torch.serving import PartitionedServer, RepartitionController

    prof4 = solved["4g"]["profile"]
    srv = PartitionedServer(cfg, wparams, 0, cost_profile=prof4, device=dev,
                            slots=SLOTS, context_len=CONTEXT)
    ctl = RepartitionController(srv, prof4, kl_threshold=0.0, every_n_steps=4,
                                explore_every_n=3)
    want = {net: solved[net]["plan"].split_layer for net in ("4g", "3g")}
    got = {"4g": ctl.update(stats)[0]}
    got["3g"] = ctl.update_network(solved["3g"]["profile"].network)[0]
    check(got == want and srv.split_layer == want["3g"],
          f"controller: update on the 4g profile installs split {got['4g']}, "
          f"update_network to 3g moves it to {got['3g']} (solve_phase: {want})")
    swaps = []
    srv.scheduler.on_step.append(lambda res: swaps.append(ctl.observe(res)))
    run = serve(torch, srv, NEW_TOKENS, f"{cfg.name} under the controller")
    moved = [s for s in swaps if s is not None]
    resolved = Partitioner(ctl.profile).with_exit_probs(ctl._installed_p).solve()
    check(bool(moved) and (srv.split_layer,) == moved[-1] == (resolved.split_layer,),
          f"controller: the drift check re-solved {len(moved)} times from the "
          f"measured exits (cuts {moved}), the last install equal to Dijkstra on "
          f"the measured p_k {ctl._installed_p.tolist()}")
    log(f"  controller: measured p_k {ctl.measured_probs().tolist()}, split now "
        f"{srv.split_layer}, {run['captured']} keys captured in the run (probe "
        f"steps' among them)")
    del srv, ctl
    gc.collect()
    torch.cuda.empty_cache()
    return [run], dict(update_4g=got["4g"], update_network_3g=got["3g"],
                       resolves=[list(m) for m in moved])


def probe_phase(torch, dev, cfg, wparams) -> list[dict]:
    """Two graphed servers at split 24 on equal caches and inputs (512-slot
    rings); the second probes at steps 2 (every head) and 3 (half the rows
    sampled): tokens and exits of every step, and then every cache tensor,
    bitwise those of the first."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import PartitionedServer, RequestScheduler

    srvs = [PartitionedServer(cfg, wparams, 24, device=dev) for _ in range(2)]
    scheds = [RequestScheduler(s, SLOTS, 512) for s in srvs]
    for sched in scheds:
        for p in prompts(cfg):
            sched.submit(p, 8)
    ex = srvs[1].executor
    torch.cuda.synchronize()
    ops.reset_launches()
    same, probed = True, []
    for i in range(4):
        ex.probe_next = i in (1, 2)
        ex.probe_sample_frac = 0.5 if i == 2 else 1.0
        a, b = (s.step().server_report.tier_result for s in scheds)
        same &= all(np.array_equal(x, y) for x, y in (
            (a.tokens, b.tokens), (a.exited, b.exited), (a.exit_tier, b.exit_tier)))
        probed.append((sorted(b.branch_take), sorted(b.branch_probe_mask)))
    torch.cuda.synchronize()
    launches = dict(ops.launches)

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    caches_equal = all(torch.equal(x, y) for x, y in
                       zip(leaves(scheds[0].caches), leaves(scheds[1].caches)))
    kept = sorted(srvs[0].executor.segments[0].branches)
    check(same and caches_equal and probed[1][0] == probed[2][0] == sorted(
        cfg.branch_layers) and probed[2][1] and probed[0][0] == probed[3][0] == kept,
          f"probe steps (full, then sampled) leave tokens, exits and every cache "
          f"tensor bitwise those of normal steps; branches reported per step "
          f"{probed}")
    del srvs, scheds, ex
    gc.collect()
    torch.cuda.empty_cache()
    return [dict(label=f"{cfg.name} probe steps", launches=launches)]


def partition_phase(torch, dev, path: E2EPath, cfg, wparams) -> tuple[list, dict]:
    """The paper's control plane on the card, on resident weights: profile
    the layers, calibrate exits on the K=1 engine, solve the cut, and (for
    ``partition == "full"``) serve each solved split and the K=3 plan.
    ``cfg`` carries the e2e phase's median threshold."""
    from repro_torch.core import TierSpec

    log(f"partition: {cfg.name}; cost profiles with gamma {GAMMA:g} and a raw "
        f"input of {RAW_INPUT_BYTES:g} bytes, as in examples/serve_partitioned.py")
    full = path.partition == "full"
    stamp(f"{cfg.name}: served runs done")
    measured, runs, prof_summary = profile_phase(torch, cfg, wparams, cfg.name)
    stats, cal_runs, cal = calibrate_phase(torch, dev, cfg, wparams, compare=full)
    p_k = stats.conditional_probs()
    runs += cal_runs
    solved = solve_phase(torch, dev, cfg, measured, p_k, PRESETS if full else ("4g",))
    out = dict(profile=prof_summary, calibration=cal,
               splits={k: v["plan"].split_layer for k, v in solved.items()})
    if full:
        serve_runs, out["served"] = serve_plans_phase(torch, dev, cfg, wparams, solved)
        runs += serve_runs
        out["k3"] = []
        example = [TierSpec(*t) for t in K3_TIERS]
        degraded = [example[0], dataclasses.replace(example[1], uplink_bps=0.4e6),
                    example[2]]
        for tiers, label in ((example, "the example's fleet"),
                             (degraded, "edge backhaul degraded to 0.4 Mb/s")):
            k3_runs, k3 = k3_phase(torch, dev, cfg, wparams, solved["3g"]["profile"],
                                   tiers, label)
            runs += k3_runs
            out["k3"].append(k3)
        stamp(f"{cfg.name}: profiled, calibrated, solved, served the plans")
        runs += k3_move_phase(torch, dev, cfg, wparams)
        ctl_runs, out["controller"] = controller_phase(torch, dev, cfg, wparams,
                                                       solved, stats)
        runs += ctl_runs
        runs += probe_phase(torch, dev, cfg, wparams)
    return runs, out


#: A routing flip is shown when, at the first MoE layer where a token's
#: top-k expert set differs between the kernel path and the plain path,
#: each such token's top-k margin (its k-th minus its (k+1)-th router logit
#: on the plain path) is at most this many bf16 ulps of its k-th logit: the
#: 8-ulp bound the logits of the two paths are held to.  A flip needs the
#: two paths' logits to differ by at least half the margin.
FLIP_ULPS = 8


def routed_first_steps(torch, cfg, wparams, server) -> dict:
    """:func:`first_step` on an eager kernel server and an eager plain
    server, each recording the router logits and top-k indices of the MoE
    calls of its decode step (calls of at most SLOTS tokens: the
    admission's groups are larger).  Returns {kernels: (step, calls)}."""
    from repro_torch.models import moe

    topk, out = moe.router_topk, {}
    for kernels in (True, False):
        calls = []

        def recording(logits, k, calls=calls):
            w, idx, aux = topk(logits, k)
            if logits.shape[0] * logits.shape[1] <= SLOTS:
                calls.append((logits.float().clone(), idx.clone()))
            return w, idx, aux

        srv = server(cfg, wparams, graphs=False,
                     **({} if kernels else dict(use_kernels=False)))
        moe.router_topk = recording
        try:
            step = first_step(torch, srv)
        finally:
            moe.router_topk = topk
        del srv
        released(torch)
        out[kernels] = (step, calls)
    return out


def routing_divergence(torch, cfg, split, rec, label):
    """Rows whose MoE routing differs between the kernel path and the
    plain path in one recorded first step (:func:`routed_first_steps`),
    and the routing flip that explains them.  A row is touched where its
    top-k expert set or its keep mask differs at some layer (at a
    capacity of one slot per expert a flip in one row can drop another
    row's choice).  Calls of the edge (layers before ``split``) hold the
    rows in order; the cloud's bucket holds the survivors first, then the
    rows that exited (each path's own exit mask).  Fails unless every
    difference follows a flip at a near-tie: at the first layer with a
    differing top-k set, each differing token's margin is at most
    FLIP_ULPS bf16 ulps; a keep mask may differ only in a group where a
    set differs, and a bucket may hold other rows only where the exit
    masks differ."""
    import numpy as np

    from repro_torch.models.moe import expert_slots

    (step_k, calls_k), (step_p, calls_p) = rec[True], rec[False]
    e, k = cfg.num_experts, cfg.experts_per_token
    n_moe = cfg.num_layers - cfg.first_k_dense  # the MoE stack follows the dense one
    check(len(calls_k) == len(calls_p) == n_moe,
          f"{label}: both paths recorded one router call per MoE layer "
          f"({len(calls_k)}, {len(calls_p)} of {n_moe})")

    def rows_of(layer, exited, t):
        order = np.argsort(exited.astype(np.uint8), kind="stable")
        return (np.arange(SLOTS) if layer < split else order)[:t]

    touched = np.zeros(SLOTS, bool)
    first, margins, moved, composed, worst_agree = None, [], [], [], 0.0
    for layer, ((lk, ik), (lp, ip)) in enumerate(zip(calls_k, calls_p),
                                                 start=cfg.first_k_dense):
        t = ip.shape[1]
        rk, rp = rows_of(layer, step_k["exited"], ik.shape[1]), rows_of(
            layer, step_p["exited"], t)
        if ik.shape != ip.shape or not np.array_equal(rk, rp):
            touched[rk] = touched[rp] = True
            composed.append(layer + 1)
            continue
        differ = (ik[0].sort(-1).values != ip[0].sort(-1).values).any(-1).cpu().numpy()
        cap = max(math.ceil(t * k * cfg.capacity_factor / e), 1)

        def kept(idx):  # each token's set of experts that keep its choice
            return torch.where(expert_slots(idx, e, cap)[1], idx, -1)[0].sort(-1).values

        kdiff = (kept(ik) != kept(ip)).any(-1).cpu().numpy()
        check(differ.any() or not kdiff.any(),
              f"{label} layer {layer + 1}: kept expert sets differ only in a group "
              "whose top-k sets differ")
        if first is None:
            # Up to the first flip the router logits track each other.
            worst_agree = max(worst_agree, float((lk - lp).abs().max()) / bf16_ulps(lp))
        if differ.any() and first is None:
            top = lp[0].topk(k + 1, dim=-1).values.cpu().numpy()
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(top[:, k - 1]),
                                                      2.0 ** -126))) - 7)
            first = layer + 1
            margins = ((top[:, k - 1] - top[:, k]) / ulp)[differ].tolist()
            moved = ((lk[0] - lp[0]).abs().amax(-1).cpu().numpy() / ulp)[differ].tolist()
        touched[rp[differ | kdiff]] = True
    check(not composed or not np.array_equal(step_k["exited"], step_p["exited"]),
          f"{label}: a cloud bucket holds other rows on the two paths only where "
          f"their exit masks differ (layers {composed})")
    check(worst_agree <= 1.0,
          f"{label}: router logits kernel vs plain within 8 bf16 ulps of their scale "
          f"at every layer up to the first flip (worst at {worst_agree:.3f} of it)")
    if touched.any() and not composed:
        check(first is not None and max(margins) <= FLIP_ULPS,
              f"{label}: the rows whose routing differs {touched.nonzero()[0].tolist()} "
              f"follow a routing flip at a near-tie: first at layer {first}, top-k "
              f"margins {margins} bf16 ulps <= {FLIP_ULPS}")
    log(f"  {label}: routing kernel vs plain path: first differing top-k at layer "
        f"{first} (margins {margins} bf16 ulps of the k-th logit; the two paths' "
        f"router logits there {moved} ulps apart), rows whose routing differs "
        f"{touched.nonzero()[0].tolist()}, other bucket rows at layers {composed}")
    return touched, dict(first_flip_layer=first, flip_margins_ulps=margins,
                         flip_logits_apart_ulps=moved, router_agreement=worst_agree,
                         rows_routed_apart=touched.nonzero()[0].tolist())


def same_step(a, b) -> bool:
    """Two :func:`first_step` results bitwise equal."""
    import numpy as np

    return (all(np.array_equal(a[f], b[f]) for f in ("tok0", "tokens", "exited"))
            and all(np.array_equal(a["ents"][l], b["ents"][l]) for l in a["ents"])
            and a["logits"].equal(b["logits"]))


def e2e_phase(torch, dev, path: E2EPath) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import (
        hybrid_sites,
        init_caches,
        init_params,
        prefill,
    )
    from repro_torch.serving import PartitionedServer

    cfg0 = get_config(path.arch)
    depth = (f"full width, {dict(path.reduced)['num_layers']} of its "
             f"{cfg0.num_layers} layers" if path.reduced else "full width and depth")
    cfg0 = dataclasses.replace(cfg0, **dict(path.reduced))
    if path.bf16_params:
        cfg0 = dataclasses.replace(cfg0, param_dtype="bfloat16")
    split, name, moe = path.split, cfg0.name, cfg0.arch_type == "moe"
    log(f"end to end: {name} {depth} ({cfg0.num_layers} layers, "
        f"d_model {cfg0.d_model}, vocab {cfg0.vocab_size} padded to "
        f"{cfg0.padded_vocab_size}, branches {cfg0.branch_layers}, shared-"
        f"attention sites {hybrid_sites(cfg0)}"
        + (f", {cfg0.num_experts} experts, top-{cfg0.experts_per_token}, "
           f"moe_d_ff {cfg0.moe_d_ff}, {cfg0.num_shared_experts} shared, first "
           f"{cfg0.first_k_dense} layers dense" if moe else "")
        + (f", MLA kv_rank {cfg0.mla_kv_rank} q_rank {cfg0.mla_q_rank} rope "
           f"{cfg0.mla_rope_dim}" if cfg0.use_mla else "")
        + f"), params {cfg0.param_dtype}, split {split}, {SLOTS} slots x {CONTEXT}")
    released(torch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg0, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in tree_tensors(params))
    init_peak = torch.cuda.max_memory_allocated() - held
    log(f"  init_params: {nbytes / 1e9:.2f} GB of {cfg0.param_dtype} params "
        f"({nbytes // (2 if path.bf16_params else 4) / 1e9:.2f} B), peak "
        f"{init_peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB held before, "
        f"{init_s:.1f} s")
    cfg_a = dataclasses.replace(cfg0, exit_threshold=0.5)

    def server(cfg, weights, **kw):
        return PartitionedServer(cfg, weights, split, device=dev, slots=SLOTS,
                                 context_len=CONTEXT, **kw)

    srv = server(cfg_a, params)
    wparams = srv.params  # compute copies; every later server shares them
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  params ready in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    check(srv.executor.use_kernels, "the server resolved use_kernels=None to the kernels")
    edge_branches = tuple(b for b in cfg0.branch_layers if b < split)
    check(srv.executor.segments[0].branches == edge_branches,
          f"{name}: the edge keeps branches {edge_branches} (K=2)")

    vocab = cfg0.vocab_size  # pad lanes (-1e30 on both paths) left out

    def logit_bound(plain_logits):
        """8 bf16 ulps at the logits' own scale: the two paths differ only
        in the kernels, each within a few fp32 ulps or one bf16 ulp of its
        plain version; a wrong kernel in any layer moves logits by O(scale)."""
        return bf16_ulps(plain_logits), float(plain_logits.abs().max())

    def near_tie(plain_logits, d):
        """Rows whose top-2 gap is at most 2 d: with every logit within d of
        the other path's, only these can change their argmax."""
        return top2_gap(plain_logits) <= 2 * d

    # Admission: the prompts' last-position logits, kernel path (the
    # ssd_scan kernel in every Mamba2 layer) against plain path.  Their
    # argmax is each row's first decode input, so a flip at a near-tie
    # gives that row a different input on the two paths.
    toks = torch.as_tensor(np.stack(prompts(cfg0)), device=dev).long()
    pre = {}
    for kernels in (True, False):
        caches = init_caches(cfg_a, SLOTS, PROMPT + 1, device=dev)
        lg, _ = prefill(wparams, toks, cfg_a, caches, rows=np.arange(SLOTS),
                        use_kernels=kernels)
        pre[kernels] = lg[:, 0, :vocab].float()
        del caches
    pre_tol, pre_scale = logit_bound(pre[False])
    dpre = float((pre[True] - pre[False]).abs().max())
    check(dpre <= pre_tol,
          f"{name} admission: max |d logit| kernel vs plain {dpre:.4g} <= "
          f"{pre_tol:.4g} (8 bf16 ulps at the logits' scale {pre_scale:.3f})")
    pre_tie = near_tie(pre[False], dpre)

    # First decode step: kernel path vs plain path on the same card.
    kern = first_step(torch, srv, sync_check=True)
    plain_srv = server(cfg_a, wparams, use_kernels=False)
    plain = first_step(torch, plain_srv)
    del plain_srv
    same_in = kern["tok0"] == plain["tok0"]
    check(bool((same_in | pre_tie).all()),
          f"{name} first decode inputs equal on every row not at an admission "
          f"near-tie (differ on {(~same_in).nonzero()[0].tolist()}, near-ties "
          f"{pre_tie.nonzero()[0].tolist()}); only equal-input rows are compared")
    routing = {}

    def routed_apart(cfg, kern_, plain_, label):
        """MoE: rows routed apart by a flip at a near-tie (listed, not
        compared), from eager twins of both paths that record the router,
        each bitwise its graphed first step."""
        if not moe:
            return np.zeros(SLOTS, bool)
        rec = routed_first_steps(torch, cfg, wparams, server)
        check(same_step(rec[True][0], kern_) and same_step(rec[False][0], plain_),
              f"{label}: the graphed first steps bitwise equal their eager twins "
              "(kernel and plain)")
        touched, routing[label] = routing_divergence(torch, cfg, split, rec, label)
        return touched

    apart = routed_apart(cfg_a, kern, plain, f"{name} threshold 0.5 first step")
    rows_in = torch.as_tensor(same_in, device=dev)
    dlog_tol, scale = logit_bound(plain["logits"][rows_in, :vocab])
    row_d = (kern["logits"] - plain["logits"])[:, :vocab].abs().amax(dim=-1).cpu().numpy()
    # MoE: a row beyond the bound is listed, not compared, only where a
    # routing flip at a near-tie routed it apart (routing_divergence).
    listed = same_in & apart & (row_d > dlog_tol)
    cmp = same_in & ~listed
    dlog = float(row_d[cmp].max(initial=0.0))
    check(dlog <= dlog_tol,
          f"{name} first step: max |d logit| kernel vs plain {dlog:.4g} <= "
          f"{dlog_tol:.4g} (8 bf16 ulps at the logits' scale, max |logit| {scale:.3f}) "
          f"on {int(cmp.sum())} rows"
          + (f"; rows {listed.nonzero()[0].tolist()} routed apart by a flip, listed "
             f"(|d logit| {row_d[listed].round(4).tolist()})" if listed.any() else ""))
    edge = near_tie(plain["logits"][:, :vocab], dlog)
    same = kern["tokens"] == plain["tokens"]
    log(f"  rows at a near-tie (top-2 gap <= 2 x {dlog:.4g}), where the "
        f"paths may pick either token: {edge.nonzero()[0].tolist()}")
    check(bool((same | edge | ~cmp).all()),
          f"{name} first-step tokens equal on every compared row not at a "
          f"near-tie (differ on {(~same).nonzero()[0].tolist()})")
    thr = float(statistics.median(plain["ents"][path.branch].tolist()))
    for layer in plain["ents"]:
        de = abs(kern["ents"][layer] - plain["ents"][layer])
        over = same_in & (de >= 1e-4)
        check(not (over & ~apart).any(),
              f"{name} branch {layer}: |dH| kernel vs plain "
              f"{float(de[same_in & ~over].max(initial=0.0)):.3g} < 1e-4"
              + (f"; rows {over.nonzero()[0].tolist()} routed apart by a flip, listed"
                 if over.any() else ""))
    same_in = cmp

    def launched(run, label):
        check(all(run["launches"][k] > 0 for k in path.kernels),
              f"{name} {label}: every kernel of the path launched "
              f"{ {k: run['launches'][k] for k in path.kernels} }")

    def twin_runs(srv, cfg, label, pin_at=None, profile=False):
        """The graphed server's run, then its graphs=False twin's, from
        fresh hints each, held bitwise equal; with ``profile`` the twin's
        steady decode is profiled too."""
        trace_g, trace_e = [], []
        srv.executor.install(srv.executor.segments)  # fresh hints
        run_g = serve(torch, srv, path.new_tokens, label, trace_g, pin_at)
        eager = server(cfg, wparams, graphs=False)
        run_e = serve(torch, eager, path.new_tokens, f"{label}, eager twin", trace_e,
                      pin_at)
        prof_e = profile_decode(torch, eager, f"{label}, eager twin") if profile else None
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        same_runs(torch, trace_g, trace_e, label)
        check(run_g["replays"] > 0 and run_e["replays"] == 0,
              f"{label}: the graphed run replayed {run_g['replays']} segment graphs "
              f"({run_g['captured']} captured), the eager twin none")
        return run_g, run_e, prof_e

    def profiled(srv, run_g, run_e, prof_e, label):
        """The graphed server's steady decode profiled beside its eager
        twin's; idle shares and the summary line."""
        prof_g = profile_decode(torch, srv, label)
        check(prof_g["replayed"] > 0, f"{label}: the profiled steps replayed "
              f"{prof_g['replayed']} graphs")
        # The profiler's own host cost stretches its window: the idle share
        # is also read against the unprofiled run's median step.
        idle = {k: 1.0 - p["device_ms_per_step"] / r["decode_step_ms"]
                for k, p, r in (("graphs", prof_g, run_g), ("eager", prof_e, run_e))}
        log(f"  {label}, graphs / eager: decode step "
            f"{run_g['decode_step_ms']:.3f} / {run_e['decode_step_ms']:.3f} ms (host "
            f"clock), device {prof_g['device_ms_per_step']:.3f} / "
            f"{prof_e['device_ms_per_step']:.3f} ms per step, idle share "
            f"{prof_g['device_idle_share']:.3f} / {prof_e['device_idle_share']:.3f} in "
            f"the profiled window ({prof_g['wall_ms_per_step']:.3f} / "
            f"{prof_e['wall_ms_per_step']:.3f} ms per step there), 1 - device / step "
            f"{idle['graphs']:.3f} / {idle['eager']:.3f}, {run_g['tokens_per_s']:.1f} / "
            f"{run_e['tokens_per_s']:.1f} tokens/s")
        return prof_g, idle

    stamp(f"{name}: first steps checked")
    runs_a = []
    if not path.median_only:
        run_a, run_ae, prof_ae = twin_runs(srv, cfg_a, f"{name} threshold 0.5",
                                           profile=True)
        launched(run_a, "threshold 0.5")
        prof_a, idle = profiled(srv, run_a, run_ae, prof_ae, f"{name} threshold 0.5")
        runs_a = [run_a, run_ae]
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    cfg_b = dataclasses.replace(cfg0, exit_threshold=thr)
    srv = server(cfg_b, wparams)
    # First step at the median threshold: the exit kernel's own flags pick
    # the rows that exit on the edge, against the plain path's.
    kern_b = first_step(torch, srv)
    plain_srv = server(cfg_b, wparams, use_kernels=False)
    plain_b = first_step(torch, plain_srv)
    del plain_srv
    # A row whose two entropies (each path's own, within 1e-4 of each
    # other) fall on two sides of the threshold at some branch may exit on
    # either path, as may a row whose first decode input differs; such rows
    # are listed, not compared.
    near = kern_b["tok0"] != plain_b["tok0"]
    apart_b = routed_apart(cfg_b, kern_b, plain_b, f"{name} median threshold first step")
    for layer, e in plain_b["ents"].items():
        near |= (e < thr) != (kern_b["ents"][layer] < thr)
    far = ~near
    for layer, e in plain_b["ents"].items():
        computed = far & (e != 0) & (kern_b["ents"][layer] != 0)
        de_rows = np.abs(kern_b["ents"][layer] - e)
        over = computed & (de_rows >= 1e-4)
        de = float(de_rows[computed & ~over].max(initial=0.0))
        check(not (over & ~apart_b).any(),
              f"{name} median threshold, first step: branch {layer} "
              f"|dH| kernel vs plain {de:.3g} < 1e-4"
              + (f"; rows {over.nonzero()[0].tolist()} routed apart by a flip, listed"
                 if over.any() else ""))
    mask_diff = (kern_b["exited"] != plain_b["exited"]) | np.any(
        [kern_b["takes"][l] != plain_b["takes"][l] for l in plain_b["takes"]], axis=0)
    masks_equal = not (mask_diff & far & ~apart_b).any()
    check(bool(plain_b["exited"].any()),
          f"{name} median threshold, first step: rows exit on the edge "
          f"({plain_b['exited'].astype(int).tolist()})")
    check(masks_equal,
          f"{name} median threshold, first step: exit masks and per-branch takes "
          f"kernel vs plain equal on rows whose entropies do not straddle the "
          f"threshold (rows at the edge: {near.nonzero()[0].tolist()})"
          + (f"; rows {(mask_diff & far).nonzero()[0].tolist()} routed apart by a "
             "flip, listed" if (mask_diff & far).any() else ""))
    row_dlog = (kern_b["logits"] - plain_b["logits"])[:, :vocab].abs().amax(
        dim=-1).cpu().numpy()
    stay = far & ~plain_b["exited"] & ~(mask_diff | (apart_b & (row_dlog > dlog_tol)))
    dlog_b = float(row_dlog[stay].max()) if stay.any() else 0.0
    check(dlog_b <= dlog_tol, f"{name} median threshold, first step: max |d logit| "
          f"on rows that stay {dlog_b:.4g} <= {dlog_tol:.4g}")
    edge_b = near_tie(plain_b["logits"][:, :vocab], dlog_b)
    same_b = kern_b["tokens"] == plain_b["tokens"]
    check(bool((same_b | edge_b | ~stay).all()),
          f"{name} median threshold, first step: main-head tokens equal on rows "
          f"that stay, away from near-ties (near-tie rows: "
          f"{(edge_b & stay).nonzero()[0].tolist()})")
    stamp(f"{name}: threshold 0.5 runs done; median threshold first steps checked")
    # A forced overflow re-run at the third step: the hints pinned to 1.
    run_b, run_be, prof_be = twin_runs(srv, cfg_b, f"{name} threshold {thr:.6f}",
                                       pin_at=2, profile=path.median_only)
    if path.median_only:
        run_a, run_ae = run_b, run_be
        prof_a, idle = profiled(srv, run_b, run_be, prof_be,
                                f"{name} threshold {thr:.6f}")
        prof_ae = prof_be
    check(run_b["exits"] > 0 and min(run_b["cloud_buckets"]) < SLOTS,
          f"{name} median threshold: rows exit on the edge and the cloud runs "
          f"compacted buckets {run_b['cloud_buckets']}")
    check(run_b["overflow_retries"] >= 1,
          f"{name} median threshold: the pinned hints forced "
          f"{run_b['overflow_retries']} overflow re-runs, on both twins")
    launched(run_b, "median threshold")
    runs = [*runs_a[:1], run_b, *runs_a[1:], run_be]
    if path.swap_to:
        runs += swap_phase(torch, srv, path.swap_to)
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    if path.single_head:
        srv = server(cfg_b, wparams, heads_batched=False)
        run_c = serve(torch, srv, 4, f"{name} single-head exits")
        check(run_c["launches"]["entropy_exit_argmax"] > 0
              and run_c["launches"]["entropy_exit_argmax_heads"] == 0,
              f"heads_batched=False: the single-head kernel launched {run_c['launches']}")
        runs.append(run_c)
        del srv
    partition = None
    if path.partition:
        gc.collect()
        torch.cuda.empty_cache()
        part_runs, partition = partition_phase(torch, dev, path, cfg_b, wparams)
        runs += part_runs
    link = None
    if path.link:
        gc.collect()
        torch.cuda.empty_cache()
        link_runs, link = link_phase(torch, dev, cfg_a, cfg_b, wparams,
                                     run_a["decode_step_ms"], prof_a["device_ms_per_step"])
        runs += link_runs
    del wparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {name}: max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"since its init (params {nbytes / 1e9:.2f} GB)")
    return dict(arch=path.arch, runs=runs, profile=prof_a, profile_eager=prof_ae,
                idle_from_step=idle, threshold=thr,
                partition=partition, link=link, routing=routing,
                init_params_gb=nbytes / 1e9, init_params_peak_gb=init_peak / 1e9,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                admission_max_dlogit=dpre, admission_dlogit_bound=pre_tol,
                first_step_max_dlogit=dlog, first_step_dlogit_bound=dlog_tol,
                first_step_rows_compared=int(same_in.sum()))


# ---------------------------------------------------------------- phase 4b
#: The link phases' cuts on Qwen3-8B: split 20 keeps branches 9 and 18 on
#: the edge; at 18 the branch sits at the cut (discarded, the fallback of a
#: broken hop); 8 is below every branch.
LINK_SPLIT, KILL_SPLIT, NO_HEAD_SPLIT = 20, 18, 8
#: examples/serve_partitioned.py's fault fleet: edge -> wifi -> mid -> 4g -> cloud.
FAULT_TIERS = (("edge", 12.0, 18.8e6), ("mid", 4.0, 5.85e6), ("cloud", 1.0))


def server_at(cfg, wparams, split, dev, **kw):
    from repro_torch.serving import PartitionedServer

    return PartitionedServer(cfg, wparams, split, device=dev, slots=SLOTS,
                             context_len=CONTEXT, **kw)


def released(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def tree_tensors(tree):
    """Every tensor of a params or caches tree (Whisper's ``cross_kv`` is a
    tuple)."""
    if isinstance(tree, (dict, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from tree_tensors(v)
    else:
        yield tree


def link_phase(torch, dev, cfg_a, cfg_b, wparams, step_ms: float,
               device_ms: float) -> tuple[list, dict]:
    """The edge-cloud link on the resident weights.  Split 20 over an uplink
    that ships the full batch (8 x 8192 B) in one graphed step of the e2e
    run: served without simulation, then ``simulate_network`` serial and
    pipelined, on the same requests at threshold 0.5 (every row ships),
    the hints pinned to 1 at the third step (a forced re-run, which a
    pipelined server pays serially); a dead uplink; a benign fault model;
    then :func:`fault_phases`."""
    from repro_torch.core import LayerCost, NetworkProfile, build_cost_profile
    from repro_torch.serving import LinkDownError, LinkFaultModel, bytes_per_sequence
    from repro_torch.serving.tiers import TOKEN_ID_BYTES

    name, n = cfg_a.name, cfg_a.num_layers
    per_row = bytes_per_sequence(cfg_a, LINK_SPLIT)
    bw = SLOTS * per_row * 8.0 / (step_ms / 1e3)
    net = NetworkProfile("link", bw)
    # The estimate's model: both tiers this card (gamma 1), each layer an
    # equal share of the measured device step, the batch's residual per cut.
    costs = [LayerCost(f"block{i}", 0.0, 0.0, per_row * SLOTS, device_ms / 1e3 / n)
             for i in range(1, n + 1)]
    prof = build_cost_profile(costs, cfg_a.branch_layers,
                              [0.0] * len(cfg_a.branch_layers), net, 1.0,
                              TOKEN_ID_BYTES * SLOTS)
    log(f"link: {name} split {LINK_SPLIT}, uplink {bw / 1e6:.3f} Mb/s: the batch's "
        f"{SLOTS} x {per_row:g} B in {step_ms:.3f} ms (the graphed step); est model "
        f"{device_ms:.3f} ms of device time over {n} layers")
    runs, traces, out = [], {}, dict(uplink_bps=bw)
    for mode in ("off", "serial", "pipelined"):
        srv = server_at(cfg_a, wparams, LINK_SPLIT, dev, network=net, cost_profile=prof,
                        simulate_network=mode != "off",
                        overlap="pipelined" if mode == "pipelined" else "serial")
        trace = traces[mode] = []
        run = serve(torch, srv, NEW_TOKENS, f"{name} link {mode}", trace, pin_at=2)
        run["pipeline_fallbacks"] = srv.executor.pipeline_fallbacks
        sim = [sum(r.sim_transfer_s) * 1e3 for r, *_ in trace]
        out[mode] = dict(step_ms=run["decode_step_ms"], wall_s=run["wall_s"],
                         est_ms_median=statistics.median(
                             r.est_latency_s * 1e3 for r, *_ in trace),
                         sim_ms_median=statistics.median(sim),
                         overflow_retries=run["overflow_retries"],
                         pipeline_fallbacks=run["pipeline_fallbacks"])
        if mode != "off":
            check(all(r.sim_transfer_s == (r.bytes_shipped * 8.0 / bw,)
                      for r, *_ in trace),
                  f"{name} link {mode}: sim_transfer_s == bytes x 8 / uplink every step")
        runs.append(run)
        del srv
        released(torch)
    same_runs(torch, traces["serial"], traces["pipelined"], f"{name} link", sim=True,
              what="serial run == pipelined run")
    same_runs(torch, traces["off"], traces["serial"], f"{name} link",
              what="run without simulation == serial run")
    check(out["pipelined"]["pipeline_fallbacks"] == out["pipelined"]["overflow_retries"]
          >= 1 and out["serial"]["pipeline_fallbacks"] == 0,
          f"{name} link: the pipelined server paid its {out['pipelined']['overflow_retries']} "
          f"forced re-run(s) serially (pipeline_fallbacks "
          f"{out['pipelined']['pipeline_fallbacks']}); serial none")
    log(f"  {name} link step (host clock, median): no simulation "
        f"{out['off']['step_ms']:.3f} ms, serial {out['serial']['step_ms']:.3f} ms, "
        f"pipelined {out['pipelined']['step_ms']:.3f} ms; transfer "
        f"{out['serial']['sim_ms_median']:.3f} ms; device {device_ms:.3f} ms per step; "
        f"est_latency_s {out['serial']['est_ms_median']:.4f} / "
        f"{out['pipelined']['est_ms_median']:.4f} ms (serial / pipelined)")

    # A dead uplink with bytes to ship and no fault model raises.
    dead = server_at(cfg_a, wparams, LINK_SPLIT, dev,
                     network=NetworkProfile("dead", 0.0), simulate_network=True)
    for p in prompts(cfg_a):
        dead.submit(p, 2)
    try:
        dead.run(max_steps=1)
        raised = ""
    except LinkDownError as e:
        raised = str(e)
    check("hop 0" in raised, f"{name}: a zero uplink with bytes to ship raises "
          f"LinkDownError ({raised!r})")
    del dead
    released(torch)

    # A benign fault model (no flaps, drops or spikes, multiplier 1).
    srv = server_at(cfg_a, wparams, LINK_SPLIT, dev, network=net, cost_profile=prof,
                    simulate_network=True, fault_model=LinkFaultModel(seed=0))
    trace = []
    runs.append(serve(torch, srv, NEW_TOKENS, f"{name} benign fault model", trace,
                      pin_at=2))
    same_runs(torch, traces["serial"], trace, f"{name} benign fault model", sim=True,
              what="run with the model == serial run without it")
    del srv, traces, trace
    released(torch)
    fault_runs, out["faults"] = fault_phases(torch, dev, cfg_b, wparams, net)
    return runs + fault_runs, out


def fault_phases(torch, dev, cfg, wparams, net) -> tuple[list, dict]:
    """The fault plane at full width, at the median threshold:

      * a link kill at split 18 (hop 0 down from fault step 4): every live
        row not exited at branch 9 is finalized from branch 18, the head at
        the cut; graphed against a ``graphs=False`` twin bitwise through
        the run, one sync per step, the degrade key captured once and then
        replayed, and each degraded row's token the argmax of head 18's
        logits (recorded from the twin's stacked projection);
      * split 8, below every branch: a kill fails the step with no dispatch,
        no fetch and no launch, and the scheduler reclaims every slot; with
        ``requeue_on_fail`` and a finite flap every request completes;
      * K=3 (the example's edge, mid, cloud) with the mid -> cloud hop
        killed: the breaker opens, the controller re-solves and the cut
        moves off the hop."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import FlapWindow, HopPolicy, LinkFaultModel, tiers

    name, out, runs = cfg.name, {}, []
    kill = LinkFaultModel(seed=0, flaps=(FlapWindow(hop=0, start_step=4,
                                                    end_step=10_000),))
    policy = HopPolicy(timeout_s=0.05, max_retries=1, backoff_s=0.001,
                       breaker_threshold=2, breaker_cooldown_steps=1000)
    traces, records = {}, []
    # The eager twin's stacked head projections, by step: (step, layers,
    # (K, B, V) logits); an overflow re-run's come last.
    rec = dict(trace=None)
    stacked = tiers.branch_logits_stacked

    def recording(params, got, cfg_, layers):
        ls, lg = stacked(params, got, cfg_, layers)
        if lg is not None and rec["trace"] is not None:
            records.append((len(rec["trace"]), tuple(ls), lg[:, :, 0].clone()))
        return ls, lg

    tiers.branch_logits_stacked = recording
    try:
        for graphs in (None, False):
            srv = server_at(cfg, wparams, KILL_SPLIT, dev, network=net,
                            simulate_network=True, fault_model=kill, hop_policy=policy,
                            graphs=graphs)
            trace = traces[graphs] = []
            rec["trace"] = trace if graphs is False else None
            label = f"{name} link kill at split {KILL_SPLIT}" + (
                ", eager twin" if graphs is False else "")
            run = serve(torch, srv, NEW_TOKENS, label, trace)
            statuses = sorted({r.status for r in srv.scheduler.results.values()})
            run["statuses"] = statuses
            if graphs is None:
                ex = srv.executor
                deg_keys = {k: n for k, n in ex.trace_counts.items()
                            if k[0] != "prefill" and k[0][6] is not None}
                deg_replays = sum(ex.replays.get(k, 0) for k in deg_keys)
                check(deg_keys and {k[0][6] for k in deg_keys} == {18}
                      and all(n == 1 for n in deg_keys.values()) and deg_replays > 0,
                      f"{label}: the degrade keys {sorted(deg_keys)} (fallback head 18) "
                      f"captured once each, then replayed {deg_replays} times")
                out["kill"] = dict(step_ms=run["decode_step_ms"],
                                   degraded_steps=ex.degraded_steps,
                                   fault_retries=ex.fault_retries, statuses=statuses)
            runs.append(run)
            del srv
            released(torch)
    finally:
        tiers.branch_logits_stacked = stacked
    same_runs(torch, traces[None], traces[False], f"{name} link kill")
    degraded = [(i, r.tier_result) for i, (r, *_) in enumerate(traces[False])
                if r.tier_result.degraded_hop is not None]
    check(len(degraded) == NEW_TOKENS - 4 and all(
        syncs == 1 + retries for _, _, syncs, retries in traces[None]),
          f"{name} link kill: {len(degraded)} degraded steps (fault steps 4 on), one "
          f"host sync per step plus re-runs")
    forced = 0
    for i, res in degraded:
        ls, lg = [(ls, lg) for step, ls, lg in records if step == i and 18 in ls][-1]
        want = lg[ls.index(18)].argmax(-1).to(torch.int32).cpu().numpy()
        rows = res.degraded
        forced += int(rows.sum())
        ok = (np.array_equal(res.tokens[rows], want[rows])
              and (res.exit_tier[rows] == 0).all()
              and not any((t & rows).any() for t in res.branch_take.values()))
        check(ok, f"{name} link kill, step {i}: the {int(rows.sum())} degraded rows "
              f"emit head 18's argmax (torch.argmax over its logits), exit tier 0, "
              f"no branch take")
    out["kill"]["forced_rows"] = forced
    check(forced > 0 and set(out["kill"]["statuses"]) <= {"ok", "degraded"},
          f"{name} link kill: {forced} rows forced through head 18; every request "
          f"completed ({out['kill']['statuses']})")
    del traces, records
    released(torch)

    # Split 8: no exit head below the hop.
    flat = HopPolicy(timeout_s=0.05, max_retries=0, breaker_threshold=100)
    srv = server_at(cfg, wparams, NO_HEAD_SPLIT, dev, network=net, simulate_network=True,
                    fault_model=LinkFaultModel(seed=0, flaps=(FlapWindow(0, 2, 10_000),)),
                    hop_policy=flat)
    ex, sched = srv.executor, srv.scheduler
    for p in prompts(cfg):
        srv.submit(p, NEW_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launches()
    failed_steps = []
    while sched.queue or sched.active.any():
        before = (ex.host_syncs, dict(ex.trace_counts), sum(ex.replays.values()),
                  dict(ops.launches))
        rep = srv.run(max_steps=1)[0]
        if rep.failed:
            failed_steps.append((ex.host_syncs, dict(ex.trace_counts),
                                 sum(ex.replays.values()), dict(ops.launches)) == before)
    torch.cuda.synchronize()
    runs.append(dict(label=f"{name} no head below the hop", launches=dict(ops.launches)))
    results = list(sched.results.values())
    check(failed_steps and all(failed_steps)
          and all(r.done and r.status == "failed" and len(r.tokens) == 2 for r in results)
          and not sched.active.any() and all(r is None for r in sched._slot_req),
          f"{name} split {NO_HEAD_SPLIT}: {len(failed_steps)} failed step(s) with no "
          f"sync, no capture, no replay and no launch; all {len(results)} requests "
          f"retired failed after 2 tokens; every slot reclaimed")
    del srv, ex, sched
    released(torch)
    from repro_torch.serving import RequestScheduler

    srv = server_at(cfg, wparams, NO_HEAD_SPLIT, dev, network=net, simulate_network=True,
                    fault_model=LinkFaultModel(seed=0, flaps=(FlapWindow(0, 2, 5),)),
                    hop_policy=flat)
    sched = RequestScheduler(srv, SLOTS, CONTEXT, requeue_on_fail=True, max_requeues=8)
    for p in prompts(cfg):
        sched.submit(p, NEW_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launches()
    reps = sched.run()
    torch.cuda.synchronize()
    runs.append(dict(label=f"{name} requeue after a finite flap",
                     launches=dict(ops.launches)))
    results = [sched.results[r] for r in sorted(sched.results)]
    check(any(r.failed for r in reps) and all(
        r.done and r.status == "ok" and len(r.tokens) == NEW_TOKENS for r in results),
          f"{name} split {NO_HEAD_SPLIT}, flap over fault steps 2-4 with requeue_on_fail: "
          f"{sum(bool(r.failed) for r in reps)} failed step(s), then all "
          f"{len(results)} requests completed with {NEW_TOKENS} tokens")
    out["no_head"] = dict(failed_steps=len(failed_steps),
                          requeue_failed_steps=sum(bool(r.failed) for r in reps))
    del srv, sched, reps
    released(torch)
    k3_runs, out["controller"] = controller_fault_phase(torch, dev, cfg, wparams)
    return runs + k3_runs, out


def controller_fault_phase(torch, dev, cfg, wparams) -> tuple[list, dict]:
    """K=3 on the example's fault fleet at cuts (10, 20) (branch 9 on the
    edge, 18 on the mid tier), the mid -> cloud hop down from fault step 3:
    retries exhaust, the breaker opens, the rows finalize from head 18, and
    the ``RepartitionController`` on the scheduler's ``on_step`` hook
    re-solves with the hop's availability at 0, so the new cuts ship
    nothing across it."""
    import numpy as np

    from repro_torch.core import LayerCost, TierSpec, build_cost_profile
    from repro_torch.kernels import ops
    from repro_torch.serving import (
        FlapWindow,
        HopPolicy,
        LinkFaultModel,
        MultiTierServer,
        RepartitionController,
        RequestScheduler,
    )

    n = cfg.num_layers
    tiers = [TierSpec(*t) for t in FAULT_TIERS]
    # The example's uniform cost stub.
    costs = [LayerCost(f"block{i}", 0, 0, cfg.d_model * 2.0, 1.5e-3)
             for i in range(1, n + 1)]
    prof = build_cost_profile(costs, cfg.branch_layers, np.zeros(len(cfg.branch_layers)),
                              "3g", GAMMA, RAW_INPUT_BYTES)
    # The deadline admits the full batch's 8 x 8192 B on the 5.85 Mb/s hop
    # (90 ms) when it is up.
    srv = MultiTierServer(
        cfg, wparams, tiers, (10, 20), simulate_network=True, device=dev,
        slots=SLOTS, context_len=CONTEXT,
        fault_model=LinkFaultModel(seed=0, flaps=(FlapWindow(1, 3, 10_000),)),
        hop_policy=HopPolicy(timeout_s=0.2, max_retries=1, backoff_s=0.002,
                             breaker_threshold=2))
    ctl = RepartitionController(srv, prof, tiers=list(tiers))
    sched = RequestScheduler(srv, SLOTS, CONTEXT, on_step=[ctl.observe])
    for p in prompts(cfg):
        sched.submit(p, NEW_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launches()
    reps = sched.run()
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    events = [e.kind for r in reps for e in r.server_report.fault_events]
    results = [sched.results[r] for r in sorted(sched.results)]
    check("breaker_open" in events and ctl.fault_resolves >= 1 and srv.cuts[1] == n
          and srv.tiers[1].availability == 0.0
          and all(r.done and len(r.tokens) == NEW_TOKENS for r in results),
          f"{cfg.name} K=3 fault fleet: hop mid->cloud killed at fault step 3, the "
          f"breaker opened, the controller re-solved {ctl.fault_resolves} time(s) and "
          f"moved the cuts (10, 20) -> {srv.cuts}; all {len(results)} requests "
          f"completed ({sum(r.degraded_tokens for r in results)} tokens degraded)")
    out = dict(cuts=list(srv.cuts), fault_resolves=ctl.fault_resolves,
               hop_health={str(k): v for k, v in ctl.hop_health().items()},
               degraded_tokens=sum(r.degraded_tokens for r in results))
    del srv, ctl, sched, reps
    released(torch)
    return [dict(label=f"{cfg.name} K=3 fault fleet under the controller",
                 launches=launches)], out


def bf16_ulps(x, n: int = 8) -> float:
    """``n`` bf16 ulps at the scale (largest magnitude) of ``x``."""
    return n * 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


def top2_gap(x):
    """Each row's gap between its two largest values (numpy)."""
    top = x.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy()


def entropy_slope(torch, logits):
    """Each row's first-order sensitivity of the normalized entropy to a
    change of its logits: sum p |log p + H| / log V (numpy).  A row whose
    logits move by at most d moves its entropy by at most about d times
    this."""
    logp = torch.log_softmax(logits, dim=-1)
    pr = logp.exp()
    h_nats = -(pr * logp).sum(-1, keepdim=True)
    return ((pr * (logp + h_nats).abs()).sum(-1) / math.log(logits.shape[-1])).cpu().numpy()


#: One full-width DeepSeek-V3 MLA layer: a 128-token prompt into a latent
#: ring of 4096 slots, then 16 absorbed decode steps.
MLA_PROMPT, MLA_STEPS = PROMPT, 16


def mla_layer_phase(torch, dev) -> dict:
    """One DeepSeek-V3 MLA layer at its published width in bf16, seeded
    weights, 8 rows: each absorbed decode step
    (``mla_apply`` with the latent ring: W_uk folded into the query,
    scores and the latent read-out in fp32) against the naive expanded
    form on the same ring — per-head K = [latent W_uk, shared RoPE key]
    and V = latent W_uv over the positions written so far, through
    ``prefill_attention`` with the queries of every position, its last
    row — within 8 bf16 ulps at the output's scale (the two forms round
    to bf16 at different points: q W_uk against latent W_uk, the fp32
    read-out against bf16 V).  Logs the ring's bytes per slot against a
    GQA ring of the same heads, and both forms' device time at the last
    step."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.layers import dense
    from repro_torch.models.transformer import BlockKind, layer_slice, stack_init

    cfg = get_config("deepseek_v3_671b")
    bf = torch.bfloat16
    h, hd, r, rk = cfg.num_heads, cfg.head_dim, cfg.mla_rope_dim, cfg.mla_kv_rank
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    p = layer_slice(stack_init(cfg, BlockKind("mla", "dense"), 1, gen, dev, bf), 0)["attn"]
    n_all = MLA_PROMPT + MLA_STEPS
    x = torch.randn((SLOTS, n_all, cfg.d_model), generator=gen, device=dev).to(bf)
    pos_all = torch.arange(n_all, dtype=torch.int32, device=dev)
    cache = A.init_mla_cache(SLOTS, CONTEXT, cfg, bf, dev)
    slot_bytes = sum(cache[k][0, 0].numel() * cache[k].element_size()
                     for k in ("ckv", "k_rope"))
    gqa_bytes = 2 * h * hd * 2
    log(f"mla layer: {cfg.name} d {cfg.d_model}, {h} heads of {hd}, q_rank "
        f"{cfg.mla_q_rank}, kv_rank {rk}, rope {r}, bf16; {SLOTS} rows, prompt "
        f"{MLA_PROMPT}, ring {CONTEXT} slots; {slot_bytes} B a slot against "
        f"{gqa_bytes} B for a GQA ring of {h} K/V heads of {hd} ({gqa_bytes / slot_bytes:.1f}x)")
    scale = 1.0 / math.sqrt(hd + r)

    def naive(n):
        """The naive form's output at position n - 1 over ring slots 0..n-1."""
        q_nope, q_rope = A._mla_qkr(p, x[:, :n], cfg, pos_all[:n])
        ckv, kr = cache["ckv"][:, :n], cache["k_rope"][:, :n]
        k = torch.cat([dense(p["wk_b"], ckv, bf).reshape(SLOTS, n, h, hd),
                       kr[:, :, None].expand(SLOTS, n, h, r)], dim=-1)
        v = dense(p["wv_b"], ckv, bf).reshape(SLOTS, n, h, hd)
        q = torch.cat([q_nope, q_rope], dim=-1).reshape(SLOTS, n, h, 1, hd + r)
        out = A.prefill_attention(q, k, v, pos_all[:n], scale=scale)[:, -1:]
        return dense(p["wo"], out.reshape(SLOTS, 1, h * hd), bf)

    ratios = []  # (|d| / bound, |d|, bound) per decode step
    with torch.no_grad():
        A.mla_apply(p, x[:, :MLA_PROMPT], cfg, pos_all[:MLA_PROMPT], cache)
        check(bool((cache["pos"][:, :MLA_PROMPT] == pos_all[:MLA_PROMPT]).all())
              and bool((cache["pos"][:, MLA_PROMPT:] == -1).all()),
              f"mla layer: the prompt's {MLA_PROMPT} positions fill slots 0..{MLA_PROMPT - 1}")
        for t in range(MLA_PROMPT, n_all):
            y, _ = A.mla_apply(p, x[:, t:t + 1], cfg, pos_all[t:t + 1], cache)
            want = naive(t + 1)
            d = float((y.float() - want.float()).abs().max())
            if not bool(torch.isfinite(y).all()):
                d = math.inf
            ratios.append((d / bf16_ulps(want), d, bf16_ulps(want)))
        top, worst, tol = max(ratios)
        check(top <= 1.0,
              f"mla layer: at each of the {MLA_STEPS} decode steps the absorbed "
              f"output within 8 bf16 ulps at its scale of the naive form (worst "
              f"|d| {worst:.4g} against {tol:.4g}, {top:.3f} of its bound)")
        check(int(cache["length"]) == n_all and bool((cache["pos"][:, :n_all] == pos_all).all()),
              f"mla layer: {MLA_STEPS} decode steps wrote slots {MLA_PROMPT}..{n_all - 1}")
        # Both forms' device time at the last position, on a copy of the
        # ring so the timed writes land where they already did.
        ring = {k: v.clone() for k, v in cache.items()}

        def absorbed_step():
            ring["length"].fill_(n_all - 1)
            A.mla_apply(p, x[:, -1:], cfg, pos_all[-1:], ring)

        absorbed_ms, src, _ = device_ms(absorbed_step)
        naive_ms, _, _ = device_ms(lambda: naive(n_all))
    log(f"  mla layer: absorbed decode {absorbed_ms:.4f} ms a step on the device "
        f"({src}; plain PyTorch, fp32 scores over all {CONTEXT} slots), naive form "
        f"{naive_ms:.4f} ms over {n_all} positions")
    del p, cache, ring
    released(torch)
    return dict(arch=cfg.name, ring_bytes_per_slot=slot_bytes,
                gqa_ring_bytes_per_slot=gqa_bytes, steps=MLA_STEPS,
                absorbed_vs_naive_max_abs=worst, bound=tol, worst_share_of_bound=top,
                absorbed_decode_ms=absorbed_ms, naive_ms=naive_ms)


def engine_twins(torch, dev, cfg, params, inputs: dict, want_pos: int, steps: int
                 ) -> tuple[dict, dict]:
    """A K=1 ``ServingEngine`` (all branch heads in one exit launch) on
    ``inputs``: ``start`` on a graphed kernel engine, its eager twin and an
    eager plain engine (``use_kernels=False``), each ``pos`` == ``want_pos``;
    then ``steps`` decode steps on the graphed engine and its eager twin,
    held bitwise (tokens, exit masks, entropies, logits), the first step
    also against the plain engine (logits within 8 bf16 ulps of their
    scale, branch entropies within 1e-5 + 2 x each row's first-order
    bound, exit masks equal off the threshold's edge, tokens equal away
    from near-ties); the graphed run launches the exit kernel once a step
    for all heads and ``flash_decode`` in every layer.  The engines after
    the first share its compute copies of ``params``.  Returns (the
    graphed run's record, {"weights": those compute copies, "results":
    the graphed steps' results, "start_s", "start_peak_gb", and the first
    step's kernel-vs-plain differences}); the engines are released."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine, tiers

    name, thr = cfg.name, cfg.exit_threshold
    engines = {"graphed": ServingEngine(cfg, params, context_len=CONTEXT, device=dev)}
    weights = engines["graphed"].params
    engines["eager"] = ServingEngine(cfg, weights, context_len=CONTEXT, device=dev,
                                     graphs=False)
    engines["plain"] = ServingEngine(cfg, weights, context_len=CONTEXT, device=dev,
                                     use_kernels=False, graphs=False)
    ex = {k: e.executor for k, e in engines.items()}
    check(ex["graphed"].use_kernels and ex["graphed"].graphs and ex["eager"].use_kernels
          and not ex["eager"].graphs and not ex["plain"].use_kernels,
          f"{name}: a graphed kernel engine, its eager twin and an eager plain engine")
    states, start_s = {}, {}
    released(torch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for k, e in engines.items():
        ts = time.perf_counter()
        states[k] = e.start(inputs)
        torch.cuda.synchronize()
        start_s[k] = time.perf_counter() - ts
        if k == "graphed":
            start_peak = torch.cuda.max_memory_allocated() - held
    check(all(st["pos"] == want_pos and int(st["caches"]["length"]) == want_pos
              for st in states.values()),
          f"{name}: start's pos = {want_pos} = {[st['pos'] for st in states.values()]}, "
          "cache length too")
    check(all(states[k]["last_logits"].equal(states["plain"]["last_logits"])
              for k in ("graphed", "eager")),
          f"{name}: the three engines' prefill logits bitwise equal (a dense prefill "
          "runs no kernel)")
    tok = states["plain"]["last_logits"].argmax(-1).to(torch.int32)[:, None]

    stacked, branch = tiers.branch_logits_stacked, {}

    def decode(key, n, tok):
        """n steps of one engine; the eager engines' first step records its
        stacked branch logits (K, B, V)."""
        e, st, out, step_s = engines[key], states[key], [], []

        def recording(params_, got, cfg_, layers):
            ls, lg = stacked(params_, got, cfg_, layers)
            if lg is not None:
                branch[key] = lg[:, :, 0].float().clone()
            return ls, lg

        for i in range(n):
            if i == 0 and not e.executor.graphs:
                tiers.branch_logits_stacked = recording
            ts = time.perf_counter()
            try:
                res, st["caches"] = e.step(tok, st["pos"], st["caches"])
            finally:
                tiers.branch_logits_stacked = stacked
            step_s.append(time.perf_counter() - ts)
            st["pos"] += 1
            out.append(res)
            tok = res.tokens_dev[:, None]
        return out, step_s

    # First step: kernel path (the eager twin) against the plain path.
    (pe,), _ = decode("plain", 1, tok)
    kres, eager_s = decode("eager", steps, tok)
    ke = kres[0]
    vocab = cfg.vocab_size
    kl, pl = ke.last_logits[:, :vocab].float(), pe.last_logits[:, :vocab].float()
    scale, tol = float(pl.abs().max()), bf16_ulps(pl)
    dlog = float((kl - pl).abs().max())
    check(dlog <= tol, f"{name} first step: max |d logit| kernel vs plain {dlog:.4g} <= "
          f"{tol:.4g} (8 bf16 ulps at the logits' scale {scale:.3f})")
    # The branch heads (all in the engine's one stack): logits within 8 bf16
    # ulps of their scale; entropies within 1e-5 + 2 x each row's
    # first-order bound, max |d logit| x sum p |log p + H| / log V (from the
    # plain logits), as the train_branchy twin holds them: at V = 128,256
    # and logits of scale ~9 a flat 1e-4 is below what the logits' own
    # difference moves the entropy.
    bk, bp = branch["eager"], branch["plain"]
    dz = (bk - bp).abs().amax(dim=-1)  # (K, B)
    check(float(dz.max()) <= bf16_ulps(bp), f"{name} first step: branch logits kernel "
          f"vs plain {float(dz.max()):.4g} <= {bf16_ulps(bp):.4g} (8 bf16 ulps of their "
          "scale)")
    allowed = 1e-5 + 2 * entropy_slope(torch, bp) * dz.cpu().numpy()
    straddle = np.zeros(N_REQ, bool)
    dh, worst_ratio = 0.0, 0.0
    for j, layer in enumerate(cfg.branch_layers):
        ek, ep = ke.branch_entropy[layer], pe.branch_entropy[layer]
        d = np.abs(ek - ep)
        dh = max(dh, float(d.max()))
        worst_ratio = max(worst_ratio, float((d / allowed[j]).max()))
        straddle |= (ek < thr) != (ep < thr)
    check(worst_ratio <= 1.0, f"{name} first step: branch |dH| kernel vs plain (max "
          f"{dh:.3g}) within 1e-5 + 2 x each row's first-order bound on every row "
          f"(worst at {worst_ratio:.3f} of its bound)")
    check(np.array_equal(ke.exited[~straddle], pe.exited[~straddle]),
          f"{name} first step: exit masks equal off the threshold's edge (rows at the "
          f"edge: {straddle.nonzero()[0].tolist()})")
    tie = top2_gap(pl) <= 2 * dlog
    stay = ~ke.exited & ~pe.exited & ~straddle
    check(np.array_equal(ke.tokens[stay & ~tie], pe.tokens[stay & ~tie]),
          f"{name} first step: main-head tokens equal on rows that stay, away from "
          f"near-ties (near-tie rows {tie.nonzero()[0].tolist()})")
    # The graphed engine, counted: the same steps from the same prompt state.
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    gres, graphed_s = decode("graphed", steps, tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    first = None
    for i, (g, e) in enumerate(zip(gres, kres)):
        if not (np.array_equal(g.tokens, e.tokens) and np.array_equal(g.exited, e.exited)
                and all(np.array_equal(g.branch_entropy[l], e.branch_entropy[l])
                        for l in cfg.branch_layers)
                and g.last_logits.equal(e.last_logits)) and first is None:
            first = i
    check(first is None, f"{name}: graphed engine == eager twin bitwise on all "
          f"{steps} steps (tokens, exit masks, entropies, logits; first difference "
          f"at step {first})")
    check(states["graphed"]["pos"] == want_pos + steps,
          f"{name}: pos {states['graphed']['pos']} after {steps} steps")
    check(ex["graphed"].host_syncs == steps,
          f"{name}: the graphed engine made one host sync a step "
          f"({ex['graphed'].host_syncs} in {steps} steps)")
    check(launches["entropy_exit_argmax_heads"] == steps
          and launches["entropy_exit_argmax"] == 0
          and launches["flash_decode"] == steps * cfg.num_layers,
          f"{name}: the graphed run launched the exit kernel once a step for all "
          f"{len(cfg.branch_layers)} heads and flash_decode in every layer "
          f"({ {k: v for k, v in launches.items() if v} })")
    check(all(bool(torch.isfinite(g.last_logits).all()) for g in gres)
          and all(0 <= t < vocab for g in gres for t in g.tokens),
          f"{name}: every step's logits finite, every token inside the vocabulary")
    step_ms = statistics.median(graphed_s[1:]) * 1e3
    eager_ms = statistics.median(eager_s[1:]) * 1e3
    log(f"  {name}: start {start_s['graphed']:.3f} s for {N_REQ} x {want_pos} positions "
        f"(eager twin {start_s['eager']:.3f} s, plain {start_s['plain']:.3f} s), peak "
        f"{start_peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB held before; decode step "
        f"{step_ms:.3f} ms graphed / {eager_ms:.3f} ms eager (host clock, median of "
        f"steps 2-{steps}); {N_REQ * steps / wall:.1f} tokens/s graphed; max "
        f"|d logit| {dlog:.4g}, |dH| {dh:.3g}")
    run = dict(label=f"{name} K=1 engine", launches=launches, decode_steps=steps,
               decode_step_ms=step_ms, eager_decode_step_ms=eager_ms,
               start_s=start_s["graphed"], start_s_all=start_s,
               start_peak_gb=start_peak / 1e9, tokens_per_s=N_REQ * steps / wall)
    info = dict(weights=weights, results=gres, first_step_max_dlogit=dlog,
                first_step_dlogit_bound=tol, first_step_max_dh=dh)
    del engines, ex, states, kres, ke, pe
    released(torch)
    return run, info


#: InternVL2-76B's language trunk at full width, its depth cut from 80 to
#: 16 layers (70.6 B params would be 141 GB in bf16), branches at the
#: quarter points of the cut trunk, as the reference's sit at 20, 40, 60.
VLM_LAYERS, VLM_BRANCHES, VLM_STEPS = 16, (4, 8, 12), 16


def vlm_phase(torch, dev) -> dict:
    """InternVL2 on the K=1 ``ServingEngine`` at full width, 16 layers:
    ``start`` on 8 prompts of 1,024 patch embeddings (a seeded
    ``torch.Generator``) and 128 tokens, ``pos`` = 1,152; then 16 decode
    steps (:func:`engine_twins`: graphed == eager bitwise, the first step
    against a plain engine); the exit kernel at K = 3, V = 128,256 and
    ``flash_decode`` at Kh = 8, G = 8."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config("internvl2_76b"), num_layers=VLM_LAYERS,
                              branch_layers=VLM_BRANCHES)
    name = cfg.name
    check(cfg.param_dtype == "bfloat16" and cfg.frontend == "vision"
          and cfg.num_patches == 1024,
          f"{name}: the published config's bf16 params and 1,024-patch vision prompts")
    log(f"vlm engine: {name} at full width (d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads, {cfg.num_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), depth cut to {cfg.num_layers} of 80 layers, branches "
        f"{cfg.branch_layers}, K=1 engine, {N_REQ} prompts of {cfg.num_patches} patches "
        f"+ {PROMPT} tokens, {CONTEXT} slots each")
    released(torch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_tensors(params))
    init_peak = torch.cuda.max_memory_allocated() - held
    log(f"  init_params: {nbytes / 1e9:.2f} GB of bf16 params ({nbytes // 2 / 1e9:.2f} B), "
        f"peak {init_peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB held before, "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (N_REQ, PROMPT)).astype(np.int32)
    patches = torch.randn((N_REQ, cfg.num_patches, cfg.d_model), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 8))
    want = cfg.num_patches + PROMPT
    check(want == 1152, f"{name}: start counts the patches: pos = {cfg.num_patches} + "
          f"{PROMPT} = {want}")
    run, info = engine_twins(torch, dev, cfg, params,
                             {"tokens": tokens, "patch_embeds": patches}, want, VLM_STEPS)
    first = {k: info[k] for k in ("first_step_max_dlogit", "first_step_dlogit_bound",
                                  "first_step_max_dh")}
    del params, patches, info
    released(torch)
    return dict(arch="internvl2_76b", runs=[run], pos=want, layers=cfg.num_layers,
                **first, init_params_gb=nbytes / 1e9, init_params_peak_gb=init_peak / 1e9,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)


#: Whisper-medium at its published width and depth (24 encoder and 24
#: decoder layers); the K=2 split after decoder layer 18, where its third
#: branch sits (discarded at the cut: the edge decides branches 6 and 12 in
#: one launch).  Its vocabulary before the padding to 51,968.
WHISPER_SPLIT, WHISPER_STEPS, WHISPER_VOCAB = 18, 16, 51865


def whisper_phase(torch, dev) -> dict:
    """Whisper-medium at full width and depth, fp32 params as the config
    sets them, 8 prompts of 128 tokens, each with 1,500 frame embeddings
    from a seeded ``torch.Generator``, 4,096 slots each.

    1. The K=1 ``ServingEngine`` (branches 6, 12, 18 in one exit launch,
       :func:`engine_twins`): ``start`` (the encoder, every decoder layer's
       cross K/V, the decoder prefill; ``pos`` = 128, the frames take no
       decoder position) logged as the path's TTFT with its peak memory;
       16 steps graphed == eager bitwise, the first against a plain engine.
    2. The K=2 ``PartitionedServer`` at split 18, prefilled with
       ``models.model.prefill`` and stepped with ``server.step`` (the
       scheduler refuses an audio trunk, as the reference's does), at
       threshold 0.5 and at a mixed threshold (the median over the K=1
       engine's steps and rows of the smaller edge entropy), ``hint_window``
       1 so that the cloud's buckets follow its survivors and gather their
       cross K/V rows, the hints
       pinned to 1 before the third step (a forced overflow re-run): graphed
       == eager twin bitwise, one host sync a step plus one per re-run,
       ``flash_decode`` 24 times and the exit kernel once per dispatch, no
       key captured twice; each run's device ms a step and idle share from
       three profiled steps.
    3. The 24 decoder layers profiled in measure mode (:func:`profile_phase`,
       CUDA-graph replays over caches that hold the cross K/V), then the
       split solved once for 4g from that profile and the K=1 engine's exit
       probabilities at the mixed threshold."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.calibration import calibrate_exit_probs
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_caches, init_params, prefill

    cfg = get_config("whisper_medium")
    name = cfg.name
    check(cfg.arch_type == "audio" and cfg.param_dtype == "float32"
          and cfg.padded_vocab_size == 51968 and cfg.vocab_size == WHISPER_VOCAB
          and (cfg.num_layers, cfg.num_encoder_layers, cfg.encoder_seq_len) == (24, 24, 1500),
          f"{name}: the published config (24 + 24 layers, 1,500 frames, fp32 params, "
          f"vocabulary {cfg.vocab_size} padded to {cfg.padded_vocab_size})")
    log(f"whisper: {name} at full width and depth (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff} GELU, "
        f"{cfg.num_encoder_layers} encoder + {cfg.num_layers} decoder layers, vocab "
        f"{cfg.vocab_size} padded to {cfg.padded_vocab_size}), branches "
        f"{cfg.branch_layers}, {N_REQ} prompts of {PROMPT} tokens + "
        f"{cfg.encoder_seq_len} frames, {CONTEXT} slots each")
    released(torch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_tensors(params))
    init_peak = torch.cuda.max_memory_allocated() - held
    log(f"  init_params: {n_params * 4 / 1e9:.3f} GB of fp32 params "
        f"({n_params / 1e6:.1f} M), peak {init_peak / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB held before, {time.perf_counter() - t0:.1f} s")
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (N_REQ, PROMPT)).astype(np.int32)
    frames = torch.randn((N_REQ, cfg.encoder_seq_len, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 16))
    caches = init_caches(cfg, N_REQ, CONTEXT, device=dev)
    ring = sum(t.numel() * t.element_size() for t in tree_tensors(caches["blocks"]))
    cross = sum(t.numel() * t.element_size() for t in caches["cross_kv"])
    log(f"  caches: self-attention rings {ring / 1e9:.3f} GB, cross K/V {cross / 1e9:.3f} GB")
    del caches

    # 1. The K=1 engine.
    k1, info = engine_twins(torch, dev, cfg, params,
                            {"tokens": tokens, "frame_embeds": frames}, PROMPT,
                            WHISPER_STEPS)
    wparams = info["weights"]  # bf16 compute copies; every later server shares them
    del params
    released(torch)
    ents = np.stack([np.stack([r.branch_entropy[l] for l in cfg.branch_layers])
                     for r in info["results"]], axis=1).reshape(len(cfg.branch_layers), -1)
    # The mixed threshold: the median, over the K=1 engine's 16 steps x 8
    # rows, of each row's smaller edge entropy (branches 6 and 12), so that
    # about half the rows leave on the edge at each step and the rest reach
    # the cloud.  The edge entropies of random weights sit within ~1e-3 of
    # each other: at step 0's median of branch 6 every row cleared branch
    # 12 at every step, and at step 0's median of the smaller one only 8 of
    # 128 rows left.
    mixed = float(np.median(np.minimum(ents[1], ents[0])))
    p_k = calibrate_exit_probs(ents, mixed).conditional_p
    log(f"  K=1 engine entropies at the mixed threshold {mixed:.6f} (the median of "
        f"min(branch 6, branch 12) over {WHISPER_STEPS} steps): conditional p_k "
        f"{[float(x) for x in p_k]}")

    # 2. The K=2 server at split 18.
    toks = torch.as_tensor(tokens, device=dev).long()
    runs = [k1]
    for thr in (0.5, mixed):
        cfg_t = dataclasses.replace(cfg, exit_threshold=thr)
        label = f"{name} K=2 split {WHISPER_SPLIT} threshold {thr:.6g}"
        traces = {}
        for graphs in (True, False):
            srv = server_at(cfg_t, wparams, WHISPER_SPLIT, dev, graphs=graphs,
                            hint_window=1)
            ex = srv.executor
            check(ex.segments[0].branches == (6, 12) and ex.graphs == graphs,
                  f"{label}: the edge decides branches 6 and 12 (18 at the cut)")
            state = {"caches": init_caches(cfg_t, N_REQ, CONTEXT, device=dev),
                     "pos": PROMPT}
            lg, state["caches"] = prefill(ex.params, toks, cfg_t, state["caches"],
                                          frame_embeds=frames, use_kernels=ex.use_kernels)
            state["tok"] = lg[:, 0].argmax(-1).to(torch.int32)[:, None]
            trace, counts0 = [], dict(ex.trace_counts)

            def step(state=state, srv=srv, trace=None):
                ex_ = srv.executor
                syncs, retries = ex_.host_syncs, ex_.overflow_retries
                ts = time.perf_counter()
                rep, state["caches"] = srv.step(state["tok"], state["pos"], state["caches"])
                if trace is not None:
                    trace.append((rep, time.perf_counter() - ts, ex_.host_syncs - syncs,
                                  ex_.overflow_retries - retries))
                state["pos"] += 1
                state["tok"] = rep.tier_result.tokens_dev[:, None]
                return rep

            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            for i in range(WHISPER_STEPS):
                if i == 2:  # a forced overflow re-run where more than one row survives
                    ex._hints = {1: 1}
                step(trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.launches)
            retries = sum(t[3] for t in trace)
            dispatches = WHISPER_STEPS + retries
            check(all(t[2] == 1 + t[3] for t in trace),
                  f"{label} ({'graphed' if graphs else 'eager'}): one host sync a step "
                  f"plus one per overflow re-run ({retries} re-runs in "
                  f"{WHISPER_STEPS} steps)")
            check(launches["flash_decode"] == cfg.num_layers * dispatches
                  and launches["entropy_exit_argmax_heads"] == dispatches
                  and launches["entropy_exit_argmax"] == 0,
                  f"{label}: flash_decode {cfg.num_layers} times and the exit kernel "
                  f"once per dispatch ({dispatches}: {WHISPER_STEPS} steps + {retries} "
                  f"re-runs; { {k: v for k, v in launches.items() if v} })")
            captured = {k: n - counts0.get(k, 0) for k, n in ex.trace_counts.items()
                        if n != counts0.get(k, 0)}
            if graphs:
                check(all(n == 1 for n in captured.values()),
                      f"{label}: no key captured twice in the run ({len(captured)} "
                      "captured)")
            last = trace[-1][0].tier_result.last_logits
            check(bool(torch.isfinite(last).all())
                  and all(0 <= t < cfg.vocab_size for r in trace for t in r[0].tokens),
                  f"{label}: final logits finite, every token inside the vocabulary")
            buckets = sorted({c.bucket for r in trace for c in r[0].compaction})
            run = dict(label=f"{label} {'graphed' if graphs else 'eager'}", graphs=graphs,
                       launches=launches, decode_steps=WHISPER_STEPS,
                       decode_step_ms=statistics.median(t[1] for t in trace[3:]) * 1e3,
                       tokens_per_s=N_REQ * WHISPER_STEPS / wall, cloud_buckets=buckets,
                       overflow_retries=retries,
                       exits=int(sum(r[0].exited_on_edge.sum() for r in trace)))
            prof_launches = dict(ops.launches)
            run["profile"] = profile_window(
                torch, ex, run["label"], lambda: None,
                lambda: [step() for _ in range(3)], lambda: None, 3)
            run["launches"] = {k: v + ops.launches[k] - prof_launches[k]
                               for k, v in run["launches"].items()}
            run["device_idle_share"] = 1 - (run["profile"]["device_ms_per_step"]
                                            / run["decode_step_ms"])
            log(f"  {run['label']}: {json.dumps(run)}")
            runs.append(run)
            traces[graphs] = trace
            del srv, ex, state, lg
            released(torch)
        same_runs(torch, traces[True], traces[False], label)
    check(all(any(1 < b < N_REQ for b in r["cloud_buckets"])
              and 0 < r["exits"] < N_REQ * WHISPER_STEPS for r in runs[-2:]),
          f"{name} at the mixed threshold: rows exited on the edge ({runs[-1]['exits']} "
          f"of {N_REQ * WHISPER_STEPS}) and the cloud ran compacted buckets of "
          f"survivors {runs[-1]['cloud_buckets']}")

    # 3. Measure-mode profile of the decoder layers, then one solve.
    measured, prof_runs, summary = profile_phase(torch, cfg, wparams, name)
    solved = solve_phase(torch, dev, dataclasses.replace(cfg, exit_threshold=mixed),
                         measured, p_k, ("4g",))
    runs += prof_runs
    out = dict(arch="whisper_medium", runs=runs, layers=cfg.num_layers,
               params_m=n_params / 1e6, init_params_peak_gb=init_peak / 1e9,
               ring_gb=ring / 1e9, cross_kv_gb=cross / 1e9, mixed_threshold=mixed,
               p_k=[float(x) for x in p_k], profile=summary,
               solved_4g=solved["4g"]["plan"].split_layer,
               **{k: info[k] for k in ("first_step_max_dlogit", "first_step_dlogit_bound",
                                       "first_step_max_dh")},
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del wparams, info, frames, measured
    released(torch)
    return out


# ------------------------------------------------------------ sharded tiers
#: The sharded phase: Qwen3-8B's K=2 server at split 20 (edge branches 9
#: and 18, as its end-to-end path), its 8 prompts of 128 tokens and 16 new
#: tokens, on two ranks of one (1, 2) mesh that share the one card.
SHARD_ARCH, SHARD_SPLIT, SHARD_RANKS = "qwen3_8b", 20, 2
SHARD_DEVICES = (1, 2, 4, 8)  # the shard widths the analyze mode prices
#: Logits (the main head's and the edge branches') are held to 8 bf16
#: ulps at their scale (bf16_ulps); each branch entropy to a flat |dH|
#: bound, about 4x the largest difference measured on the card (1.13e-4,
#: with every sharded product in fp32), well inside the spread of the
#: random weights' entropies, so that a wrong entropy fails it.
SHARD_DH_TOL = 5e-4
#: The duck-typed meshes of the policy walk: one 8-card node, and the
#: reference's 16 x 16.
SHARD_WALK = (("model 8", {"model": 8}), ("data 16 x model 16", {"data": 16, "model": 16}))
CARD_BYTES = 80e9


class FakeMesh:
    """A mesh as the policy reads it: axis sizes only."""

    def __init__(self, axes: dict):
        self.shape = dict(axes)


def shard_price_phase(torch, dev, cfg, wparams) -> dict:
    """Part 1: what a sharded tier costs the solver, at full width.  The
    analyze mode at each shard width against t_c(1) / d + collective, the
    measure mode at d = 4 (the plain path, which a sharded segment runs)
    beside d = 1 (the kernels), and the K=2 split solved with the cloud as
    one card and as four over NVLink."""
    import numpy as np

    from repro_torch.core import build_cost_profile, solve_multitier
    from repro_torch.core import profiler as TP
    from repro_torch.models.model import init_caches, prefill

    hw = TP.H100_SXM
    an = {}
    for d in SHARD_DEVICES:
        t0 = time.perf_counter()
        an[d] = TP.profile_decode_layers(cfg, wparams, SLOTS, CONTEXT, mode="analyze",
                                         devices=d)
        log(f"  analyze devices={d}: sum t_c {sum(c.time_s for c in an[d]) * 1e3:.4f} ms "
            f"over {len(an[d])} layers (layer 1 {an[d][0].time_s * 1e6:.3f} us; "
            f"{time.perf_counter() - t0:.1f} s)")
    worst = 0.0
    for d in SHARD_DEVICES[1:]:
        for o, t in zip(an[1], an[d]):
            want = o.time_s / d + hw.collective_time(o.output_bytes, d)
            worst = max(worst, abs(t.time_s - want) / want)
    check(worst <= 1e-12, f"analyze t_c(d) == t_c(1) / d + collective_time(alpha, d) for "
          f"d in {SHARD_DEVICES[1:]} (worst relative gap {worst:.3g} <= 1e-12)")
    meas = {}
    for d in (1, 4):
        t0 = time.perf_counter()
        meas[d] = TP.profile_decode_layers(cfg, wparams, SLOTS, CONTEXT, mode="measure",
                                           devices=d)
        log(f"  measure devices={d} ({'kernels' if d == 1 else 'plain path, undivided'}, "
            f"CUDA-graph replays): sum t_c {sum(c.time_s for c in meas[d]) * 1e3:.4f} ms, "
            f"median layer {statistics.median(c.time_s for c in meas[d]) * 1e3:.5f} ms "
            f"({time.perf_counter() - t0:.1f} s)")
        check(all(c.time_s > 0 for c in meas[d]), f"measure devices={d}: every t_c > 0")
    ici = hw.link_bw * 8.0
    p_k = [0.25] * len(cfg.branch_layers)
    prof = build_cost_profile(meas[1], cfg.branch_layers, p_k, "4g", gamma=GAMMA,
                              raw_input_bytes=RAW_INPUT_BYTES)
    from repro_torch.serving import PartitionedServer

    toks = torch.as_tensor(np.stack(prompts(cfg)), device=dev).long()
    solved = {}
    for td in ((1, 1), (1, 4)):
        srv = PartitionedServer(cfg, wparams, SHARD_SPLIT, device=dev, cost_profile=prof,
                                tier_devices=td, ici_bps=ici, graphs=False)
        plan = solve_multitier(prof.t_c, prof.alpha, prof.branch_exit_probs(),
                               srv.tier_specs(prof), batch=SLOTS)
        srv.set_split(plan.cut_after[0])
        caches = init_caches(cfg, SLOTS, CONTEXT, device=dev)
        lg, caches = prefill(srv.params, toks, cfg, caches)
        rep, caches = srv.step(lg[:, 0].argmax(-1).to(torch.int32)[:, None], PROMPT, caches)
        solved[str(td)] = dict(split=srv.split_layer, plan_s=plan.expected_time_s,
                               est_latency_s=rep.est_latency_s)
        log(f"  tier_devices {td} at ici {ici:.4g} bit/s (H100_SXM.link_bw x 8), 4g uplink, "
            f"gamma {GAMMA:g}, p_k {p_k}: split {srv.split_layer}, plan "
            f"{plan.expected_time_s * 1e3:.4f} ms, est_latency_s of a served step "
            f"{rep.est_latency_s * 1e3:.4f} ms")
        del srv, caches, lg
    log(f"  the cut with the cloud as four cards: {solved['(1, 1)']['split']} -> "
        f"{solved['(1, 4)']['split']}")
    released(torch)
    return dict(analyze_sum_ms={d: sum(c.time_s for c in an[d]) * 1e3 for d in an},
                measure_sum_ms={d: sum(c.time_s for c in meas[d]) * 1e3 for d in meas},
                worst_gap=worst, solved=solved)


def policy_walk_phase(torch) -> dict:
    """Part 2: the policy over every configuration at full published size,
    a walk over meta tensors (nothing allocated): per card, the largest
    param bytes in bf16 (and in the params' own dtypes, ``param_bytes``)
    and the cache bytes at 8 slots x 4096; the leaves
    left replicated; every leaf sharded or replicated by a rule (each
    sharded dim divisible by its axes); and whether it fits one card at
    model = 8."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.sharding.policy import (
        ShardingPolicy,
        cache_shapes,
        param_shapes,
        tree_paths,
    )

    held = torch.cuda.memory_allocated()
    uneven: list = []

    def per_card(spec, shape, axes) -> int:
        n = math.prod(shape)
        for d, e in enumerate(spec):
            if e is None:
                continue
            size = math.prod(axes[a] for a in ((e,) if isinstance(e, str) else e))
            if shape[d] % size:
                uneven.append((tuple(shape), d, e))
            n //= size
        return n

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = list(tree_paths(param_shapes(cfg)))
        caches = list(tree_paths(cache_shapes(cfg, SLOTS, CONTEXT)))
        check(all(t.is_meta for _, t in params + caches), f"{arch}: the walk holds no memory")
        row = {}
        for label, axes in SHARD_WALK:
            pol = ShardingPolicy(FakeMesh(axes), cfg,
                                 tuple(a for a in ("pod", "data") if a in axes))
            pspecs = [(pol.param_spec(p, t.shape), t) for p, t in params]
            pbytes = sum(per_card(s, t.shape, axes) * 2 for s, t in pspecs)
            native = sum(per_card(s, t.shape, axes) * t.element_size() for s, t in pspecs)
            cbytes = sum(per_card(pol.cache_spec(p, t.shape), t.shape, axes) * t.element_size()
                         for p, t in caches)
            repl = sum(all(e is None for e in s) for s, _ in pspecs)
            row[label] = dict(param_gb=pbytes / 1e9, param_bytes=native,
                              cache_gb=cbytes / 1e9, replicated=repl,
                              leaves=len(pspecs), fits=pbytes + cbytes <= CARD_BYTES)
        check(not uneven, f"{arch}: every leaf sharded evenly or replicated by a rule "
              f"({len(params) + len(caches)} leaves on each mesh; uneven: {uneven})")
        m8 = row["model 8"]
        log(f"  {arch}: per card at model 8 {m8['param_gb']:.3f} GB params (bf16) + "
            f"{m8['cache_gb']:.3f} GB cache, {m8['replicated']} of {m8['leaves']} leaves "
            f"replicated, fits 80 GB: {m8['fits']}; at data 16 x model 16 "
            f"{row['data 16 x model 16']['param_gb']:.3f} GB + "
            f"{row['data 16 x model 16']['cache_gb']:.3f} GB, "
            f"{row['data 16 x model 16']['replicated']} replicated")
        out[arch] = row
    check(torch.cuda.memory_allocated() == held, "the policy walk allocated no device memory")
    check(not out["deepseek_v3_671b"]["model 8"]["fits"],
          "DeepSeek-V3 does not fit 80 GB per card at model 8")
    return out


class BranchLogits:
    """While active, ``tiers.branch_logits_stacked`` also keeps the last
    stacked (K, B, V) branch logits it made, whole and on the host (a
    sharded call gathers them, on every rank alike)."""

    def __init__(self):
        from repro_torch.serving import tiers

        self.tiers, self.stacked, self.last = tiers, tiers.branch_logits_stacked, None

    def __enter__(self):
        from repro_torch.sharding.ctx import plain

        def recording(params_, got, cfg_, layers):
            ls, lg = self.stacked(params_, got, cfg_, layers)
            if lg is not None:
                self.last = plain(lg[:, :, 0]).float().cpu().numpy()
            return ls, lg

        self.tiers.branch_logits_stacked = recording
        return self

    def __exit__(self, *exc):
        self.tiers.branch_logits_stacked = self.stacked


def shard_baseline(torch, dev, cfg, wparams, thr: float) -> dict:
    """The unsharded K=2 server, eager on the plain path (what a sharded
    segment runs), fed its own greedy tokens: its inputs, outputs, exit
    masks, shipped counts, edge entropies, main and branch logits on the
    host."""
    import numpy as np

    from repro_torch.models.model import init_caches, prefill
    from repro_torch.serving import PartitionedServer

    c = dataclasses.replace(cfg, exit_threshold=thr)
    srv = PartitionedServer(c, wparams, SHARD_SPLIT, device=dev, graphs=False,
                            use_kernels=False)
    caches = init_caches(c, SLOTS, CONTEXT, device=dev)
    toks = torch.as_tensor(np.stack(prompts(cfg)), device=dev).long()
    lg, caches = prefill(srv.params, toks, c, caches)
    tok = lg[:, 0].argmax(-1).to(torch.int32)
    rec = dict(pre=lg[:, 0, :cfg.vocab_size].float().cpu().numpy(), inputs=[], tokens=[],
               exited=[], take=[], shipped=[], ents=[], logits=[], branch=[], ms=[])
    with BranchLogits() as bl:
        for i in range(NEW_TOKENS):
            rec["inputs"].append(tok.cpu().numpy())
            t0 = time.perf_counter()
            rep, caches = srv.step(tok[:, None], PROMPT + i, caches)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            _shard_record(rec, rep, cfg, bl.last)
            tok = rep.tier_result.tokens_dev
    del srv, caches
    return rec


def _shard_record(rec, rep, cfg, branch) -> None:
    """One step's report; with ``branch`` (the step's (K, B, V) branch
    logits) also the main head's and the branches' logits."""
    rec["tokens"].append(rep.tokens.copy())
    rec["exited"].append(rep.exited_on_edge.copy())
    rec["take"].append({l: m.copy() for l, m in rep.branch_take.items()})
    rec["shipped"].append(rep.shipped)
    rec["ents"].append({l: e.copy() for l, e in rep.tier_result.branch_entropy.items()})
    if branch is not None:
        rec["logits"].append(rep.tier_result.last_logits[:, :cfg.vocab_size].float()
                             .cpu().numpy())
        rec["branch"].append(branch[:, :, :cfg.vocab_size])


def shard_rank(cfg_fields: dict, thresholds, inputs, spill: str) -> dict:
    """One rank of the two-rank server (run by ``RankPool``): the same seeded
    params as the baseline's, sharded over a (1, 2) mesh with the full
    copy dropped, then each threshold's 8 prompts and 16 steps fed the
    baseline's inputs.  The collectives gloo's CUDA path does not carry
    move through host tensors (``stage_through_host``).  Rank 0 writes its
    logits under ``spill`` (one .npz a threshold; through the pipe they
    took ~90 s on the card's host)."""
    wall_in = time.time()
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.launch.mesh import make_local_mesh, stage_through_host
    from repro_torch.models.model import init_caches, init_params, prefill
    from repro_torch.serving import PartitionedServer
    from repro_torch.sharding.ctx import plain
    from repro_torch.sharding.policy import tree_paths

    t_in = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    staged = stage_through_host()
    kernel_ops.reset_launches()
    cfg = ModelConfig(**cfg_fields)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    secs = {"draw": time.perf_counter() - t0}
    t0 = time.perf_counter()
    mesh = make_local_mesh()
    first = PartitionedServer(cfg, params, SHARD_SPLIT, device=dev, mesh=mesh)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    secs["shard"] = time.perf_counter() - t0
    leaves = [t for _, t in tree_paths(first.params)]
    local_bytes = sum(t.to_local().numel() * t.element_size() for t in leaves)
    shard_leaves = sum(any(p.is_shard() for p in t.placements) for t in leaves)
    ex = first.executor
    out = dict(rank=rank, staged=staged, params_gb=local_bytes / 1e9, secs=secs,
               shard_leaves=shard_leaves, leaves=len(leaves), use_kernels=ex.use_kernels,
               graphs=ex.graphs, mesh=str(mesh), runs=[])
    toks = torch.as_tensor(np.stack(prompts(cfg)), device=dev).long()
    for thr, forced in zip(thresholds, inputs):
        c = dataclasses.replace(cfg, exit_threshold=thr)
        srv = PartitionedServer(c, first.params, SHARD_SPLIT, device=dev, mesh=mesh)
        caches = srv.executor.shard_caches(init_caches(c, SLOTS, CONTEXT, device=dev))
        out["cache_gb"] = sum(t.to_local().numel() * t.element_size()
                              for _, t in tree_paths(caches)) / 1e9
        t0 = time.perf_counter()
        with srv.executor.mesh_context():
            lg, caches = prefill(srv.params, toks, c, caches)
            pre = plain(lg[:, 0, :cfg.vocab_size]).float().cpu().numpy()
        secs[f"prefill {thr:.6g}"] = time.perf_counter() - t0
        rec = dict(pre=pre if rank == 0 else None, tokens=[], exited=[], take=[],
                   shipped=[], ents=[], logits=[], branch=[], ms=[])
        syncs0, retries0 = srv.executor.host_syncs, srv.executor.overflow_retries
        for i, tok in enumerate(forced):
            with BranchLogits() as bl:  # gathers on every rank: a collective
                t0 = time.perf_counter()
                rep, caches = srv.step(torch.as_tensor(tok[:, None], device=dev),
                                       PROMPT + i, caches)
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
            _shard_record(rec, rep, cfg, bl.last if rank == 0 else None)
        rec["syncs"] = srv.executor.host_syncs - syncs0
        rec["retries"] = srv.executor.overflow_retries - retries0
        if rank == 0:
            np.savez(os.path.join(spill, f"{len(out['runs'])}.npz"),
                     logits=np.stack(rec.pop("logits")), branch=np.stack(rec.pop("branch")))
        rec["buckets"] = [h.bucket for h in rep.compaction]
        out["runs"].append(rec)
        del srv, caches
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = dict(kernel_ops.launches)
    secs["total"] = time.perf_counter() - t_in
    out["wall"] = (wall_in, time.time())
    return out


def shard_compare(torch, base: dict, got: dict, thr: float, label: str) -> dict:
    """Step by step against the baseline: the main head's and the edge
    branches' logits within 8 bf16 ulps of their scale; each branch
    entropy within SHARD_DH_TOL; tokens equal on the rows whose top-2 gap
    exceeds twice their measured |d logit| (no flip possible); in each run,
    every branch's take the first entropy below the threshold, so that the
    exit masks are a function of the entropies and equal exactly on the
    rows whose every entropy sits on the same side of the threshold in
    both runs; shipped counts equal where no mask differs.  Each check
    fails when it covers nothing."""
    import numpy as np

    tol = bf16_ulps(torch.from_numpy(np.stack(base["logits"])))
    btol = bf16_ulps(torch.from_numpy(np.stack(base["branch"])))
    dpre = float(np.abs(got["pre"] - base["pre"]).max())
    check(dpre <= tol, f"{label}: admission max |d logit| {dpre:.4g} <= {tol:.4g}")
    worst_l = worst_b = worst_h = 0.0
    checked_tok = checked_mask = checked_ship = same_tok = masks_differ = 0
    layers = sorted(base["ents"][0])
    below = np.float32(thr)  # the exit test: fp32 entropy < threshold

    def gap(x):
        top = np.sort(x, axis=-1)[..., -2:]
        return top[..., 1] - top[..., 0]

    for i in range(len(base["tokens"])):
        # The main head's logits count on the rows both runs sent to the
        # cloud: an exited row's are zero, or a padding row's of a bucket.
        bl, gl = base["logits"][i], got["logits"][i]
        dz = np.abs(gl - bl).max(axis=-1)
        ran = ~base["exited"][i] & ~got["exited"][i]
        worst_l = max(worst_l, float(dz[ran].max(initial=0.0)))
        bb, gb = base["branch"][i], got["branch"][i]  # (K, B, V), K = len(layers)
        dzb = np.abs(gb - bb).max(axis=-1)
        worst_b = max(worst_b, float(dzb.max()))
        # Each row's token comes from the head that decided it (the branch
        # it exited at, or the main head) when both runs agree on the head;
        # it cannot flip where that head's top-2 gap exceeds twice its
        # measured |d logit|.
        g, d = gap(bl), dz
        agree = ran.copy()
        for k, layer in enumerate(layers):
            both = base["take"][i][layer] & got["take"][i][layer]
            g, d = np.where(both, gap(bb[k]), g), np.where(both, dzb[k], d)
            agree |= both
        clear = agree & (g > 2 * d)
        checked_tok += int(clear.sum())
        same_tok += int((got["tokens"][i] == base["tokens"][i]).sum())
        check(bool((got["tokens"][i] == base["tokens"][i])[clear].all()),
              f"{label} step {i}: tokens equal on the {int(clear.sum())} rows that cannot "
              f"flip ({got['tokens'][i].tolist()} vs {base['tokens'][i].tolist()})")
        for name, run in (("baseline", base), ("sharded", got)):
            taken = np.zeros(len(bl), bool)
            for layer in layers:
                want = (run["ents"][i][layer] < below) & ~taken
                check(bool((run["take"][i][layer] == want).all()),
                      f"{label} step {i}: the {name} run's branch {layer} takes the rows "
                      "whose entropy is first below the threshold")
                taken |= want
            check(bool((run["exited"][i] == taken).all()),
                  f"{label} step {i}: the {name} run's exits are its branches' takes")
        same_side = np.ones(len(bl), bool)
        for layer in layers:
            e, ge = base["ents"][i][layer], got["ents"][i][layer]
            worst_h = max(worst_h, float(np.abs(ge - e).max()))
            same_side &= (e < below) == (ge < below)
        checked_mask += int(same_side.sum())
        same = got["exited"][i] == base["exited"][i]
        masks_differ += int((~same).sum())
        check(bool(same[same_side].all()), f"{label} step {i}: exit masks equal on the "
              f"{int(same_side.sum())} rows whose entropies sit on the same side of the "
              "threshold in both runs")
        for layer, m in base["take"][i].items():
            check(bool((got["take"][i][layer] == m)[same_side].all()),
                  f"{label} step {i}: branch {layer}'s takes equal on those rows")
        if same.all():
            checked_ship += 1
            check(got["shipped"][i] == base["shipped"][i],
                  f"{label} step {i}: shipped {got['shipped'][i]} == {base['shipped'][i]}")
    check(worst_l <= tol, f"{label}: main head max |d logit| {worst_l:.4g} <= {tol:.4g} "
          "(8 bf16 ulps at the logits' scale; rows both runs sent to the cloud)")
    check(worst_b <= btol, f"{label}: branch max |d logit| {worst_b:.4g} <= {btol:.4g}")
    check(worst_h <= SHARD_DH_TOL, f"{label}: every branch |dH| {worst_h:.3g} <= "
          f"{SHARD_DH_TOL:g}")
    check(checked_tok > 0 and checked_mask > 0 and checked_ship > 0,
          f"{label}: every check covered something (tokens on {checked_tok} rows, exit "
          f"masks on {checked_mask} rows, shipped counts on {checked_ship} steps)")
    return dict(max_dlogit=worst_l, logit_tol=tol, max_branch_dlogit=worst_b,
                branch_tol=btol, max_dh=worst_h, dh_tol=SHARD_DH_TOL, dpre=dpre,
                tokens_checked=checked_tok, tokens_equal=same_tok,
                masks_checked=checked_mask, masks_differ=masks_differ,
                shipped_checked=checked_ship,
                exits=int(sum(e.sum() for e in base["exited"])),
                shipped=[int(s) for s in base["shipped"]])


def sharded_phase(torch, dev, smi: str) -> dict:
    """Mesh-sharded tiers: the price, the policy walk, and a sharded K=2
    Qwen3-8B served by two ranks that share this one card over gloo."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import RankPool
    from repro_torch.models.model import init_params

    log(f"sharded: {smi}")
    released(torch)
    cfg = get_config(SHARD_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wparams = init_params(cfg, gen, dev)
    log(f"  {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads / "
        f"{cfg.num_kv_heads} KV of {cfg.head_dim}, vocab {cfg.vocab_size}, params "
        f"{cfg.param_dtype}, {SLOTS} slots x {CONTEXT}")
    price = shard_price_phase(torch, dev, cfg, wparams)
    stamp("sharded: the price of a sharded tier done")
    walk = policy_walk_phase(torch)
    stamp("sharded: the policy walk done")
    base = {0.5: shard_baseline(torch, dev, cfg, wparams, 0.5)}
    median = float(np.median(base[0.5]["ents"][0][cfg.branch_layers[0]]))
    base[median] = shard_baseline(torch, dev, cfg, wparams, median)
    del wparams
    released(torch)
    for thr, b in base.items():
        log(f"  unsharded baseline at {thr:.6g} (eager, plain path): exits "
            f"{int(sum(e.sum() for e in b['exited']))} of {SLOTS * NEW_TOKENS}, shipped "
            f"{b['shipped']}, step ms median {statistics.median(b['ms'][1:]):.3f}")
    stamp("sharded: baselines done; the ranks start")
    t0 = time.perf_counter()
    spill = tempfile.mkdtemp(prefix="sharded-")
    try:
        with RankPool(SHARD_RANKS, device="cuda", threads=4, timeout_s=300.0) as pool:
            t1, w1 = time.perf_counter(), time.time()
            ranks = pool.run(shard_rank, dataclasses.asdict(cfg), list(base),
                             [b["inputs"] for b in base.values()], spill)
            t2, w2 = time.perf_counter(), time.time()
        for j, run in enumerate(ranks[0]["runs"]):
            with np.load(os.path.join(spill, f"{j}.npz")) as z:
                run["logits"], run["branch"] = list(z["logits"]), list(z["branch"])
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    log(f"  two ranks: {time.perf_counter() - t0:.1f} s from start to stop (start "
        f"{t1 - t0:.1f} s, the runs {t2 - t1:.1f} s; on each rank, the call entered "
        f"{[round(r['wall'][0] - w1, 1) for r in ranks]} s after it was sent, ran "
        f"{[round(r['secs']['total'], 1) for r in ranks]} s after its imports, and "
        f"returned {[round(w2 - r['wall'][1], 1) for r in ranks]} s before it was read)")
    out = dict(price=price, walk=walk, thresholds=list(base), ranks=[], runs=[])
    for r in ranks:
        check(r["use_kernels"] is False and r["graphs"] is False,
              f"rank {r['rank']}: the sharded executor resolved kernels and graphs off")
        check(r["shard_leaves"] > 0, f"rank {r['rank']}: {r['shard_leaves']} of {r['leaves']} "
              "param leaves Shard-placed")
        check(not any(r["launches"].values()), f"rank {r['rank']}: no kernel launched on "
              f"the sharded path ({r['launches']})")
        for thr, run in zip(base, r["runs"]):
            check(run["syncs"] == NEW_TOKENS + run["retries"],
                  f"rank {r['rank']} at {thr:.6g}: {run['syncs']} host syncs for "
                  f"{NEW_TOKENS} steps and {run['retries']} re-runs")
        log(f"  rank {r['rank']} ({r['mesh']}): params {r['params_gb']:.3f} GB and KV "
            f"{r['cache_gb']:.3f} GB on this rank, peak {r['peak_gb']:.3f} GB; collectives "
            f"moved through the host: {list(r['staged']) or 'none'}; seconds "
            f"{ {k: round(v, 2) for k, v in r['secs'].items()} }, first steps ms "
            f"{[round(run['ms'][0], 1) for run in r['runs']]}")
        out["ranks"].append({k: v for k, v in r.items() if k != "runs"})
    for thr, run, b in zip(base, ranks[0]["runs"], base.values()):
        for r in ranks[1:]:
            other = r["runs"][list(base).index(thr)]
            check(all((a == o).all() for a, o in zip(run["tokens"], other["tokens"])),
                  f"at {thr:.6g}: every rank reports the same tokens")
        cmp = shard_compare(torch, b, run, thr, f"sharded K=2 at {thr:.6g}")
        ms = [statistics.median(r["runs"][list(base).index(thr)]["ms"][1:]) for r in ranks]
        cmp.update(thr=thr, step_ms_by_rank=ms, buckets=run["buckets"],
                   baseline_step_ms=statistics.median(b["ms"][1:]))
        log(f"  at threshold {thr:.6g}: max |d logit| {cmp['max_dlogit']:.4g} (bound "
            f"{cmp['logit_tol']:.4g}), branches {cmp['max_branch_dlogit']:.4g} (bound "
            f"{cmp['branch_tol']:.4g}), max |dH| {cmp['max_dh']:.3g} (bound "
            f"{cmp['dh_tol']:g}), admission |d logit| {cmp['dpre']:.4g}, tokens equal "
            f"{cmp['tokens_equal']} / {SLOTS * NEW_TOKENS} ({cmp['tokens_checked']} that "
            f"cannot flip, checked), exit masks differing {cmp['masks_differ']} of "
            f"{SLOTS * NEW_TOKENS} ({cmp['masks_checked']} rows on the same side of the "
            f"threshold in both runs, checked), shipped counts checked on "
            f"{cmp['shipped_checked']} of {NEW_TOKENS} steps, exits {cmp['exits']}, "
            f"last buckets {run['buckets']}; step ms (two ranks sharing one H100 over gloo, "
            f"not a two-card time) {[round(m, 3) for m in ms]}, the unsharded eager "
            f"baseline's {cmp['baseline_step_ms']:.3f} [{smi}]")
        out["runs"].append(cmp)
    return out


# ------------------------------------------------------------- launch layer
#: The dry run's cells on the card: every
#: configuration at decode_32k, two trainers and one prefill, and the one
#: combination the reference skips.
DRYRUN_MORE = (("olmo_1b", "train_4k"), ("qwen3_8b", "train_4k"),
               ("qwen3_8b", "prefill_32k"), ("whisper_medium", "long_500k"))
DRYRUN_SKIPPED = ("whisper_medium", "long_500k")
DRYRUN_LONGEST = ("qwen3_8b", "train_4k")
DRYRUN_RANKS = 256
#: How long the phase waits for the dry run's processes once the sharded
#: phases are done (they started before them).
DRYRUN_WAIT_S = 600.0


def dryrun_cells() -> list:
    from repro_torch.configs import ARCH_IDS

    return [(a, "decode_32k") for a in ARCH_IDS] + list(DRYRUN_MORE)


def dryrun_worker(out_dir: str, summary: str, cells: list) -> None:
    """Dry-run ``cells`` in a process of its own (see :func:`start_dryrun`):
    each record under ``out_dir``, and per cell the seconds it took, whether
    a process group was left behind, and whether this process touched the
    card (``torch.cuda.is_initialized()``, ``memory_allocated()``), into
    the JSON file ``summary``."""
    os.nice(10)
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.dryrun import run_one

    torch.set_num_threads(1)
    rows = []
    Path(summary).write_text("[]")
    for arch, shape in cells:
        t0 = time.perf_counter()
        rec = run_one(arch, shape, False, out_dir=Path(out_dir), force=True)
        rows.append(dict(arch=arch, shape=shape, status=rec["status"],
                         secs=time.perf_counter() - t0, group_left=dist.is_initialized(),
                         cuda_initialized=torch.cuda.is_initialized(),
                         cuda_allocated=torch.cuda.memory_allocated()))
        Path(summary).write_text(json.dumps(rows))


def start_dryrun():
    """Start the dry run (4f) beside the sharded phases, in two spawned
    processes at a lower priority: the longest cell (Qwen3-8B's train step,
    ~150 s of one core) in one, the rest in the other.  It is host work
    only (DTensors over ``meta`` shards, a fake process group): nothing of
    the card.  It starts after the phases that time the card against the
    host clock (a busy host left gaps between graph replays).  Returns
    [(the process, its summary file)] and the records' directory."""
    import multiprocessing as mp

    from repro_torch.launch.dryrun import RESULTS_DIR

    out_dir = RESULTS_DIR / "chip_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cells = dryrun_cells()
    groups = [[c for c in cells if c == DRYRUN_LONGEST],
              [c for c in cells if c != DRYRUN_LONGEST]]
    procs = []
    for i, group in enumerate(groups):
        summary = out_dir / f"cells{i}.json"
        proc = mp.get_context("spawn").Process(target=dryrun_worker, daemon=True,
                                               args=(str(out_dir), str(summary), group))
        proc.start()
        procs.append((proc, summary))
    return procs, out_dir


def dryrun_phase(torch, smi: str, walk: dict, started) -> dict:
    """The dry run on the production (16, 16) mesh (see the module doc, 4f):
    waits for :func:`start_dryrun`'s process and checks its records.
    ``walk``: :func:`policy_walk_phase`'s rows."""
    from repro_torch.configs import INPUT_SHAPES

    procs, out_dir = started
    log(f"dryrun: {smi}")
    t0 = time.perf_counter()
    rows = []
    for proc, summary in procs:
        proc.join(max(DRYRUN_WAIT_S - (time.perf_counter() - t0), 1.0))
        if proc.is_alive():
            proc.kill()
            proc.join()
        check(proc.exitcode == 0, f"dryrun: a worker process exited 0 (exit code "
              f"{proc.exitcode}; waited {time.perf_counter() - t0:.1f} s)")
        rows += json.loads(summary.read_text())
    waited = time.perf_counter() - t0
    check(len(rows) == len(dryrun_cells()), f"dryrun: all {len(dryrun_cells())} cells ran "
          f"(waited {waited:.1f} s for the workers)")
    out = {"waited_s": waited}
    for row in rows:
        arch, shape = row["arch"], row["shape"]
        rec = json.loads((out_dir / f"{arch}__{shape}__pod16x16.json").read_text())
        check(not row["group_left"], f"dryrun {arch} {shape}: no process group left")
        check(not row["cuda_initialized"] and row["cuda_allocated"] == 0,
              f"dryrun {arch} {shape}: the card untouched (no CUDA context, "
              f"memory_allocated {row['cuda_allocated']})")
        if (arch, shape) == DRYRUN_SKIPPED:
            check(rec["status"] == "skipped", f"dryrun {arch} {shape}: skipped "
                  f"({rec.get('reason', rec['status'])})")
            log(f"  {arch} {shape}: skipped ({rec['reason'][:80]}...)")
            out[f"{arch} {shape}"] = dict(status="skipped")
            continue
        if rec["status"] != "ok":
            log(rec.get("trace", ""))
        check(rec["status"] == "ok", f"dryrun {arch} {shape}: ok ({rec.get('error', '')})")
        mem = rec["memory"]
        want = walk[arch]["data 16 x model 16"]["param_bytes"]
        check(mem["param_bytes"] == want, f"dryrun {arch} {shape}: per-device param bytes "
              f"{mem['param_bytes']} == the policy walk's {want}")
        sh = INPUT_SHAPES[shape]
        tokens = sh.global_batch * (1 if sh.is_decode else sh.seq_len)
        model = (6 if sh.kind == "train" else 2) * rec["active_params"] * tokens
        coll = {k: v for k, v in rec["collectives"].items() if k != "_counts" and v}
        log(f"  {arch} {shape} ({row['secs']:.1f} s, trace {rec['trace_s']} s): arguments "
            f"{mem['argument_bytes'] / 1e9:.3f} GB (params {mem['param_bytes'] / 1e9:.3f}), "
            f"eager peak {mem['peak_bytes_est'] / 1e9:.3f} GB per device; dot FLOPs x "
            f"{DRYRUN_RANKS} {rec['dot_flops'] * DRYRUN_RANKS:.4g} beside "
            f"{6 if sh.kind == 'train' else 2} x active params x tokens {model:.4g}; HBM "
            f"proxy {rec['hbm_bytes'] / 1e9:.3f} GB; collectives (GB per device) "
            f"{ {k: round(v / 1e9, 4) for k, v in coll.items()} }, counts "
            f"{ {k: v for k, v in rec['collectives']['_counts'].items() if v} }")
        out[f"{arch} {shape}"] = dict(
            secs=row["secs"], trace_s=rec["trace_s"], memory=mem, dot_flops=rec["dot_flops"],
            model_flops=model, hbm_bytes=rec["hbm_bytes"], collectives=rec["collectives"])
    return out


#: The sharded train phase: OLMo-1B at full width and depth, 3 AdamW steps
#: of 4 x 256 tokens at accum 1 and 2, on each mesh of two ranks sharing
#: the card.  Params in bf16 (fp32 moments): on the (2, 1) mesh each rank
#: holds the whole state, and the config's fp32 params with their AdamW
#: step (~38 GB a rank at its peak: state, gradients, their clipped copy
#: and the new state) would not fit twice on one card.
STRAIN_ARCH, STRAIN_BATCH, STRAIN_SEQ, STRAIN_STEPS = "olmo_1b", 4, 256, 3
STRAIN_MESHES, STRAIN_ACCUMS = ((1, 2), (2, 1)), (1, 2)
#: Bounds against the unsharded run (PERF.md gives the reasons):
#: the loss to 2e-3 relative (about half a bf16 ulp of each activation,
#: which a mean over 1,024 tokens does not exceed); grad_norm to 1e-2
#: relative (the bf16 backward through 16 layers); every param entry to
#: 2.02 x the summed learning rate of the steps (Adam's update of an entry
#: whose gradient sits in the rounding noise may take either sign, and
#: |m_hat / sqrt(v_hat)| <= 1.001 over 3 steps at b1 0.9, b2 0.95 by
#: Cauchy-Schwarz: at most 1.001 lr a step each way) plus one bf16 ulp of
#: the entry a step (each step rounds the new param to bf16, and two
#: updates a hair apart may round to neighbours).
STRAIN_LOSS_TOL, STRAIN_NORM_TOL, STRAIN_PARAM_FACTOR = 2e-3, 1e-2, 2.02
#: AdamW's moments, leaf by leaf on each rank's shard, against the
#: unsharded run's: max |dm| / the leaf's largest |m| and ||dm|| / ||m||
#: (the same for v) to 0.1.  The param bound above cannot fail (Adam moves
#: an entry by at most ~lr a step whatever its gradient, and is blind to a
#: gradient's scale); the moments carry the gradients.  Sound runs read at
#: most 0.0286 (v, max-based) and 0.0201 (norm-based); a rank's share of a
#: gradient lost or counted twice moves a leaf's m by ~0.5 of its scale.
STRAIN_MOMENT_TOL = 0.1


def strain_opt():
    from repro_torch.training.optimizer import make_optimizer

    return make_optimizer("adamw", lr=strain_lr())


def strain_lr():
    from repro_torch.training.optimizer import cosine_schedule

    return cosine_schedule(6e-4, warmup=0, total=STRAIN_STEPS)


def strain_lrs() -> list:
    """The learning rate of each step of the phase."""
    import torch

    return [strain_lr()(torch.tensor(i)) for i in range(STRAIN_STEPS)]


def strain_rank(cfg_fields: dict, spill: str) -> list:
    """One rank of the sharded train phase (run by ``RankPool``): for each
    mesh and accumulation, the seed-0 state placed by the policy, the
    seed-0 batch by its data spec, STRAIN_STEPS steps; each step's loss,
    grad_norm and ms, the optimizer state's placements, and the local
    shards of its params and AdamW moments against the unsharded run's
    (loaded from ``spill``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ModelConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.launch.mesh import make_local_mesh, stage_through_host
    from repro_torch.models.model import init_params
    from repro_torch.sharding.ctx import local_rows, mesh_context, plain
    from repro_torch.sharding.policy import (
        distribute,
        make_policy,
        placements,
        spec_at,
        tree_paths,
    )
    from repro_torch.training.train_loop import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    staged = stage_through_host()
    cfg = ModelConfig(**cfg_fields)
    opt = strain_opt()

    def shard(ref, t):  # this rank's part of the whole ``ref`` for ``t``
        idx = []
        for d in range(t.dim()):
            _, off = local_rows(t, d)
            idx.append(slice(off, off + t.to_local().shape[d]))
        return ref[tuple(idx)].to(dev).float()

    host = make_batch(cfg, STRAIN_BATCH, STRAIN_SEQ, seed=SEED)
    out = []
    for shape in STRAIN_MESHES:
        mesh = make_local_mesh(data=shape[0], model=shape[1], device="cuda")
        pol = make_policy(mesh, cfg)
        for accum in STRAIN_ACCUMS:
            kernel_ops.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            state = init_train_state(params, opt, policy=pol)
            del params
            torch.cuda.empty_cache()
            batch = {k: distribute(torch.from_numpy(a).to(dev), mesh,
                                   pol.data_spec(tuple(a.shape))) for k, a in host.items()}
            step = make_train_step(cfg, opt, accum=accum)
            losses, norms, ms = [], [], []
            for _ in range(STRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with mesh_context(pol.mesh, pol.batch_axes):
                    state, m = step(state, batch)
                losses.append(float(plain(m["loss"])))
                norms.append(float(plain(m["grad_norm"])))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            specs = pol.opt_state_shardings(state["params"], cfg.optimizer)
            misplaced = [p for p, t in tree_paths(state["opt"])
                         if list(t.placements) != placements(spec_at(specs, p), mesh)]
            base = torch.load(os.path.join(spill, f"{accum}.pt"), mmap=True)
            max_dp, max_excess, sq, n = 0.0, 0.0, 0.0, 0
            for p, t in tree_paths(state["params"]):
                loc = t.to_local()
                want = shard(base[p], t)
                diff = (loc.float() - want).abs()
                ulps = STRAIN_STEPS * BF16_ULP * torch.maximum(want.abs(), loc.float().abs())
                max_dp = max(max_dp, float(diff.max()))
                max_excess = max(max_excess, float((diff - ulps).max()))
                sq += float(diff.square().sum())
                n += diff.numel()
            # AdamW's moments, leaf by leaf: this rank's shard against the
            # unsharded run's, max |dm| over the leaf's largest |m| (and the
            # same for v), and ||dm|| / ||m|| over the shard.
            ref_opt = torch.load(os.path.join(spill, f"{accum}-opt.pt"), mmap=True)
            mom = {"m": [0.0, 0.0, ""], "v": [0.0, 0.0, ""]}
            for p, t in tree_paths(state["opt"]):
                want = shard(ref_opt["leaves"][p], t)
                diff = t.to_local().float() - want
                rel_max = float(diff.abs().max()) / (ref_opt["scale"][p] or 1.0)
                rel_norm = float(diff.norm()) / (float(want.norm()) or 1.0)
                w = mom[p.split("/")[0]]
                if rel_max > w[0]:
                    w[0], w[2] = rel_max, p
                w[1] = max(w[1], rel_norm)
            out.append(dict(rank=rank, mesh=shape, accum=accum, losses=losses, norms=norms,
                            ms=ms, peak_gb=peak_gb,
                            misplaced=misplaced, opt_leaves=len(list(tree_paths(state["opt"]))),
                            max_dp=max_dp, max_excess=max_excess,
                            rms_dp=math.sqrt(sq / n), moments=mom, staged=staged,
                            launches=dict(kernel_ops.launches)))
            del state, batch, base, ref_opt
            torch.cuda.empty_cache()
    return out


def sharded_train_phase(torch, dev, smi: str) -> dict:
    """Training under a mesh (see the module doc, 4g)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.ranks import RankPool
    from repro_torch.models.model import init_params
    from repro_torch.sharding.policy import tree_paths
    from repro_torch.training.train_loop import init_train_state, make_train_step

    log(f"sharded train: {smi}")
    released(torch)
    cfg = dataclasses.replace(get_config(STRAIN_ARCH), param_dtype="bfloat16")
    opt = strain_opt()
    param_tol = STRAIN_PARAM_FACTOR * sum(float(lr) for lr in strain_lrs())
    batch = {k: torch.from_numpy(a).to(dev)
             for k, a in make_batch(cfg, STRAIN_BATCH, STRAIN_SEQ, seed=SEED).items()}
    spill = tempfile.mkdtemp(prefix="strain-")
    base = {}
    try:
        for accum in STRAIN_ACCUMS:
            state = init_train_state(
                init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev), opt)
            step = make_train_step(cfg, opt, accum=accum)
            losses, norms, ms = [], [], []
            for _ in range(STRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            torch.save({p: t.cpu() for p, t in tree_paths(state["params"])},
                       os.path.join(spill, f"{accum}.pt"))
            # The moments in bf16 (half the spill; 2^-9 of an entry at most)
            # beside each leaf's largest |entry| in fp32.
            torch.save({"leaves": {p: t.to(torch.bfloat16).cpu()
                                   for p, t in tree_paths(state["opt"])},
                        "scale": {p: float(t.abs().max()) for p, t in tree_paths(state["opt"])}},
                       os.path.join(spill, f"{accum}-opt.pt"))
            base[accum] = dict(losses=losses, norms=norms, ms=ms)
            log(f"  unsharded accum {accum}: losses {[round(x, 6) for x in losses]}, "
                f"grad_norms {[round(x, 5) for x in norms]}, step ms "
                f"{[round(x, 1) for x in ms]}")
            del state, step
        del batch
        released(torch)
        stamp("sharded train: unsharded runs done and freed; the ranks start")
        t0 = time.perf_counter()
        # Two ranks that each hold the whole state (the (2, 1) mesh) share
        # the card: expandable segments keep a rank's freed blocks reusable
        # instead of ~2 GB of fragments each.
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            with RankPool(2, device="cuda", threads=4, timeout_s=600.0) as pool:
                ranks = pool.run(strain_rank, dataclasses.asdict(cfg), spill)
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    runs = []
    for r, results in enumerate(ranks):
        for res in results:
            b = base[res["accum"]]
            label = f"rank {r} mesh {res['mesh']} accum {res['accum']}"
            dl = max(abs(x - y) / abs(y) for x, y in zip(res["losses"], b["losses"]))
            dn = max(abs(x - y) / abs(y) for x, y in zip(res["norms"], b["norms"]))
            check(dl <= STRAIN_LOSS_TOL, f"{label}: losses {res['losses']} vs unsharded "
                  f"{b['losses']}, {dl:.3g} <= {STRAIN_LOSS_TOL} relative")
            check(dn <= STRAIN_NORM_TOL, f"{label}: grad_norms {res['norms']} vs unsharded "
                  f"{b['norms']}, {dn:.3g} <= {STRAIN_NORM_TOL} relative")
            check(res["max_excess"] <= param_tol, f"{label}: params after step {STRAIN_STEPS}: "
                  f"max |dp| - {STRAIN_STEPS} bf16 ulps {res['max_excess']:.3g} <= "
                  f"{STRAIN_PARAM_FACTOR} x summed lr {param_tol:.3g} (max |dp| "
                  f"{res['max_dp']:.3g}, rms {res['rms_dp']:.3g})")
            for key in ("m", "v"):
                worst, norm_rel, leaf = res["moments"][key]
                check(max(worst, norm_rel) <= STRAIN_MOMENT_TOL,
                      f"{label}: AdamW {key} after step {STRAIN_STEPS}, leaf by leaf: max "
                      f"|d{key}| / max |{key}| {worst:.3g} ({leaf}), ||d{key}|| / ||{key}|| "
                      f"{norm_rel:.3g} <= {STRAIN_MOMENT_TOL}")
            check(not res["misplaced"], f"{label}: every one of {res['opt_leaves']} optimizer-"
                  f"state leaves in its opt_state_shardings placement ({res['misplaced'][:3]})")
            check(not any(res["launches"].values()), f"{label}: no kernel launched "
                  f"({res['launches']})")
            mm, mv = res["moments"]["m"], res["moments"]["v"]
            log(f"  {label}: loss rel {dl:.3g}, grad_norm rel {dn:.3g}, max |dp| "
                f"{res['max_dp']:.3g} (rms {res['rms_dp']:.3g}), moments max |dm| / max |m| "
                f"{mm[0]:.3g} ({mm[2]}), ||dm|| / ||m|| {mm[1]:.3g}, max |dv| / max |v| "
                f"{mv[0]:.3g} ({mv[2]}), ||dv|| / ||v|| {mv[1]:.3g}, step ms "
                f"{[round(x, 1) for x in res['ms']]} (host clock, two ranks sharing one H100 "
                f"over gloo, not a two-card time), peak {res['peak_gb']:.2f} GB, collectives "
                f"moved through the host {list(res['staged'])}, launches 0 [{smi}]")
            runs.append(dict(res, loss_rel=dl, norm_rel=dn))
    log(f"  sharded train: the ranks took {secs:.1f} s from start to stop")
    return dict(base=base, runs=runs, param_tol=param_tol, ranks_s=secs)


def example_phase() -> dict:
    """``python -m repro_torch.examples.serve_partitioned`` on the card at
    its smoke size, in a process of its own: its own asserts (the breaker
    opens, the controller re-solves, the last cut moves to the trunk's
    end) must hold and it must exit 0."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.examples.serve_partitioned"],
                          env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-12:]:
        log(f"  | {line}")
    check(proc.returncode == 0, f"the serve_partitioned example exited "
          f"{proc.returncode} on the card in {secs:.1f} s")
    return dict(seconds=secs, returncode=proc.returncode)


# ---------------------------------------------------------------- phase 8
BF16_TFLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
#: Full-width trainers: (arch, the kernel-free path it exercises).
TRAINERS = (("olmo_1b", "dense attention backward, non-parametric LayerNorm, tied "
             "embedding, grad_accum 2"),
            ("zamba2_1_2b", "Mamba2 SSD backward (38 layers) and the shared attention "
             "block, grad_accum 4"))


def train_flops(cfg, tokens: int) -> tuple[float, float]:
    """(model FLOPs of one training step, the matmul params they count):
    6 x params x tokens over every matmul weight a token meets (trunk
    projections, the shared block once per site, the unembedding once per
    head: main + K branches), plus 12 x S x the attention width per token
    and attention layer (QK^T and PV, forward and backward, the full S x S
    product the port computes).  The SSD scan's own products are left out."""
    d, v, k = cfg.d_model, cfg.padded_vocab_size, len(cfg.branch_layers)
    attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
    mlp = 3 * d * cfg.d_ff
    if cfg.arch_type == "dense":
        trunk, n_attn = cfg.num_layers * (attn + mlp), cfg.num_layers
    else:
        inner, h = cfg.ssm_inner, cfg.ssm_num_heads
        conv_dim = inner + 2 * cfg.ssm_num_groups * cfg.ssm_state_dim
        n_attn = cfg.num_layers // cfg.attn_every
        trunk = cfg.num_layers * (d * (inner + conv_dim + h) + inner * d) + n_attn * (attn + mlp)
    n = trunk + (1 + k) * d * v
    return 6.0 * n * tokens + 12.0 * TRAIN_SEQ * cfg.q_dim * n_attn * tokens, n


def profile_step(torch, fn) -> tuple[float, list]:
    """Device ms of one call of ``fn`` from ``torch.profiler`` (every device
    event), and the eight names with the most device time.  Only device
    activity is traced: with host activity too, profiling one Zamba2-1.2B
    step (tens of thousands of host operators) took ~55 s where the step
    takes ~3 s."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    check(bool(by_name), "profile_step: the profiler traced the step's device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()), top


def train_phase(torch, dev, smi: str) -> list[dict]:
    """Each trainer at its published widths and depth (seed-0 generator
    weights, fp32 params, bf16 compute, remat on, as the configs say):
    AdamW with a cosine schedule for 6 steps on one global batch of 8 x
    1024 tokens from ``make_batch``; the loss falls, ``grad_norm`` (hence
    every gradient) and the params stay finite, ``step == 6``.  OLMo-1B
    also: a checkpoint of its params (4.7 GB) saved and restored on the
    card is bitwise equal; then, each from a fresh seed-0 state (the
    trained state released, so that each peak is that step's own), the
    first step at accum 1 against the config's accum (5e-3 relative, as
    the reference's test allows), remat on against off (the same loss),
    and one step with the trunk's old per-layer indexing of the stacked
    params beside the unbinding one (peak memory and ms of each)."""
    import tempfile

    import repro_torch.models.model as model_mod
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.transformer import layer_slice
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.training.optimizer import cosine_schedule, make_optimizer
    from repro_torch.training.train_loop import init_train_state, make_train_step
    from repro_torch.training.tree import tree_items, tree_leaves

    out = []
    for arch, what in TRAINERS:
        released(torch)
        cfg = get_config(arch)
        log(f"train {cfg.name}: {what}; {TRAIN_STEPS} AdamW steps of {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens, accum {cfg.grad_accum}, remat {cfg.remat}, compute "
            f"{cfg.dtype}, params {cfg.param_dtype}")
        opt = make_optimizer("adamw", lr=cosine_schedule(6e-4, warmup=0, total=TRAIN_STEPS))

        def fresh_state():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            return init_train_state(model_mod.init_params(cfg, gen, dev), opt)

        state = fresh_state()
        n_total = sum(p.numel() for p in tree_leaves(state["params"]))
        batch = {k: torch.from_numpy(a).to(dev)
                 for k, a in make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED).items()}
        step = make_train_step(cfg, opt)
        tokens = TRAIN_BATCH * TRAIN_SEQ

        def timed_step(fn, st):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn(st, batch)
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 1e9

        def first_step(fn):
            """(metrics, ms, peak GB) of one step from the seed-0 state."""
            (new, m), ms, peak = timed_step(fn, fresh_state())
            del new
            return m, ms, peak

        losses, norms, step_ms, peaks = [], [], [], []
        for _ in range(TRAIN_STEPS):
            (state, m), ms, peak = timed_step(step, state)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            step_ms.append(ms)
            peaks.append(peak)
            log(f"  step {len(losses)}: loss {losses[-1]:.5f}, grad_norm {norms[-1]:.4f}, "
                f"{ms:.1f} ms, peak {peak:.2f} GB")
        check(all(math.isfinite(x) for x in losses + norms)
              and all(bool(torch.isfinite(p).all()) for p in tree_leaves(state["params"])),
              f"{cfg.name}: every loss, grad_norm (so every gradient) and param finite")
        check(losses[-1] < losses[0], f"{cfg.name}: the loss falls over {TRAIN_STEPS} steps "
              f"({losses[0]:.5f} -> {losses[-1]:.5f})")
        check(int(state["step"]) == TRAIN_STEPS, f"{cfg.name}: step == {TRAIN_STEPS}")
        med = statistics.median(step_ms[1:])
        stamp(f"{cfg.name}: {TRAIN_STEPS} steps done")
        dev_ms, top = profile_step(torch, lambda: step(state, batch))
        stamp(f"{cfg.name}: profiled step done")
        flops, n_mm = train_flops(cfg, tokens)
        static = 16 * n_total / 1e9
        row = dict(arch=arch, params=n_total, matmul_params=n_mm, losses=losses,
                   grad_norms=norms, step_ms=step_ms, step_ms_median=med,
                   tokens_per_s=tokens / (med / 1e3), peak_gb=max(peaks),
                   static_gb=static, device_ms=dev_ms, model_tflop=flops / 1e12,
                   mfu_step=flops / (med / 1e3) / BF16_TFLOPS,
                   mfu_device=flops / (dev_ms / 1e3) / BF16_TFLOPS,
                   top_kernels=[[n, ms] for n, ms in top])
        log(f"  {cfg.name} on {smi}: step {med:.1f} ms (median of steps 2-{TRAIN_STEPS}, host "
            f"clock, each ended by its sync), {row['tokens_per_s']:.0f} tokens/s, peak "
            f"{row['peak_gb']:.2f} GB (static 16 B/param: {static:.2f} GB for "
            f"{n_total / 1e9:.3f} B params), device {dev_ms:.1f} ms per step (profiler)")
        log(f"  {cfg.name}: model FLOPs {flops / 1e12:.2f} TFLOP per step ({n_mm / 1e9:.3f} B "
            f"matmul params with each head's unembedding, + attention), "
            f"{row['mfu_step']:.3f} of {BF16_TFLOPS / 1e12:.0f} TFLOP/s bf16 dense over the step, "
            f"{row['mfu_device']:.3f} over the device time")
        for n, ms in top:
            log(f"    {ms:9.2f} ms  {n[:110]}")
        if arch == "olmo_1b":
            with tempfile.TemporaryDirectory() as d:
                path = str(Path(d) / "params.npz")
                t0 = time.perf_counter()
                save_checkpoint(path, state["params"], step=int(state["step"]))
                back = restore_checkpoint(path, state["params"], dev)
                secs = time.perf_counter() - t0
            bad = [p for (p, a), b in zip(tree_items(state["params"]), tree_leaves(back))
                   if not torch.equal(a, b)]
            check(not bad, f"{cfg.name}: the params' checkpoint ({4 * n_total / 1e9:.2f} GB) "
                  f"saved and restored on the card bitwise equal ({secs:.1f} s)")
            row["checkpoint_s"] = secs
            del back
        del state
        stamp(f"{cfg.name}: trained")
        if arch == "olmo_1b":
            m1, ms1, peak1 = first_step(make_train_step(cfg, opt, accum=1))
            rel = abs(float(m1["loss"]) - losses[0]) / losses[0]
            check(rel <= 5e-3, f"{cfg.name}: first-step loss at accum 1 {float(m1['loss']):.5f} "
                  f"vs accum {cfg.grad_accum} {losses[0]:.5f}, {rel:.2e} <= 5e-3 relative "
                  f"({ms1:.1f} ms, peak {peak1:.2f} GB at accum 1)")
            m0, ms0, peak0 = first_step(
                make_train_step(dataclasses.replace(cfg, remat=False), opt))
            check(float(m0["loss"]) == losses[0],
                  f"{cfg.name}: remat off gives the same first-step loss {float(m0['loss']):.6f} "
                  f"(grad_norm {float(m0['grad_norm']):.6f} vs {norms[0]:.6f}; {ms0:.1f} ms, "
                  f"peak {peak0:.2f} GB without remat)")
            unstack = model_mod.unstack
            model_mod.unstack = lambda tree, lo, hi: {
                i: layer_slice(tree, i) for i in range(lo, hi)}
            try:
                m_sel, ms_sel, peak_sel = first_step(step)
            finally:
                model_mod.unstack = unstack
            m_new, ms_unb, peak_unb = first_step(step)
            check(float(m_sel["loss"]) == float(m_new["loss"]) == losses[0],
                  f"{cfg.name}: one step with per-layer indexing of the stacked params (the "
                  f"parent's trunk) {ms_sel:.1f} ms, peak {peak_sel:.2f} GB; with one unbind "
                  f"per leaf {ms_unb:.1f} ms, peak {peak_unb:.2f} GB; the same loss")
            row.update(accum1_loss=float(m1["loss"]), accum1_ms=ms1, accum1_peak_gb=peak1,
                       no_remat_ms=ms0, no_remat_peak_gb=peak0, select_ms=ms_sel,
                       select_peak_gb=peak_sel, unbind_ms=ms_unb, unbind_peak_gb=peak_unb)
            del m1, m0, m_sel, m_new

        out.append(row)
        del batch, step
    released(torch)
    return out


def fig6_phase(torch, dev) -> dict:
    """The paper's Fig. 6 at the reference's settings: B-AlexNet trained 30
    SGD steps of 16 images, 48 evaluation images at three blur levels, 20
    thresholds.  cuDNN and cuBLAS TF32 are switched on around the phase:
    one SGD step at batch 2 on the card must match float64 on the CPU
    within 2e-2 of each step's scale, so the model turns TF32 off in the
    backward pass too (on an H100 80GB HBM3: fp32 read 6.97e-3, cuDNN's
    conv1 weight gradient, 4.43e-4 with cuDNN off; TF32 0.17).  Each curve
    must be finite and monotone in the threshold; the ordering low >= mid
    >= high is reported, as the reference reports it."""
    import numpy as np

    from repro_torch.benchmarks import fig6_calibration as fig6
    from repro_torch.models.alexnet import BAlexNetConfig, init_b_alexnet

    backends = torch.backends
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = True
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_b_alexnet(BAlexNetConfig(), gen, dev)
        img, lab = fig6.make_images(gen, 2)
        new, loss = fig6.sgd_step(params, img, lab, 3e-4)
        cpu = {k: {n: t.cpu().double() for n, t in v.items()} for k, v in params.items()}
        new_c, loss_c = fig6.sgd_step(cpu, img.cpu().double(), lab.cpu(), 3e-4)
        worst = (0.0, "")
        for name in params:
            for leaf in ("w", "b"):
                g = (params[name][leaf].double() - new[name][leaf].double()).cpu()
                g_c = cpu[name][leaf] - new_c[name][leaf]
                ulp = 2.0 ** -23 * float(cpu[name][leaf].abs().max())
                err = (float((g - g_c).abs().max()) - ulp) / float(g_c.abs().max())
                worst = max(worst, (err, f"{name}.{leaf}"))
        check(worst[0] <= 2e-2 and abs(float(loss) - float(loss_c)) <= 1e-5 * float(loss_c),
              f"fig6: one SGD step at batch 2 on the card (fp32, TF32 on outside the model) "
              f"vs float64 on the CPU: loss {float(loss):.6f} vs {float(loss_c):.6f}, each "
              f"step within {worst[0]:.2e} ({worst[1]}) <= 2e-2 of its scale (fp32 cuDNN read "
              f"6.97e-3 at conv1.w, TF32 0.17)")
        del params, new, cpu, new_c
        rep = fig6.report(48, dev)
    finally:
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    curves = rep["curves"]
    check(all(np.isfinite(c).all() and np.all(np.diff(c) >= 0) for c in curves.values()),
          f"fig6: all three curves finite and monotone in the threshold (20 thresholds "
          f"{fig6.THRESHOLDS[0]:.2f}..{fig6.THRESHOLDS[-1]:.2f})")
    means = {k: float(c.mean()) for k, c in curves.items()}
    ordered = means["low"] >= means["mid"] >= means["high"]
    log(f"  fig6 (readings): final loss {rep['final_loss']:.4f}; mean exit probability "
        + ", ".join(f"{k} {v:.4f}" for k, v in means.items())
        + "; main-head accuracy " + ", ".join(f"{k} {v:.3f}" for k, v in rep["accs"].items())
        + f"; exit_prob_low>=mid>=high {ordered}; {rep['seconds']:.1f} s")
    for k, c in curves.items():
        log(f"  fig6 {k} (kernel {fig6.KERNELS[k]}): " + " ".join(f"{x:.3f}" for x in c))
    for row in fig6.rows(rep):
        log(f"  {row}")
    return dict(seconds=rep["seconds"], final_loss=rep["final_loss"], accs=rep["accs"],
                mean_exit=means, ordered=ordered, step_vs_cpu=worst,
                curves={k: c.tolist() for k, c in curves.items()})


def train_example_phase(torch, dev) -> dict:
    """``python -m repro_torch.examples.train_branchy`` with its defaults
    (300 steps of 16 x 64 on the OLMo-1B smoke config, a checkpoint round
    trip, then ``ServingEngine`` on the restored params), in a process of
    its own: it must exit 0, print its round trip, and its serving leg must
    launch ``flash_decode`` and the exit kernel (counted by the wrappers,
    printed by the example).  Then :func:`branchy_twin` holds that serving
    leg, on the checkpoint the example wrote, against its plain version."""
    import os
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ckpt = Path(d) / "branchy_ckpt.npz"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.train_branchy",
             "--ckpt", str(ckpt)],
            env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        lines = (proc.stdout + proc.stderr).strip().splitlines()
        for line in lines[-10:]:
            log(f"  | {line}")
        check(proc.returncode == 0, f"the train_branchy example exited {proc.returncode} "
              f"on the card in {secs:.1f} s")
        check(any(l.startswith("checkpoint round-trip OK (bitwise)") for l in lines),
              "train_branchy: its checkpoint round trip printed")
        tag = "kernel launches in the serving leg: "
        launches = json.loads(next(l for l in lines if l.startswith(tag))[len(tag):])
        check(launches["flash_decode"] > 0 and launches["entropy_exit_argmax_heads"] > 0,
              f"train_branchy: its ServingEngine leg launched flash_decode "
              f"{launches['flash_decode']} and entropy_exit_argmax_heads "
              f"{launches['entropy_exit_argmax_heads']} times")
        twin = branchy_twin(torch, dev, ckpt, TRAIN_BRANCHY_STEPS)
    fracs = next((l for l in lines if l.startswith("post-training exit fractions")), "")
    return dict(seconds=secs, returncode=proc.returncode, launches=launches,
                exit_fractions=fracs, twin=twin)


TRAIN_BRANCHY_STEPS = 300  # the example's default --steps


def branchy_twin(torch, dev, ckpt: Path, steps: int) -> dict:
    """The train_branchy example's serving leg again, in this process: the
    params its checkpoint holds, its prompt (the first 32 positions of
    ``make_batch(cfg, 16, 64, seed=steps)``, the batch after its training
    batches) and its engine (``ServingEngine``: CUDA graphs, the kernels),
    beside two eager twins, one on the kernels and one on the plain path
    (``use_kernels=False``), whose stacked branch logits are recorded.
    Each of 16 decode steps feeds all three the plain twin's tokens, so a
    flip at a near-tie does not carry over.  Each step:

    * the graphed engine equals its eager twin bitwise (tokens, exit mask,
      entropies, main-head logits);
    * the exit kernel against its plain version on the eager kernel twin's
      own branch logits: entropies within 1e-5, flags exact where |H - thr|
      >= 1e-5, tokens of exiting rows exact;
    * kernel path against plain path: branch and main-head logits within 8
      bf16 ulps of their scale (the main head on rows that stay on both);
      entropies within 1e-5 + 2 x each row's first-order bound (max |d
      logit| x sum p |log p + H| / log V, from the plain logits); exit
      masks equal on rows whose two entropies fall on one side of the
      threshold; tokens equal on the other rows, save where the head that
      chose them has a top-2 gap of at most 2 x its |d logit|."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ref
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingEngine, tiers
    from repro_torch.training.checkpoint import restore_checkpoint

    cfg = get_smoke_config("olmo_1b")
    (layer,), thr = cfg.branch_layers, cfg.exit_threshold
    template = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = restore_checkpoint(str(ckpt), template, dev)
    prompt = {"tokens": make_batch(cfg, 16, 64, seed=steps)["tokens"][:, :32]}
    engines = {
        "graphed": ServingEngine(cfg, params, context_len=96, device=dev),
        "eager": ServingEngine(cfg, params, context_len=96, device=dev, graphs=False),
        "plain": ServingEngine(cfg, params, context_len=96, device=dev,
                               use_kernels=False, graphs=False),
    }
    ex = {k: e.executor for k, e in engines.items()}
    check(ex["graphed"].use_kernels and ex["graphed"].graphs and ex["eager"].use_kernels
          and not ex["eager"].graphs and not ex["plain"].use_kernels and not ex["plain"].graphs,
          "train_branchy twin: the example's engine (graphs, kernels), an eager kernel "
          "twin and an eager plain twin")
    states = {k: e.start(prompt) for k, e in engines.items()}
    caches = {k: st["caches"] for k, st in states.items()}
    pos = states["plain"]["pos"]
    tok = states["plain"]["last_logits"].argmax(-1).to(torch.int32)[:, None]
    stacked = tiers.branch_logits_stacked
    branch, into = {}, [None]

    def recording(params_, got, cfg_, layers):
        ls, lg = stacked(params_, got, cfg_, layers)
        if lg is not None:
            branch[into[0]] = lg[0, :, 0].float().clone()  # (B, V): the one head
        return ls, lg

    def must(cond, what):
        """A per-step check: fails the run like :func:`check`, logs nothing."""
        if not cond:
            raise SystemExit(f"FAILED: {what}")

    worst = dict(dh_same_input=0.0, dh=0.0, dlog_branch=0.0, dlog_main=0.0)
    counts = dict(exits=0, straddles=0, near_ties=0, compared_tokens=0)
    for t in range(16):
        res = {}
        branch.clear()
        for k, e in engines.items():
            into[0] = k
            if not e.executor.graphs:
                tiers.branch_logits_stacked = recording
            try:
                res[k], caches[k] = e.step(tok, pos, caches[k])
            finally:
                tiers.branch_logits_stacked = stacked
        pos += 1
        g, kn, pl = res["graphed"], res["eager"], res["plain"]
        must(np.array_equal(g.tokens, kn.tokens) and np.array_equal(g.exited, kn.exited)
              and np.array_equal(g.branch_entropy[layer], kn.branch_entropy[layer])
              and bool(torch.equal(g.last_logits, kn.last_logits)),
              f"train_branchy twin step {t}: the graphed engine equals its eager twin "
              "bitwise (tokens, exits, entropies, logits)")
        lk, lp = branch["eager"], branch["plain"]
        hr, fr, tr = (x[0].cpu().numpy() for x in ref.entropy_exit_argmax_heads_ref(lk[None], thr))
        ek, ep = kn.branch_entropy[layer], pl.branch_entropy[layer]
        dh_same = float(np.abs(ek - hr).max())
        clear = np.abs(hr - thr) >= 1e-5
        must(dh_same <= 1e-5 and np.array_equal(kn.exited[clear], fr[clear])
              and np.array_equal(kn.tokens[kn.exited], tr[kn.exited]),
              f"train_branchy twin step {t}: the exit kernel on the path's own branch "
              f"logits (K=1 B=16 V={lk.shape[-1]}) vs its plain version: |dH| {dh_same:.3g} "
              "<= 1e-5, flags exact off the edge, exiting rows' tokens exact")
        dz_b = (lk - lp).abs().amax(dim=-1).cpu().numpy()
        must(float(dz_b.max()) <= bf16_ulps(lp),
              f"train_branchy twin step {t}: branch logits kernel vs plain path "
              f"{float(dz_b.max()):.4g} <= {bf16_ulps(lp):.4g} (8 bf16 ulps of their scale)")
        slope = entropy_slope(torch, lp)
        dh = np.abs(ek - ep)
        must(bool((dh <= 1e-5 + 2 * slope * dz_b).all()),
              f"train_branchy twin step {t}: entropies kernel vs plain path within "
              f"1e-5 + 2 x the first-order bound on every row (max |dH| {float(dh.max()):.3g})")
        straddle = (ek < thr) != (ep < thr)
        both_exit, stay = ~straddle & pl.exited, ~straddle & ~pl.exited
        must(np.array_equal(kn.exited[~straddle], pl.exited[~straddle]),
              f"train_branchy twin step {t}: exit masks equal off the threshold's edge "
              f"(rows at the edge: {straddle.nonzero()[0].tolist()})")
        vocab = cfg.vocab_size
        mk, mp = kn.last_logits[:, :vocab].float(), pl.last_logits[:, :vocab].float()
        stay_dev = torch.as_tensor(stay, device=mk.device)
        dz_m = (mk - mp).abs().amax(dim=-1).cpu().numpy()
        dlog_m = float(dz_m[stay].max()) if stay.any() else 0.0
        must(not stay.any() or dlog_m <= bf16_ulps(mp[stay_dev]),
              f"train_branchy twin step {t}: main-head logits on rows that stay "
              f"{dlog_m:.4g} <= 8 bf16 ulps of their scale")
        tie = (both_exit & (top2_gap(lp) <= 2 * dz_b)) | (stay & (top2_gap(mp) <= 2 * dz_m))
        compared = ~straddle & ~tie
        must(np.array_equal(kn.tokens[compared], pl.tokens[compared]),
              f"train_branchy twin step {t}: tokens kernel vs plain path equal on "
              f"{int(compared.sum())} rows (edge {straddle.nonzero()[0].tolist()}, "
              f"near-ties {tie.nonzero()[0].tolist()})")
        worst = dict(dh_same_input=max(worst["dh_same_input"], dh_same),
                     dh=max(worst["dh"], float(dh.max())),
                     dlog_branch=max(worst["dlog_branch"], float(dz_b.max())),
                     dlog_main=max(worst["dlog_main"], dlog_m))
        counts["exits"] += int(pl.exited.sum())
        counts["straddles"] += int(straddle.sum())
        counts["near_ties"] += int(tie.sum())
        counts["compared_tokens"] += int(compared.sum())
        tok = pl.tokens_dev[:, None]
    log("  ok: train_branchy twin, each of 16 steps: graphed == eager bitwise; the exit "
        "kernel vs its plain version on the path's own branch logits; logits, "
        "entropies, exit masks and tokens kernel vs plain path (see branchy_twin)")
    log(f"  train_branchy twin: 16 steps x 16 rows, {counts['exits']} exits on the plain "
        f"path, {counts['straddles']} rows at the threshold's edge, {counts['near_ties']} "
        f"at a near-tie, {counts['compared_tokens']} tokens equal; max |dH| "
        f"{worst['dh_same_input']:.3g} on the same logits, {worst['dh']:.3g} across the "
        f"paths; max |d logit| branch {worst['dlog_branch']:.4g}, main "
        f"{worst['dlog_main']:.4g}")
    return dict(counts, **worst)


# ---------------------------------------------------------------- phase 6
def alexnet_phase(torch, dev) -> dict:
    """B-AlexNet, the paper's own network, at batch 1 in fp32: built on the
    card from a seeded generator and held against the same weights on the
    CPU; profiled in measure mode (graph replays), each t_c at or above
    its H100 floor and its device time; the Fig. 4 and Fig. 5 sweeps on
    that profile, holding the claims the cost model guarantees for any
    profile and logging the rest; Dijkstra equal to ``solve_chain_torch``
    at both ends of every Fig. 5 curve.  cuDNN and cuBLAS TF32 are set to
    on for the phase (the model must turn them off around its own calls)
    and back to off after."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.benchmarks import alexnet_profile
    from repro_torch.benchmarks import fig4_inference_time as fig4
    from repro_torch.benchmarks import fig5_partition_layer as fig5
    from repro_torch.core import build_cost_profile, shortest_path_plan, solve_chain_torch
    from repro_torch.models.alexnet import BAlexNetConfig, forward, init_b_alexnet, layer_fns

    log("alexnet: B-AlexNet (conv1..conv5, fc6..fc8, branch after conv1), batch 1, "
        "224 x 224 x 3 fp32")
    backends = torch.backends
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = True
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_b_alexnet(BAlexNetConfig(), gen, dev)
        images = torch.randn((1, 3, 224, 224), generator=gen, device=dev)
        cpu_params = {k: {n: t.cpu() for n, t in v.items()} for k, v in params.items()}
        fns, cpu_fns = layer_fns(params), layer_fns(cpu_params)
        # Each layer on the card and on the CPU from the same input (the
        # card's chain), then both logits: fp32 on both sides with the
        # products summed in other orders, held at 1e-4 of each output's
        # scale; TF32 (10 mantissa bits) would miss by about 1e-3.
        x, worst, outs = images, 0.0, []
        for (name, fn), (_, cfn) in zip(fns, cpu_fns):
            y = fn(x)
            want = cfn(x.cpu())
            err = float((y.cpu() - want).abs().max()) / float(want.abs().max())
            worst = max(worst, err)
            check(err <= 1e-4, f"alexnet {name}: card vs CPU max |d| {err:.3g} of the "
                  f"output's scale <= 1e-4 (fp32, TF32 off inside the model)")
            outs.append((x, y))
            x = y
        main, branch = forward(params, images)
        main_c, branch_c = forward(cpu_params, images.cpu())
        d_logits = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                       for a, b in ((main, main_c), (branch, branch_c)))
        check(d_logits <= 1e-4 and tuple(main.shape) == tuple(branch.shape) == (1, 2)
              and bool(torch.isfinite(main).all() and torch.isfinite(branch).all()),
              f"alexnet: main and branch-1 logits (1, 2), finite, card vs CPU within "
              f"{d_logits:.3g} <= 1e-4 of their scale")
        check(backends.cudnn.allow_tf32 and backends.cuda.matmul.allow_tf32,
              "alexnet: the TF32 flags the caller set are restored after the model's calls")

        # Measure mode, each t_c against its floor and its device time.
        t0 = time.perf_counter()
        costs = alexnet_profile.profile(params=params)
        log(f"  measure-mode profile (20 graph replays per layer) in "
            f"{time.perf_counter() - t0:.1f} s")
        rows = []
        for c, (name, fn), (xin, y) in zip(costs, fns, outs):
            counter = FlopCounterMode(display=False)
            with counter:
                fn(xin)
            flops = float(counter.get_total_flops())
            weights = sum(t.numel() * 4 for t in params[name].values())
            nbytes = weights + xin.numel() * 4 + y.numel() * 4
            floor = max(flops / FP32_FLOPS, nbytes / HBM_BPS)
            dms, src, _ = device_ms(lambda fn=fn, xin=xin: fn(xin))
            rows.append(dict(name=name, t_c_ms=c.time_s * 1e3, device_ms=dms,
                             floor_ms=floor * 1e3, gflop=flops / 1e9,
                             mb=nbytes / 1e6, alpha=c.output_bytes))
            log(f"    {name}: t_c {c.time_s * 1e3:.5f} ms, device {dms:.5f} ms ({src}), "
                f"floor {floor * 1e3:.5f} ms ({flops / 1e9:.4f} GFLOP fp32, "
                f"{nbytes / 1e6:.3f} MB), t_c / device {c.time_s * 1e3 / dms:.3f}, "
                f"alpha {c.output_bytes:g} B")
            check(c.time_s >= floor and c.time_s * 1e3 >= dms,
                  f"alexnet {name}: t_c {c.time_s * 1e3:.5f} ms at or above its floor "
                  f"{floor * 1e3:.5f} ms and its device time {dms:.5f} ms")
            check(c.output_bytes == y.numel() * 4, f"alexnet {name}: alpha == output bytes")
    finally:
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    del params, cpu_params, fns, cpu_fns, outs
    torch.cuda.empty_cache()

    # The paper's figures on the measured profile.
    r4, r5 = fig4.sweep(costs, dev), fig5.sweep(costs, dev)
    rep4, rep5 = fig4.validate(r4), fig5.validate(r5)
    check(all(v for k, v in rep4.items() if k.startswith("monotone")),
          f"fig4: E[T] non-increasing in p on all {len(r4)} curves (101 points each)")
    check(all(v for k, v in rep5.items() if k.startswith("monotone")),
          f"fig5: the split non-increasing in gamma on all {len(r5)} curves (60 gammas)")
    for g in fig4.GAMMAS:
        red = rep4[f"reduction_pct_gamma{int(g)}"]
        log(f"  fig4 gamma {g:g} (readings): reductions p 0 -> 1 "
            + ", ".join(f"{n} {v:.4f}%" for n, v in red.items())
            + f"; p=1 equal {rep4[f'p1_equal_gamma{int(g)}']}; 3g >= 4g >= wifi "
            f"{rep4[f'ordering_3g>=4g>=wifi_gamma{int(g)}']}; splits at p=0 "
            + ", ".join(f"{n} {int(r4[(n, g)][2][0])}" for n in fig4.NETWORKS)
            + ", at p=1 " + ", ".join(f"{n} {int(r4[(n, g)][2][-1])}" for n in fig4.NETWORKS))
    log("  fig5 (readings): 4g flips to cloud-only first: "
        + ", ".join(f"p={p} {rep5[f'4g_flips_first_p{p}']}" for p in fig5.PROBS))
    ends, bad = {}, []
    for (net, p), (gammas, splits) in r5.items():
        ends[f"{net} p={p}"] = [int(splits[0]), int(splits[-1])]
        for j in (0, -1):
            g = float(gammas[j])
            prof = build_cost_profile(costs, (alexnet_profile.BRANCH_AFTER,), (p,), net,
                                      gamma=g, raw_input_bytes=alexnet_profile.RAW_INPUT_BYTES)
            plan = shortest_path_plan(prof)
            args = [torch.tensor(a, dtype=torch.float64, device=dev) for a in
                    (prof.t_c, prof.alpha, prof.branch_exit_probs(), g,
                     prof.network.bandwidth_bps)]
            s_t, c_t = solve_chain_torch(*args)
            rel = abs(float(c_t) - plan.expected_time_s) / plan.expected_time_s
            if not (plan.split_layer == int(s_t) == int(splits[j]) and rel <= 1e-9):
                bad.append((net, p, g, plan.split_layer, int(s_t), int(splits[j]), rel))
    check(not bad, f"fig5: Dijkstra on G'_BDNN == solve_chain_torch (float64, {dev}) == "
          f"the sweep at gamma 1 and 1000 on all {len(r5)} curves, E[T] within 1e-9 "
          f"(failing: {bad or 'none'})")
    log(f"  fig5 splits at gamma 1 and 1000: {json.dumps(ends)}")
    for row in fig4.run(costs, dev) + fig5.run(costs, dev):
        log(f"  {row}")
    return dict(layers=rows, max_layer_err=worst, logits_err=d_logits,
                fig4_reduction_pct={int(g): rep4[f"reduction_pct_gamma{int(g)}"]
                                    for g in fig4.GAMMAS},
                fig4_claims={k: v for k, v in rep4.items() if not k.startswith("reduction")},
                fig5_claims=rep5, fig5_split_ends=ends)


def main() -> int:
    global _log_file
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log", type=Path, default=None,
                        help="also write every printed line to this file")
    args = parser.parse_args()
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    if args.log is not None:
        args.log.parent.mkdir(parents=True, exist_ok=True)
        _log_file = args.log.open("w")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (fp32 products run in full fp32)")

    t_build = time.perf_counter()
    reports = build.build()
    secs = time.perf_counter() - t_build
    log(f"build: {secs:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = (exit_kernel_phase(torch, dev, gen) + flash_kernel_phase(torch, dev, gen)
               + ssd_update_phase(torch, dev, gen) + ssd_scan_phase(torch, dev, gen))
    torch.cuda.empty_cache()
    stamp("kernel phases done")
    mla_layer = mla_layer_phase(torch, dev)
    stamp("mla layer phase done")
    alexnet = alexnet_phase(torch, dev)
    stamp("alexnet phase done")
    e2e, phase_s = [], {}
    for path in PATHS:
        t0 = time.perf_counter()
        e2e.append(e2e_phase(torch, dev, path))
        phase_s[path.arch] = time.perf_counter() - t0
        stamp(f"end to end {path.arch} done in {phase_s[path.arch]:.1f} s")
    for arch, phase in (("internvl2_76b", vlm_phase), ("whisper_medium", whisper_phase)):
        t0 = time.perf_counter()
        e2e.append(phase(torch, dev))
        phase_s[arch] = time.perf_counter() - t0
        stamp(f"{arch} done in {phase_s[arch]:.1f} s")
    dry = start_dryrun()
    stamp("dryrun: started in two processes of its own")
    t0 = time.perf_counter()
    sharded = sharded_phase(torch, dev, smi)
    phase_s["sharded"] = time.perf_counter() - t0
    stamp(f"sharded phase done in {phase_s['sharded']:.1f} s")
    t0 = time.perf_counter()
    sharded_train = sharded_train_phase(torch, dev, smi)
    phase_s["sharded_train"] = time.perf_counter() - t0
    stamp(f"sharded train phase done in {phase_s['sharded_train']:.1f} s")
    t0 = time.perf_counter()
    dryrun = dryrun_phase(torch, smi, sharded["walk"], dry)
    phase_s["dryrun"] = time.perf_counter() - t0
    stamp(f"dryrun phase done in {phase_s['dryrun']:.1f} s")
    example = example_phase()
    stamp("serve_partitioned example done")
    training = train_phase(torch, dev, smi)
    stamp("train phase done")
    fig6 = fig6_phase(torch, dev)
    stamp("fig6 phase done")
    train_example = train_example_phase(torch, dev)
    stamp("train_branchy example done")
    for row in kernels:
        by_path = {r["arch"]: sum(run["launches"][row["name"]] for run in r["runs"])
                   for r in e2e}
        by_path["train_branchy"] = train_example["launches"][row["name"]]
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        steps = {r["arch"]: r["runs"][0]["decode_steps"] for r in e2e}
        row["launches_per_decode_step"] = {
            r["arch"]: r["runs"][0]["launches"][row["name"]] / steps[r["arch"]]
            for r in e2e}
    check(len(SHORT_WINDOWS) <= MAX_SHORT_RUN,
          f"device_ms left out {len(SHORT_WINDOWS)} <= {MAX_SHORT_RUN} profiler windows "
          f"over the run (kernel, events kept, full): {SHORT_WINDOWS}")
    log(f"phase seconds: {json.dumps(phase_s)}; whole run {time.perf_counter() - t_start:.1f} s")
    log(f"summary: {json.dumps(dict(device=name, nvidia_smi=smi, total_s=time.perf_counter() - t_start, phase_s=phase_s, alexnet=alexnet, mla_layer=mla_layer, paths=e2e, sharded=sharded, dryrun=dryrun, sharded_train=sharded_train, example=example, training=training, fig6=fig6, train_example=train_example, short_windows=SHORT_WINDOWS))}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    if _log_file is not None:
        _log_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
