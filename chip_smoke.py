#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card and fails (non-zero
exit) if any phase fails:

  1. device — the card's name and ``nvidia-smi`` power limit; TF32 off;
  2. build — compiles every CUDA kernel of the port from ``src`` with
     ``nvcc`` (sm_90a), all sources at once, into ``build/kernels``;
  3. kernels — each Hopper kernel against its plain PyTorch version at the
     main path's shapes, with the tolerance stated beside each check, and
     its time (CUDA events, median of 30), the plain version's time, the
     time of one PyTorch library call computing the same function where one
     exists, and its bound (the larger of bytes / 3.35 TB/s and operations
     / the fp32 peak of 67 TFLOP/s, counted on these inputs);
  4. end to end — full-width, full-depth Phi-3-mini (random weights from a
     seeded ``torch.Generator``) behind ``PartitionedServer(split_layer=24)``:
     the first decode step on the kernel path against the plain path (main-
     head logits within 8 bf16 ulps; at the median threshold, exit masks
     equal away from the threshold), one
     step's dispatch under ``torch.cuda.set_sync_debug_mode("error")``,
     then 8 requests of 128-token prompts and 16 new tokens through
     ``submit`` / ``run`` at two exit thresholds (never-exit 0.5, and the
     median branch-8 entropy, where rows exit on the edge and the cloud
     runs compacted buckets), and a short run with ``heads_batched=False``
     for the single-head exit kernel.  Kernel launch counts are reset just
     before each run and read just after it.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src`` beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BPS = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value
SEED = 0
N_REQ, PROMPT, NEW_TOKENS = 8, 128, 16
SPLIT, SLOTS, CONTEXT = 24, 8, 4096


def log(msg: str) -> None:
    print(msg, flush=True)


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


def device_ms(fn, match: str | None = None, iters: int = 30):
    """Device time of one call from ``torch.profiler``: the device events
    (kernels, copies, fills) whose name contains ``match`` (None: all of
    them) over ``iters`` calls, divided by ``iters``.  Falls back to
    :func:`time_ms` (CUDA events, which include host launch gaps) when the
    profiler records no device time.  Returns (ms, source)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and (match is None or match in e.name)
    )
    if total_us <= 0:
        return time_ms(fn, iters), "cuda-events"
    return total_us / iters / 1e3, "profiler"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"  ok: {what}")


# ---------------------------------------------------------------- phase 3
def exit_kernel_phase(torch, dev, gen) -> list[dict]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.entropy_exit import entropy_exit_argmax_heads_cuda

    k, b, v = 2, 8, 32064
    logits = (torch.randn((k, b, v), generator=gen, device=dev) * 4).to(torch.bfloat16)
    logits[0, 0, -64:] = -1e30  # pad lanes inside the width
    logits[1, 1, 100] = logits[1, 1, 30000] = 40.0  # tie across the row
    logits[0, 2, 7] = logits[0, 2, 9] = 40.0  # tie inside one tile
    h_ref0, _, _ = ref.entropy_exit_argmax_heads_ref(logits, 0.5)
    thr = h_ref0.median(dim=1).values.float()  # per-head (K,): mixed flags
    rows = []
    for name, lg, th, replaces in (
        ("entropy_exit_argmax_heads", logits, thr,
         "src/repro/kernels/entropy_exit.py:296"),
        ("entropy_exit_argmax", logits[:1], float(thr[0]),
         "src/repro/kernels/entropy_exit.py:191"),
    ):
        h, flag, tok = entropy_exit_argmax_heads_cuda(lg, th)
        hr, flr, tokr = ref.entropy_exit_argmax_heads_ref(lg, th)
        torch.cuda.synchronize()
        err = float((h - hr).abs().max())
        thv = torch.as_tensor(th, device=dev).reshape(-1, 1).expand_as(hr)
        clear = (hr - thv).abs() >= 1e-5
        log(f"{name}: K={lg.shape[0]} B={b} V={v} bf16")
        check(err <= 1e-5, f"{name} entropy |dH| = {err:.3g} <= 1e-5 "
              "(fp32 online sums vs log_softmax)")
        check(bool(torch.equal(tok, tokr)), f"{name} tokens exact, ties to the first index")
        check(bool(torch.equal(flag[clear], flr[clear])),
              f"{name} flags exact where |H - thr| >= 1e-5 "
              f"({int((~clear).sum())} rows at the edge)")
        call = lambda: entropy_exit_argmax_heads_cuda(lg, th)  # noqa: E731
        ms, src = device_ms(call, "entropy_exit_argmax_kernel")
        wall = time_ms(call)
        plain, _ = device_ms(lambda: ref.entropy_exit_argmax_heads_ref(lg, th))
        n = lg.numel()
        nbytes = n * 2 + lg.shape[0] * 4 + lg.shape[0] * b * (4 + 1 + 4)
        flops = 5 * n  # max, sub, exp, add, fma per element
        bound = max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/entropy_exit.cu",
            replaces=replaces, launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=bound,
            bound_by="bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS else "operations",
            library_ms=None, ms_source=src, wall_ms=wall,
        ))
        log(f"  {name}: kernel {ms:.4f} ms on the device ({src}; {wall:.4f} ms "
            f"between CUDA events with launch overhead), plain {plain:.4f} ms, "
            f"bound {bound:.5f} ms")
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


def flash_kernel_phase(torch, dev, gen) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_cuda

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

    b, bc, c, kh, d = 8, 8, 4096, 32, 96
    main = flash_case(torch, dev, gen, b, bc, c, kh, 1, d, 0)
    log(f"flash_decode: B={b} Bc={bc} C={c} Kh={kh} D={d} bf16, one sentinel row")
    err = compare("main-path shapes", main, 0)
    small = flash_case(torch, dev, gen, 4, 6, 1000, 8, 2, 128, 300)
    compare("G=2, window=300, C=1000", small, 300)
    q, k, v, k_pos, q_pos, rows = main
    call = lambda: flash_decode_cuda(q, k, v, k_pos, q_pos, rows)  # noqa: E731
    ms, src = device_ms(call, "flash_decode_kernel")
    wall = time_ms(call)
    plain, _ = device_ms(lambda: ref.flash_decode_ref(q, k, v, k_pos, q_pos, rows))
    # Library yardstick, never called by the port: SDPA on gathered rows.
    r = rows.long().clamp(max=bc - 1)
    kg = k[r].permute(0, 2, 1, 3)  # (B, Kh, C, D)
    vg = v[r].permute(0, 2, 1, 3)
    kp = k_pos[r]
    mask = ((kp >= 0) & (kp <= q_pos[:, None].long()))[:, None, None, :]
    qs = q[:, :, None, :]
    lib, _ = device_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask))
    valid = int(((kp >= 0) & (kp <= q_pos[:, None])).sum())
    h = q.shape[1]
    nbytes = (2 * q.numel() * 2 + b * c * 4 + 2 * b * 4
              + 2 * valid * kh * d * 2)
    stream_bytes = 2 * q.numel() * 2 + b * c * 4 + 2 * b * c * kh * d * 2
    flops = 4 * valid * (h // kh) * kh * d
    bound = max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3
    log(f"  flash_decode: kernel {ms:.4f} ms on the device ({src}; {wall:.4f} ms between "
        f"CUDA events), plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
        f"bound {bound:.4f} ms over the {valid} valid slots "
        f"({stream_bytes / HBM_BPS * 1e3:.4f} ms to stream all {b * c})")
    return [dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:99", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS else "operations",
        library_ms=lib, bound_stream_all_ms=stream_bytes / HBM_BPS * 1e3,
        ms_source=src, wall_ms=wall,
    )]


# ---------------------------------------------------------------- phase 4
def prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
            for _ in range(N_REQ)]


def first_step(torch, srv, sync_check: bool = False):
    """Admit the prompts into fresh caches and decode one step; with
    ``sync_check`` also run one compacted step's dispatch under
    ``set_sync_debug_mode("error")`` (any hidden sync raises)."""
    from repro_torch.serving import RequestScheduler

    sched = RequestScheduler(srv, SLOTS, CONTEXT)
    for p in prompts(srv.cfg):
        sched.submit(p, NEW_TOKENS)
    rep = sched.step()
    res = rep.server_report.tier_result
    out = dict(tokens=res.tokens.copy(), exited=res.exited.copy(),
               ents={l: e.copy() for l, e in res.branch_entropy.items()},
               takes={l: t.copy() for l, t in res.branch_take.items()},
               logits=res.last_logits.float().clone())
    if sync_check:
        ex = srv.executor
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pos_t = ex._upload(sched.pos.copy(), torch.int32)
            exited0 = ex._upload(~sched.active, torch.bool)
            ex.dispatch(sched.tok_dev, pos_t, sched.caches,
                        {1: SLOTS // 2}, exited0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log("  ok: one compacted step's dispatch ran under "
            "set_sync_debug_mode('error') with no hidden sync")
    del sched
    torch.cuda.empty_cache()
    return out


def serve(torch, srv, n_tokens: int, label: str) -> dict:
    """Submit the requests and run them through ``run``; launch counts
    are reset just before and read just after."""
    from repro_torch.kernels import ops

    ex = srv.executor
    syncs0, retries0 = ex.host_syncs, ex.overflow_retries
    for p in prompts(srv.cfg):
        srv.submit(p, n_tokens)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    step_s, reports = [], []
    while srv.scheduler.queue or srv.scheduler.active.any():
        ts = time.perf_counter()
        reports += srv.run(max_steps=1)
        step_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    sched = srv.scheduler
    results = [sched.results[r] for r in sched.finished]
    syncs, retries = ex.host_syncs - syncs0, ex.overflow_retries - retries0
    check(len(results) == N_REQ and all(len(r.tokens) == n_tokens for r in results),
          f"{label}: all {N_REQ} requests got {n_tokens} tokens")
    check(all(0 <= t < srv.cfg.vocab_size for r in results for t in r.tokens),
          f"{label}: every token inside the vocabulary")
    check(syncs == sched.decode_steps + retries,
          f"{label}: host syncs {syncs} == decode steps "
          f"{sched.decode_steps} + overflow retries {retries}")
    last = reports[-1].server_report.tier_result.last_logits
    check(bool(torch.isfinite(last).all()) and tuple(last.shape) ==
          (SLOTS, srv.cfg.padded_vocab_size), f"{label}: final logits finite, (8, V)")
    exits = sum(sum(r.exited) for r in results)
    buckets = sorted({c.bucket for rep in reports
                      for c in rep.server_report.compaction})
    decode_ms = statistics.median(s * 1e3 for s in step_s[1:])
    ttft = statistics.median(r.ttft_s for r in results)
    out = dict(label=label, launches=launches, exits=int(exits),
               tokens=N_REQ * n_tokens, wall_s=wall, ttft_s=ttft,
               decode_step_ms=decode_ms,
               tokens_per_s=N_REQ * n_tokens / wall, cloud_buckets=buckets,
               overflow_retries=retries)
    log(f"  {label}: {json.dumps(out)}")
    return out


def profile_decode(torch, srv, steps: int = 3) -> dict:
    """Device busy share and the largest device consumers over ``steps``
    steady decode steps (after admission and one warm step)."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts(srv.cfg):
        srv.submit(p, steps + 3)
    srv.run(max_steps=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run(max_steps=steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    srv.run()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
               device_ms_per_step=busy / steps / 1e3,
               device_idle_share=1.0 - busy / wall_us if wall_us else None,
               top_device_ms_per_step=[(n[:80], t / steps / 1e3) for n, t in top])
    log(f"  profiled decode: {json.dumps(out)}")
    return out


def e2e_phase(torch, dev) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import PartitionedServer

    cfg0 = get_config("phi3_mini_3_8b")
    log(f"end to end: {cfg0.name} full width and depth ({cfg0.num_layers} layers, "
        f"d_model {cfg0.d_model}, branches {cfg0.branch_layers}), split {SPLIT}, "
        f"{SLOTS} slots x {CONTEXT}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg0, gen, dev)
    cfg_a = dataclasses.replace(cfg0, exit_threshold=0.5)
    srv = PartitionedServer(cfg_a, params, SPLIT, device=dev, slots=SLOTS,
                            context_len=CONTEXT)
    wparams = srv.params  # bf16 compute copies; every later server shares them
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  params ready in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    check(srv.executor.use_kernels, "the server resolved use_kernels=None to the kernels")

    # First decode step: kernel path vs plain path on the same card.
    kern = first_step(torch, srv, sync_check=True)
    plain_srv = PartitionedServer(cfg_a, wparams, SPLIT, device=dev,
                                  use_kernels=False, slots=SLOTS,
                                  context_len=CONTEXT)
    plain = first_step(torch, plain_srv)
    del plain_srv
    # The two paths share the prefill and differ only in the decode step's
    # kernels, each within about one bf16 ulp of its plain version, so the
    # main-head logits may differ by a few bf16 ulps at their own scale; a
    # wrong kernel anywhere in the 32 layers moves them by O(their scale).
    scale = float(plain["logits"].abs().max())
    dlog_tol = 8 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    dlog = float((kern["logits"] - plain["logits"]).abs().max())
    check(dlog <= dlog_tol,
          f"first step: max |d logit| kernel vs plain {dlog:.4g} <= {dlog_tol:.4g} "
          f"(8 bf16 ulps at the logits' scale, max |logit| {scale:.3f})")
    top2 = plain["logits"].topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    # With every logit within dlog of the other path's, only a row whose
    # top-2 gap is at most 2 x dlog can change its argmax.
    edge = gap <= 2 * dlog
    same = kern["tokens"] == plain["tokens"]
    log(f"  rows at a near-tie (top-2 gap <= 2 x {dlog:.4g}), where the "
        f"paths may pick either token: {edge.nonzero()[0].tolist()}")
    check(bool((same | edge).all()),
          "first-step tokens equal on every row not at a near-tie "
          f"(differ on {(~same).nonzero()[0].tolist()})")
    thr = float(statistics.median(plain["ents"][8].tolist()))
    for layer in plain["ents"]:
        de = abs(kern["ents"][layer] - plain["ents"][layer])
        check(float(de.max()) < 1e-4,
              f"branch {layer}: |dH| kernel vs plain {float(de.max()):.3g} < 1e-4")

    run_a = serve(torch, srv, NEW_TOKENS, "threshold 0.5")
    check(run_a["launches"]["flash_decode"] > 0
          and run_a["launches"]["entropy_exit_argmax_heads"] > 0,
          f"threshold 0.5: both kernels launched {run_a['launches']}")
    prof_a = profile_decode(torch, srv)
    del srv
    torch.cuda.empty_cache()

    cfg_b = dataclasses.replace(cfg0, exit_threshold=thr)
    srv = PartitionedServer(cfg_b, wparams, SPLIT, device=dev, slots=SLOTS,
                            context_len=CONTEXT)
    # First step at the median threshold: the exit kernel's own flags pick
    # the rows that exit on the edge, against the plain path's.
    kern_b = first_step(torch, srv)
    plain_srv = PartitionedServer(cfg_b, wparams, SPLIT, device=dev,
                                  use_kernels=False, slots=SLOTS,
                                  context_len=CONTEXT)
    plain_b = first_step(torch, plain_srv)
    del plain_srv
    # A row within 1e-4 of the threshold (several times the paths' |dH|) at
    # a branch may exit on either path; such rows are listed, not compared.
    near = np.zeros(SLOTS, bool)
    for e in plain_b["ents"].values():
        near |= np.abs(e - thr) < 1e-4
    far = ~near
    masks_equal = bool((kern_b["exited"] == plain_b["exited"])[far].all()) and all(
        bool((kern_b["takes"][l] == plain_b["takes"][l])[far].all())
        for l in plain_b["takes"])
    check(bool(plain_b["exited"].any()),
          f"median threshold, first step: rows exit on the edge "
          f"({plain_b['exited'].astype(int).tolist()})")
    check(masks_equal,
          f"median threshold, first step: exit masks and per-branch takes "
          f"kernel vs plain equal away from |H - thr| < 1e-4 "
          f"(rows at the edge: {near.nonzero()[0].tolist()})")
    stay = far & ~plain_b["exited"]
    top2 = plain_b["logits"].topk(2, dim=-1).values
    row_dlog = (kern_b["logits"] - plain_b["logits"]).abs().amax(dim=-1).cpu().numpy()
    dlog_b = float(row_dlog[stay].max()) if stay.any() else 0.0
    check(dlog_b <= dlog_tol, "median threshold, first step: max |d logit| on "
          f"rows that stay {dlog_b:.4g} <= {dlog_tol:.4g}")
    edge_b = (top2[:, 0] - top2[:, 1]).cpu().numpy() <= 2 * dlog_b
    same_b = kern_b["tokens"] == plain_b["tokens"]
    check(bool((same_b | edge_b | ~stay).all()),
          "median threshold, first step: main-head tokens equal on rows that "
          f"stay, away from near-ties (near-tie rows: "
          f"{(edge_b & stay).nonzero()[0].tolist()})")
    log(f"  exit tokens (branch argmax) equal on {int((same_b & ~stay).sum())} of "
        f"{int((~stay).sum())} exited or edge rows; not asserted: the branch "
        "logits' top-2 gaps are not fetched")
    run_b = serve(torch, srv, NEW_TOKENS, f"threshold {thr:.6f}")
    check(run_b["exits"] > 0 and min(run_b["cloud_buckets"]) < SLOTS,
          "median threshold: rows exit on the edge and the cloud runs "
          f"compacted buckets {run_b['cloud_buckets']}")
    check(run_b["launches"]["flash_decode"] > 0
          and run_b["launches"]["entropy_exit_argmax_heads"] > 0,
          f"median threshold: both kernels launched {run_b['launches']}")
    del srv
    torch.cuda.empty_cache()

    srv = PartitionedServer(cfg_b, wparams, SPLIT, device=dev, slots=SLOTS,
                            context_len=CONTEXT, heads_batched=False)
    run_c = serve(torch, srv, 4, "single-head exits")
    check(run_c["launches"]["entropy_exit_argmax"] > 0
          and run_c["launches"]["entropy_exit_argmax_heads"] == 0,
          f"heads_batched=False: the single-head kernel launched {run_c['launches']}")
    del srv
    torch.cuda.empty_cache()
    return dict(a=run_a, b=run_b, c=run_c, profile=prof_a,
                first_step_max_dlogit=dlog)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

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
    kernels = exit_kernel_phase(torch, dev, gen) + flash_kernel_phase(torch, dev, gen)
    e2e = e2e_phase(torch, dev)
    for row in kernels:
        run = e2e["c"] if row["name"] == "entropy_exit_argmax" else e2e["a"]
        row["launches"] = run["launches"][row["name"]]
    log(f"summary: {json.dumps(dict(device=name, nvidia_smi=smi, total_s=time.perf_counter() - t_start, runs=[e2e['a'], e2e['b'], e2e['c']], profile=e2e['profile']))}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
