#!/usr/bin/env python3
"""Does ``ssd_scan``'s double-buffered staging pay for itself?

    python3 experiments/ssd_scan_staging.py

At Zamba2-1.2B's admission shape (N = 64) the scan kernel in
``src/repro_torch/kernels/csrc/ssd_scan.cu`` stages the next chunk into a
second shared-memory buffer while the current one computes (``nbuf = 2``,
two blocks per SM).  This script builds the source as it is and a copy
whose launcher passes ``nbuf = 1`` (chunks staged in turn) while keeping
the two-buffer allocation, so both run at two blocks per SM and differ in
the staging alone.  It checks that the two give bitwise equal outputs and
times them on the card in the order as-is, in turn, in turn, as-is
(``torch.profiler`` device time of the kernel over 50 calls on four
rotating input sets, the median of 5 repeats).  Needs one CUDA card and
``nvcc``; the builds go to ``build/experiments``.  The last line is a JSON object with the times.
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def variants(build_mod) -> dict[str, Path]:
    """Write and compile the two sources; returns {variant: library}."""
    src = build_mod.source_path("ssd_scan").read_text()
    as_is = "  int nbuf = 2;\n"
    if src.count(as_is) != 1:
        raise SystemExit("FAILED: the launcher's `int nbuf = 2;` line is not there once")
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {"double_buffer": src, "in_turn_2_blocks": src.replace(as_is, "  int nbuf = 1;\n")}
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"ssd_scan_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libssd_scan_{name}.so"
        procs[name] = (subprocess.Popen(
            [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"FAILED: build of {name}:\n{log}")
        libs[name] = lib
    return libs


def inputs(torch, gen, b=8, l=128, h=64, p=64, n=64, g=1):
    """Zamba2-1.2B's admission inputs, as chip_smoke.py makes them: bf16 B
    and C sliced from one xBC activation."""
    inner = h * p
    xbc = (torch.randn((b, l, inner + 2 * g * n), generator=gen, device="cuda")
           * 0.5).to(torch.bfloat16)
    bm = xbc[..., inner:inner + g * n].reshape(b, l, g, n)
    cm = xbc[..., inner + g * n:].reshape(b, l, g, n)
    dt = torch.rand((b, l, h), generator=gen, device="cuda") * 0.1 + 1e-3
    a_log = torch.rand((h,), generator=gen, device="cuda") * math.log(16.0)
    x = torch.randn((b, l, h, p), generator=gen, device="cuda") * dt[..., None]
    return x, -dt * torch.exp(a_log), bm, cm


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import ssd_scan as scan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    fns = {}
    for name, lib in variants(build_mod).items():
        f = ctypes.CDLL(str(lib)).ssd_scan
        f.argtypes = scan._ARGTYPES["ssd_scan"]
        f.restype = ctypes.c_int
        fns[name] = f

    def run(name, args):
        scan._fns["ssd_scan"] = fns[name]
        return scan.ssd_scan_cuda(*args, chunk=scan.SCAN_CHUNK)

    gen = torch.Generator(device="cuda").manual_seed(0)
    sets = [inputs(torch, gen) for _ in range(4)]
    ya, ha = run("double_buffer", sets[0])
    yb, hb = run("in_turn_2_blocks", sets[0])
    torch.cuda.synchronize()
    if not (torch.equal(ya, yb) and torch.equal(ha, hb)):
        raise SystemExit("FAILED: the two stagings disagree")
    print("ok: the two stagings give bitwise equal y and final state")

    def time_ms(name, calls=50, repeats=5):
        """Median over repeats of the profiler's ssd_scan_kernel device time
        per call (host launch gaps left out)."""
        from torch.profiler import ProfilerActivity, profile

        for i in range(3):
            run(name, sets[i % 4])
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(calls):
                    run(name, sets[i % 4])
                torch.cuda.synchronize()
            us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "ssd_scan_kernel" in e.name)
            times.append(us / calls / 1e3)
        return statistics.median(times)

    order = ["double_buffer", "in_turn_2_blocks", "in_turn_2_blocks", "double_buffer"]
    times = {name: [] for name in fns}
    for name in order:
        ms = time_ms(name)
        times[name].append(ms)
        print(f"{name}: {ms:.5f} ms per call")
    print(json.dumps({"card": card, "shape": "B=8 L=128 H=64 P=64 N=64 G=1 bf16 B/C",
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
