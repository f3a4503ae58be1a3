#!/usr/bin/env python3
"""The exit kernel and its plain version against an earlier revision of
each, in one process on one card.

    git show <commit>:src/repro_torch/kernels/csrc/entropy_exit.cu > build/entropy_exit_parent.cu
    python3 experiments/exit_kernel_ab.py [--parent build/entropy_exit_parent.cu]

Builds ``src/repro_torch/kernels/csrc/entropy_exit.cu`` as it is and the
``--parent`` source (the same plain C interface, with or without the
``split`` argument: one with a single-block-per-row kernel takes none) into
``build/experiments``, checks that both agree with the plain version at
the exit phase's shapes (H within 1e-5, tokens exact), and times them in
the order parent, now, now, parent: ``torch.profiler`` device time of the
kernel over 50 calls, the median of 5 repeats, at K=2, B=8, V=32064 (row
1 of PERF.md's table), its K=1 launch (row 2) and the no-argmax form at
B=8, V=50432 with 152 pad lanes (row 6).  The plain versions are timed
the same way with the exit entropy as ``exp(log_softmax)`` (before) and as
the repository's ``normalized_entropy`` (softmax with log_softmax), in the
order before, now, now, before, summing every device kernel of the call.
Needs one CUDA card and ``nvcc``; the last line is a JSON object with the
times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def build_both(build_mod, parent: Path) -> dict[str, Path]:
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"now": build_mod.source_path("entropy_exit"), "parent": parent}
    procs = {}
    for name, cu in sources.items():
        lib = out_dir / f"libentropy_exit_{name}.so"
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


def exp_logp_entropy(logits, dim=-1):
    """The plain exit entropy before the first-call fix."""
    import torch

    logp = torch.log_softmax(logits.float(), dim=dim)
    return -(torch.exp(logp) * logp).sum(dim=dim) / math.log(logits.shape[dim])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "entropy_exit_parent.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import entropy_exit as ee
    from repro_torch.kernels import ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    fns = {}
    parent_has_split = "int split" in args.parent.read_text()
    for name, lib in build_both(build_mod, args.parent).items():
        cdll = ctypes.CDLL(str(lib))
        fns[name] = {}
        for sym in ("entropy_exit_argmax_bf16", "entropy_exit_bf16"):
            f = getattr(cdll, sym)
            argtypes = list(ee._ARGTYPES[sym])
            f.restype = ctypes.c_int
            if name == "parent" and not parent_has_split:
                # the split sits before log_v; an older source takes none
                del argtypes[-3]
                f.argtypes = argtypes
                fns[name][sym] = lambda *a, f=f: f(*a[:-3], *a[-2:])
            else:
                f.argtypes = argtypes
                fns[name][sym] = f

    gen = torch.Generator(device="cuda").manual_seed(0)
    heads = (torch.randn((2, 8, 32064), generator=gen, device="cuda") * 4).to(torch.bfloat16)
    heads[0, 0, -64:] = -1e30
    wide = (torch.randn((8, 50432), generator=gen, device="cuda") * 4).to(torch.bfloat16)
    wide[:, -152:] = -1e30
    thr = ref.entropy_exit_argmax_heads_ref(heads, 0.5)[0].median(dim=1).values.float()
    wthr = float(ref.entropy_exit_ref(wide, 0.5)[0].median())
    cases = {
        "row 1: entropy_exit_argmax_heads K=2 B=8 V=32064":
            (lambda: ee.entropy_exit_argmax_heads_cuda(heads, thr),
             lambda: ref.entropy_exit_argmax_heads_ref(heads, thr)),
        "row 2: entropy_exit_argmax K=1 B=8 V=32064":
            (lambda: ee.entropy_exit_argmax_heads_cuda(heads[:1], thr[:1]),
             lambda: ref.entropy_exit_argmax_heads_ref(heads[:1], thr[:1])),
        "row 6: entropy_exit B=8 V=50432, 152 pad lanes":
            (lambda: ee.entropy_exit_cuda(wide, wthr),
             lambda: ref.entropy_exit_ref(wide, wthr)),
    }

    def use_kernel(name):
        ee._fns.update(fns[name])

    def use_plain(name):
        ref.normalized_entropy = (exp_logp_entropy if name == "before"
                                  else ref_entropy)

    ref_entropy = ref.normalized_entropy
    for case, (kern, plain) in cases.items():
        use_plain("now")
        want = plain()
        for name in fns:
            use_kernel(name)
            got = kern()
            torch.cuda.synchronize()
            dh = float((got[0] - want[0]).abs().max())
            tokens = "no tokens" if len(got) < 3 else (
                "tokens exact" if torch.equal(got[2], want[2]) else "tokens differ")
            if dh > 1e-5 or tokens == "tokens differ":
                raise SystemExit(f"FAILED: {case}, {name} kernel: |dH| {dh:.3g}, {tokens}")
            print(f"ok: {case}, {name} kernel: |dH| {dh:.3g} <= 1e-5, {tokens}")

    def device_ms(fn, match, calls=50, repeats=5):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and (match is None or match in e.name))
            times.append(us / calls / 1e3)
        return statistics.median(times)

    result = {"card": card, "kernel_ms": {}, "plain_ms": {}}
    for case, (kern, plain) in cases.items():
        ks = {"parent": [], "now": []}
        for name in ("parent", "now", "now", "parent"):
            use_kernel(name)
            ks[name].append(device_ms(kern, "entropy_exit_argmax_kernel"))
        ps = {"before": [], "now": []}
        for name in ("before", "now", "now", "before"):
            use_plain(name)
            ps[name].append(device_ms(plain, None))
        use_plain("now")
        result["kernel_ms"][case], result["plain_ms"][case] = ks, ps
        print(f"{case}: kernel parent {ks['parent']} now {ks['now']} ms; plain "
              f"exp(log_softmax) {ps['before']} softmax {ps['now']} ms")
    use_kernel("now")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
