#!/usr/bin/env python3
"""flash_decode against an earlier revision of its source, in one process
on one card.

    git show <commit>:src/repro_torch/kernels/csrc/flash_decode.cu > build/flash_decode_parent.cu
    python3 experiments/flash_decode_ab.py [--parent build/flash_decode_parent.cu]
        [--gqa-splits 64,256]

Builds ``src/repro_torch/kernels/csrc/flash_decode.cu`` as it is, the
``--parent`` source (the same plain C interface; a source without the
grouped route takes every layout on the split route) and, for each size in
``--gqa-splits``, a copy of the current source with the grouped route's
split (``kGqaSplit``) set to that size, into ``build/experiments``, one
``nvcc`` each, all at once.  Checks every build against the fp32 plain
version (one bf16 ulp) at every shape of ``chip_smoke.py``'s
``flash_kernel_phase``: the four G = 1 shapes (serving, phase, D = 64,
B = 1 over a full cache), the four served GQA layouts (Qwen3-8B,
Phi-3-medium, Qwen3-30B-A3B, InternVL2), the two grouped cases with many
valid slots ("G=8 full cache", "G=4 wide") and ``train_branchy``'s decode.
Then times them in turns, parent, now, now, parent (with the split sizes:
parent, now, each size, each size in reverse, now, parent, at the grouped
shapes only, since the others never reach the grouped route):
``torch.profiler`` device time of the two kernels of a call over 30 calls,
the median of 5 windows, on input sets taken in turn so that each call
finds its operands cold; one more window per build splits each call's
time between its two kernels.  SDPA (its GQA mode where query heads share KV
heads, on gathered rows with the validity mask) is timed the same way at
each shape as the library yardstick (the rows gathered before the timed
calls, as ``chip_smoke.py`` times it).  Needs one CUDA card and ``nvcc``;
the last line is a JSON object with the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BF16_ULP = 2.0 ** -7


def build_all(build_mod, parent: Path, gqa_splits: list[int]) -> dict[str, Path]:
    """{name: library}: "now", "parent" and "s<N>" for each split size."""
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    now_src = build_mod.source_path("flash_decode")
    sources = {"now": now_src, "parent": parent}
    text = now_src.read_text()
    pat = re.compile(r"constexpr int kGqaSplit = \d+;")
    if gqa_splits and len(pat.findall(text)) != 1:
        raise SystemExit("FAILED: no single kGqaSplit constant in the source")
    for n in gqa_splits:
        cu = out_dir / f"flash_decode_s{n}.cu"
        cu.write_text(pat.sub(f"constexpr int kGqaSplit = {n};", text))
        sources[f"s{n}"] = cu
    procs = {}
    for name, cu in sources.items():
        lib = out_dir / f"libflash_decode_{name}.so"
        procs[name] = (subprocess.Popen(
            [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"FAILED: build of {name}:\n{log}")
        for line in log.splitlines():
            if name == "now" and ("registers" in line or "spill" in line
                                  or "Compiling entry" in line):
                print(f"ptxas {name}: {line.strip()[-110:]}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "flash_decode_parent.cu")
    ap.add_argument("--gqa-splits", default="",
                    help="comma-separated grouped-route split sizes to time beside now")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    gqa_splits = [int(x) for x in args.gqa_splits.split(",") if x]
    now_split = fd.GQA_SPLIT
    fns = {}
    for name, lib in build_all(build_mod, args.parent, gqa_splits).items():
        f = ctypes.CDLL(str(lib)).flash_decode_bf16
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f
    parent_grouped = "flash_decode_gqa_kernel" in args.parent.read_text()
    route_now = fd.route

    def use(name):
        """Point the launcher at one build, with that build's split plan."""
        fd._lib = fns[name]
        fd.GQA_SPLIT = int(name[1:]) if name.startswith("s") else now_split
        fd.route = (route_now if name != "parent" or parent_grouped
                    else lambda g, d, aligned=True: "split")

    dev = torch.device("cuda", 0)
    c = cs.CONTEXT

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    g0 = gen(cs.SEED)
    serve = [cs.serving_case(torch, dev, g0) for _ in range(4)]
    sk, sv = serve[0][1], serve[0][2]
    full = torch.arange(c, dtype=torch.int32, device=dev).expand(sk.shape[0], c).contiguous()
    one = (serve[0][0][:1], sk, sv, full, torch.tensor([c - 1], dtype=torch.int32, device=dev),
           torch.tensor([3], dtype=torch.int32, device=dev))
    shapes = {
        "serving shape (Kh=32, G=1, D=96)": serve,
        "phase shape (Kh=32, G=1, D=96)": [cs.flash_case(torch, dev, g0, 8, 8, c, 32, 1, 96, 0)],
        "D=64 (Kh=32, G=1)": [cs.flash_case(torch, dev, g0, 8, 8, c, 32, 1, 64, 0)],
        "B=1, all 4096 slots valid (Kh=32, G=1)": [one],
    }
    for label, kh, g, seed in (("Qwen3-8B", 8, 4, 4), ("Phi-3-medium", 10, 4, 9),
                               ("Qwen3-30B-A3B", 4, 8, 10), ("InternVL2", 8, 8, 11)):
        lg = gen(cs.SEED + seed)
        shapes[f"{label} (Kh={kh}, G={g}, D=128)"] = [
            cs.serving_case(torch, dev, lg, kh=kh, d=128, g=g) for _ in range(4)]
    fg = gen(cs.SEED + 12)
    full_sets = []
    for _ in range(8):
        q, k, v, _, _, _ = cs.flash_case(torch, dev, fg, 1, 1, c, 4, 8, 128, 0, sentinel=False)
        full_sets.append((q, k, v, torch.arange(c, dtype=torch.int32, device=dev)
                          .expand(1, c).contiguous(),
                          torch.tensor([c - 1], dtype=torch.int32, device=dev),
                          torch.zeros(1, dtype=torch.int32, device=dev)))
    shapes["G=8 full cache (B=1, Kh=4, G=8, D=128)"] = full_sets
    wg = gen(cs.SEED + 13)
    shapes["G=4 wide (B=8, Kh=8, G=4, D=128)"] = [
        cs.flash_case(torch, dev, wg, 8, 8, c, 8, 4, 128, 0) for _ in range(2)]
    shapes["train_branchy (B=16, Kh=4, G=1, D=64, C=96)"] = [
        cs.flash_case(torch, dev, gen(cs.SEED + 5), 16, 16, 96, 4, 1, 64, 0)]

    for label, sets in shapes.items():
        q, k, v, k_pos, q_pos, rows = sets[0]
        want = ref.flash_decode_ref(q.float(), k.float(), v.float(), k_pos, q_pos, rows)
        for name in fns:
            use(name)
            got = fd.flash_decode_cuda(*sets[0])
            torch.cuda.synchronize()
            err = (got.float() - want).abs()
            if not bool((err <= BF16_ULP * want.abs() + 1e-5).all()):
                raise SystemExit(f"FAILED: {label}, {name}: |out - fp32 plain| beyond one "
                                 f"bf16 ulp (max {float(err.max()):.3g})")
            print(f"ok: {label}, {name}: {fd.call_plan(q, k, v)}, |out - fp32 plain| <= "
                  f"1 bf16 ulp (max {float(err.max()):.3g})")

    def device_ms(fn, match, calls=30, repeats=5):
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

    def by_kernel(fn, calls=30):
        """{kernel name: device ms per call} over one profiled window."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            m = re.search(r"flash_decode_\w+", e.name)
            if m and e.device_type == torch.autograd.DeviceType.CUDA:
                out[m.group(0)] = out.get(m.group(0), 0.0) + e.time_range.elapsed_us() / calls / 1e3
        return out

    def sdpa_inputs(q, k, v, k_pos, q_pos, rows):
        r = rows.long().clamp(max=k.shape[0] - 1)
        kp = k_pos[r]
        mask = ((kp >= 0) & (kp <= q_pos[:, None].long()))[:, None, None, :]
        return (q[:, :, None, :], k[r].permute(0, 2, 1, 3), v[r].permute(0, 2, 1, 3),
                mask, q.shape[1] != k.shape[2])

    def sdpa(qs, kg, vg, mask, gqa):
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask, enable_gqa=gqa)

    result = {"card": card, "gqa_split_now": now_split, "ms": {}, "sdpa_ms": {},
              "route": {}, "bound_ms": {}, "by_kernel_ms": {}}
    sizes = [f"s{n}" for n in gqa_splits]
    for label, sets in shapes.items():
        q, k, v, k_pos, q_pos, rows = sets[0]
        use("now")
        rt, split, splits = fd.call_plan(q, k, v)
        order = ["parent", "now"] + (sizes if rt == "grouped" else [])
        order = order + order[::-1]
        ms = {name: [] for name in order}
        for name in order:
            use(name)
            ms[name].append(device_ms(cs.rotating(fd.flash_decode_cuda, sets), "flash_decode"))
        split_ms = {}
        for name in dict.fromkeys(order):
            use(name)
            split_ms[name] = by_kernel(cs.rotating(fd.flash_decode_cuda, sets))
        result["by_kernel_ms"][label] = split_ms
        lib = device_ms(cs.rotating(sdpa, [sdpa_inputs(*a) for a in sets]), None)
        nbytes, flops = cs.attn_cost(q, k, k_pos, q_pos, rows)
        bound_ms, _ = cs.bound(nbytes, flops)
        result["ms"][label], result["sdpa_ms"][label] = ms, lib
        result["route"][label] = {"route": rt, "split": split, "splits": splits}
        result["bound_ms"][label] = bound_ms
        par, now = statistics.mean(ms["parent"]), statistics.mean(ms["now"])
        extra = "".join(f", {n} {ms[n]}" for n in sizes if n in ms)
        print(f"{label} [{rt} route, {splits} x {split}]: parent {ms['parent']} now "
              f"{ms['now']}{extra} ms; now / parent {now / par:.3f}; SDPA {lib:.5f} ms "
              f"(now / SDPA {now / lib:.3f}); bound {bound_ms:.5f} ms; by kernel {split_ms}")
    use("now")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
