#!/usr/bin/env python3
"""Does the plain exit entropy drift on its first call in a fresh process?

    python3 experiments/exit_plain_first_call.py [--procs 48] [--at-once 2]
        [--forms exp_logp,repo,split_emulation]

The plain version of the exit kernels is
``repro_torch.core.calibration.normalized_entropy``.  On a CPU, its first
call in a fresh process has been seen to differ from its second call in
the same process by more than the CPU tests' 1e-5 bound on H.  This
script starts ``--procs`` fresh processes for each form under test,
``--at-once`` of them together, the forms in turn.  Each child makes the
``(K, B, V) = (2, 8, 1000)`` bf16 logits of the CPU test
``TestEntropyExitHeads::test_plain_matches_reference`` (numpy seed 2008,
the test's ``k * v + b``), starts torch's intra-op thread pool with one
parallel multiply (as any earlier work in a process does), calls the form
twice, and compares the first call with the second and with a float64
computation in numpy.

What it shows: with the thread pool up, the first float32 ``torch.exp``
of a process can come back about 1.5e-4 off (relative) on one thread's
contiguous share of the elements, and exact on every later call.  On a
CPU build with MKL, ``torch.exp`` goes to MKL's vector math library in
chunks per thread; ``torch.softmax`` and ``torch.log_softmax`` compute
their exponentials in their own vectorised loops.  Few processes at once
show it more often than many: with every core busy, the pool's threads
seldom enter that first call together.

Forms:
  * ``exp_logp`` — p = exp(log_softmax(l)), H = -sum p log p: the plain
    version before the fix, spelled out here;
  * ``repo`` — the repository's ``normalized_entropy`` as it stands (the
    fix: p = softmax(l), logp = log_softmax(l));
  * ``split_emulation`` — the CPU tests' emulation of the exit kernel's
    split-and-merge algorithm (``tests/test_torch_kernels.py``
    ``_exit_split_merge``, imported from the test file as it stands, with
    JAX on the CPU as the tests run it), called on every case of
    ``TestEntropyExitSplit`` in the test's order: the process's first call
    is the first pass over the cases, the second call the second pass.

A process *deviates* when its first call is more than ``--tol`` (1e-6)
from the float64 value or from its own second call.  For ``exp_logp`` the
report also gives, per process whose first ``torch.exp`` was off, its
largest relative error and the span of elements more than 1e-6 off.  The last line is a
JSON object with the counts per form.  CPU only; each child takes about
200 MB; the default run takes about four minutes.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def logits_np():
    """The CPU test's (2, 8, 1000) case, as ``tests/test_torch_kernels.py``
    ``_logits(2, 8, 1000, seed=2008)`` makes it."""
    import numpy as np

    k, b, v = 2, 8, 1000
    rng = np.random.default_rng(k * v + b)
    x = (rng.standard_normal((k, b, v)) * 4).astype(np.float32)
    x[0, 0, -24:] = -1e30
    x[-1, 1, [3, v - 5]] = 40.0
    x[0, b - 1, [7, 9]] = 40.0
    return x


def split_emulation():
    """(call, logits): the test file's split emulation over its cases."""
    import importlib.util
    import os

    import torch

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location(
        "test_torch_kernels", ROOT / "tests" / "test_torch_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    xs = [torch.from_numpy(mod._exit_case(kind)).bfloat16() for kind in mod.EXIT_KINDS]

    def call(_):
        return torch.cat([mod._exit_split_merge(x, 0.5)[0].reshape(-1) for x in xs])

    return call, xs


def form(name: str):
    import torch

    if name == "repo":
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.core.calibration import normalized_entropy

        return normalized_entropy

    def exp_logp(logits):
        logp = torch.log_softmax(logits.float(), dim=-1)
        p = torch.exp(logp)
        exp_calls.append((logp, p))
        return -(p * logp).sum(dim=-1) / math.log(logits.shape[-1])

    if name != "exp_logp":
        raise SystemExit(f"unknown form {name!r}")
    return exp_logp


exp_calls: list = []  # (argument, result) of each exp_logp torch.exp


def exp_report():
    """Where the first ``torch.exp`` of exp_logp went wrong: its largest
    relative error against float64 and the span of flat indices more than
    1e-6 off."""
    import numpy as np

    if not exp_calls:
        return {}
    arg, got = (t.numpy().ravel() for t in exp_calls[0])
    want = np.exp(arg.astype(np.float64))
    rel = np.abs(got - want) / np.maximum(want, 1e-300)
    rel[want == 0] = 0.0
    bad = np.nonzero(rel > 1e-6)[0]
    return dict(exp_max_rel_err=float(rel.max()), exp_elems_off=int(bad.size),
                exp_span=[int(bad.min()), int(bad.max())] if bad.size else None)


def f64_entropy(x):
    """H / log V in float64, in numpy (no torch kernel, which could itself
    be a first call)."""
    import numpy as np

    lf = x.float().numpy().astype(np.float64)
    z = lf - lf.max(axis=-1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
    return -(np.exp(lp) * lp).sum(axis=-1) / math.log(x.shape[-1])


def child(name: str) -> None:
    import numpy as np
    import torch

    if name == "split_emulation":
        fn, xs = split_emulation()
        x = None
    else:
        fn, x = form(name), torch.from_numpy(logits_np()).bfloat16()
    # Earlier work in the process (a test file's other tests, a server's
    # set-up) has started the intra-op thread pool: one parallel
    # elementwise op that computes no exponential does the same here.
    torch.ones(1 << 22).mul_(2.0)
    first = fn(x).numpy()
    second = fn(x).numpy()
    f64 = (f64_entropy(x) if x is not None
           else np.concatenate([f64_entropy(xi).reshape(-1) for xi in xs]))
    print(json.dumps(dict(
        first_vs_second=float(np.abs(first - second).max()),
        first_vs_f64=float(np.abs(first - f64).max()),
        second_vs_f64=float(np.abs(second - f64).max()), **exp_report())))


def run_batch(name: str, n: int) -> list[dict]:
    procs = [subprocess.Popen([sys.executable, __file__, "--child", name],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    outs = [p.communicate() for p in procs]
    for p, (_, err) in zip(procs, outs):
        if p.returncode:
            raise SystemExit(f"FAILED: a child of {name} exited {p.returncode}:\n{err}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=48, help="fresh processes per form")
    ap.add_argument("--at-once", type=int, default=2, help="processes started together")
    ap.add_argument("--forms", default="exp_logp,repo")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    forms = args.forms.split(",")
    res: dict[str, list[dict]] = {f: [] for f in forms}
    while any(len(r) < args.procs for r in res.values()):
        for f in forms:  # the forms in turn, batch by batch: the same load
            res[f] += run_batch(f, min(args.at_once, args.procs - len(res[f])))
    stats = {}
    for f, rs in res.items():
        dev = [max(r["first_vs_f64"], r["first_vs_second"]) for r in rs]
        stats[f] = dict(
            procs=len(rs), deviate=sum(d > args.tol for d in dev),
            worst_first_vs_f64=max(r["first_vs_f64"] for r in rs),
            worst_first_vs_second=max(r["first_vs_second"] for r in rs),
            worst_second_vs_f64=max(r["second_vs_f64"] for r in rs),
            deviations=sorted((d for d in dev if d > args.tol), reverse=True),
            first_exp_off=[{k: r[k] for k in ("exp_max_rel_err", "exp_elems_off",
                                              "exp_span")}
                           for r in rs if r.get("exp_elems_off")])
        print(f"{f}: first call deviates (> {args.tol:g}) in {stats[f]['deviate']} of "
              f"{len(rs)} fresh processes; worst |dH| first vs float64 "
              f"{stats[f]['worst_first_vs_f64']:.3g}, first vs second "
              f"{stats[f]['worst_first_vs_second']:.3g}, second vs float64 "
              f"{stats[f]['worst_second_vs_f64']:.3g}")
    print(json.dumps(dict(case="exp_logp, repo: (2, 8, 1000) bf16, seed 2008; "
                          "split_emulation: the EXIT_KINDS cases", tol=args.tol,
                          at_once=args.at_once, forms=stats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
