"""The paper's sensitivity analysis (Figs. 4 and 5) end to end, as ASCII
plots — counterpart of ``examples/partition_sweep.py``.  Each figure is
one batched ``solve_chain_torch`` call over B-AlexNet's profile.

    python -m repro_torch.examples.partition_sweep [--device cpu] [--profile PATH]

profiles B-AlexNet now on ``--device`` (default: the current CUDA
device), or solves on a profile that ``python -m
repro_torch.benchmarks.alexnet_profile --out PATH`` wrote.
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.alexnet_profile import costs_from_args
from repro_torch.benchmarks.fig4_inference_time import GAMMAS, NETWORKS, validate
from repro_torch.benchmarks.fig4_inference_time import sweep as sweep4
from repro_torch.benchmarks.fig5_partition_layer import PROBS
from repro_torch.benchmarks.fig5_partition_layer import sweep as sweep5

__all__ = ["ascii_plot", "main"]


def ascii_plot(xs, series: dict, width=64, height=12, xlab="", ylab=""):
    lo = min(float(np.min(v)) for v in series.values())
    hi = max(float(np.max(v)) for v in series.values())
    hi = hi if hi > lo else lo + 1
    grid = [[" "] * width for _ in range(height)]
    marks = "ox+*#@"
    for (name, ys), mark in zip(series.items(), marks):
        for x, y in zip(xs, ys):
            col = int((x - xs[0]) / (xs[-1] - xs[0] + 1e-12) * (width - 1))
            row = height - 1 - int((y - lo) / (hi - lo) * (height - 1))
            grid[row][col] = mark
    print(f"  {ylab} [{lo:.3g} .. {hi:.3g}]")
    for row in grid:
        print("  |" + "".join(row))
    print("  +" + "-" * width + f"> {xlab}")
    for (name, _), mark in zip(series.items(), marks):
        print(f"    {mark} = {name}")


def main(argv=None) -> dict:
    costs, device = costs_from_args(__doc__.splitlines()[0], argv)
    print("=== Fig. 4: E[T_inf] vs exit probability (gamma = 10) ===")
    res = sweep4(costs, device)
    ps = res[("3g", 10.0)][0]
    ascii_plot(ps, {net: res[(net, 10.0)][1] for net in NETWORKS},
               xlab="p(exit at branch)", ylab="E[T] s")
    rep = validate(res)
    for g in GAMMAS:
        r = rep[f"reduction_pct_gamma{int(g)}"]
        print(f"  gamma={g:6.0f}: time reduction p0->p1: "
              f"3G {r['3g']:.1f}%  4G {r['4g']:.1f}%  WiFi {r['wifi']:.1f}%")
    print("  (paper, gamma=10: 87.27% / 82.98% / 70%)")

    print("\n=== Fig. 5: chosen partition layer vs gamma (3G) ===")
    res5 = sweep5(costs, device)
    gs = res5[("3g", PROBS[0])][0]
    ascii_plot(np.log10(gs), {f"p={p}": res5[("3g", p)][1] for p in PROBS},
               xlab="log10 gamma", ylab="split layer")
    return dict(fig4=rep, fig5_splits_3g={p: res5[("3g", p)][1] for p in PROBS})


if __name__ == "__main__":
    main()
