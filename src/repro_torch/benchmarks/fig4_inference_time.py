"""Paper Fig. 4: E[T_inf] vs side-branch exit probability, for 3G/4G/Wi-Fi
uplinks and edge slowdown factors gamma in {10, 100, 1000}.  Counterpart
of ``benchmarks/fig4_inference_time.py``, on a given profile.

The paper's claims, as the reference states them:

  * inference time is monotone non-increasing in p (the cost model
    guarantees it for any profile);
  * at p == 1 all three networks coincide (nothing is ever shipped);
  * lower-bandwidth uplinks benefit more from p (the ordering of the
    reductions 3G >= 4G >= Wi-Fi; the values follow the layer times);
  * the whole figure is ONE batched shortest-path solve
    (``solve_chain_torch`` over every network, gamma and p at once, in
    float64), where the paper runs Dijkstra per point.

    python -m repro_torch.benchmarks.fig4_inference_time [--device cpu] [--profile PATH]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.benchmarks.alexnet_profile import (
    BRANCH_AFTER,
    chain_arrays,
    costs_from_args,
)
from repro_torch.core import UPLINK_PRESETS, solve_chain_torch
from repro_torch.kernels.ops import resolve_device

__all__ = ["GAMMAS", "NETWORKS", "BRANCH_AFTER", "N_POINTS", "sweep", "validate", "run"]

GAMMAS = (10.0, 100.0, 1000.0)
NETWORKS = ("3g", "4g", "wifi")
N_POINTS = 101  # p in linspace(0, 1)


def sweep(costs, device=None) -> dict:
    """{(net, gamma): (ps, expected_times, splits)} as numpy arrays, for
    the 101 exit probabilities p of the branch after conv1: one
    ``solve_chain_torch`` call on ``device`` (default: the current CUDA
    device) solves all 3 x 3 x 101 points."""
    device = resolve_device(device)
    f64 = torch.float64
    t_c, alpha = chain_arrays(costs, device)
    ps = torch.linspace(0.0, 1.0, N_POINTS, dtype=f64, device=device)
    p = torch.zeros((N_POINTS, t_c.shape[0]), dtype=f64, device=device)
    p[:, BRANCH_AFTER] = ps
    bw = torch.tensor([UPLINK_PRESETS[n].bandwidth_bps for n in NETWORKS],
                      dtype=f64, device=device)
    gamma = torch.tensor(GAMMAS, dtype=f64, device=device)
    s, t = solve_chain_torch(t_c, alpha, p, gamma[None, :, None], bw[:, None, None])
    ps, s, t = ps.cpu().numpy(), s.cpu().numpy(), t.cpu().numpy()
    return {(net, g): (ps, t[i, j], s[i, j])
            for i, net in enumerate(NETWORKS) for j, g in enumerate(GAMMAS)}


def validate(results) -> dict:
    """The paper's claims, checked numerically (the reference's report)."""
    report = {}
    for g in GAMMAS:
        t_at_1 = [results[(net, g)][1][-1] for net in NETWORKS]
        report[f"p1_equal_gamma{int(g)}"] = bool(
            np.allclose(t_at_1, t_at_1[0], rtol=1e-6))
        reductions = {}
        for net in NETWORKS:
            t = results[(net, g)][1]
            report[f"monotone_{net}_gamma{int(g)}"] = bool(np.all(np.diff(t) <= 1e-12))
            reductions[net] = float((t[0] - t[-1]) / t[0] * 100.0)
        report[f"reduction_pct_gamma{int(g)}"] = reductions
        report[f"ordering_3g>=4g>=wifi_gamma{int(g)}"] = bool(
            reductions["3g"] >= reductions["4g"] >= reductions["wifi"] - 1e-9)
    return report


def run(costs, device=None) -> list[str]:
    """The reference's rows: microseconds per solved point, then the
    reductions and claims per gamma."""
    t0 = time.perf_counter()
    results = sweep(costs, device)
    dt = (time.perf_counter() - t0) * 1e6
    report = validate(results)
    n_pts = sum(len(v[0]) for v in results.values())
    rows = [f"fig4/full_sweep,{dt / max(n_pts, 1):.2f},points={n_pts}"]
    for g in GAMMAS:
        red = report[f"reduction_pct_gamma{int(g)}"]
        rows.append(
            f"fig4/reduction_gamma{int(g)},0.0,"
            f"3g={red['3g']:.2f}%;4g={red['4g']:.2f}%;wifi={red['wifi']:.2f}%;"
            f"p1_equal={report[f'p1_equal_gamma{int(g)}']};"
            f"ordering={report[f'ordering_3g>=4g>=wifi_gamma{int(g)}']}")
    return rows


if __name__ == "__main__":
    costs, device = costs_from_args(__doc__.splitlines()[0])
    for r in run(costs, device):
        print(r)
