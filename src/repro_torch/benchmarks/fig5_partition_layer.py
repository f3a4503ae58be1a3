"""Paper Fig. 5: chosen partition layer vs edge slowdown gamma, per exit
probability, for 3G and 4G.  Counterpart of
``benchmarks/fig5_partition_layer.py``, on a given profile.

Claims: as gamma grows the split moves toward the input (cloud-only =
split 0; the cost model guarantees it for any profile); higher bandwidth
(4G) flips to cloud-only at a lower gamma than 3G; higher p keeps layers
on the edge longer (these two follow the layer times).

    python -m repro_torch.benchmarks.fig5_partition_layer [--device cpu] [--profile PATH]
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

__all__ = ["PROBS", "NETWORKS", "BRANCH_AFTER", "N_GAMMA", "sweep", "validate", "run"]

PROBS = (0.0, 0.2, 0.5, 0.8)
NETWORKS = ("3g", "4g")
N_GAMMA = 60  # gamma in logspace(0, 3)


def sweep(costs, device=None) -> dict:
    """{(net, p): (gammas, splits)} as numpy arrays: the optimal split at
    60 log-spaced gammas in [1, 1000] for each exit probability of the
    branch after conv1, all 2 x 4 x 60 points in one ``solve_chain_torch``
    call on ``device`` (default: the current CUDA device)."""
    device = resolve_device(device)
    f64 = torch.float64
    t_c, alpha = chain_arrays(costs, device)
    gammas = torch.logspace(0, 3, N_GAMMA, dtype=f64, device=device)
    p = torch.zeros((len(PROBS), t_c.shape[0]), dtype=f64, device=device)
    p[:, BRANCH_AFTER] = torch.tensor(PROBS, dtype=f64, device=device)
    bw = torch.tensor([UPLINK_PRESETS[n].bandwidth_bps for n in NETWORKS],
                      dtype=f64, device=device)
    s, _ = solve_chain_torch(t_c, alpha, p[:, None, :], gammas, bw[:, None, None])
    gammas, s = gammas.cpu().numpy(), s.cpu().numpy()
    return {(net, q): (gammas, s[i, j])
            for i, net in enumerate(NETWORKS) for j, q in enumerate(PROBS)}


def validate(results) -> dict:
    """The paper's claims, checked numerically (the reference's report)."""
    rep = {}
    for (net, p), (g, s) in results.items():
        # Partition layer moves toward the input as gamma grows (weakly).
        rep[f"monotone_{net}_p{p}"] = bool(np.all(np.diff(s) <= 0))
    # 4G flips to cloud-only no later than 3G (higher bw favors cloud).
    for p in PROBS:
        g3, s3 = results[("3g", p)]
        g4, s4 = results[("4g", p)]
        flip3 = g3[np.argmax(s3 == 0)] if (s3 == 0).any() else np.inf
        flip4 = g4[np.argmax(s4 == 0)] if (s4 == 0).any() else np.inf
        rep[f"4g_flips_first_p{p}"] = bool(flip4 <= flip3)
    return rep


def run(costs, device=None) -> list[str]:
    """The reference's rows: microseconds per curve, then the claims and
    the 3G, p = 0.8 splits at both ends of the gamma range."""
    t0 = time.perf_counter()
    results = sweep(costs, device)
    dt = (time.perf_counter() - t0) * 1e6
    rep = validate(results)
    rows = [f"fig5/sweep,{dt / max(len(results), 1):.2f},curves={len(results)}"]
    ok_mono = all(v for k, v in rep.items() if k.startswith("monotone"))
    ok_flip = all(v for k, v in rep.items() if k.startswith("4g_flips"))
    g, s = results[("3g", 0.8)]
    rows.append(
        f"fig5/claims,0.0,monotone={ok_mono};4g_flips_first={ok_flip};"
        f"split_at_gamma1={int(s[0])};split_at_gamma1000={int(s[-1])}")
    return rows


if __name__ == "__main__":
    costs, device = costs_from_args(__doc__.splitlines()[0])
    for r in run(costs, device):
        print(r)
