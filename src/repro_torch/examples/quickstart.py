"""Quickstart: the paper's full loop in one script — counterpart of
``examples/quickstart.py``.

1. Build a reduced BranchyNet LM (the phi3-family smoke trunk with one
   side branch), random weights from a seeded generator.
2. Serve a batch and measure per-branch exit statistics (calibration).
3. Build the cost model (Eq. 1-6) from per-layer costs (uniform synthetic
   layer times, as the reference's quickstart uses; measured profiles come
   from ``repro_torch.benchmarks.alexnet_profile``).
4. Solve the partition as a shortest path (Sec. V, Dijkstra).
5. Deploy the plan on the two-tier ``PartitionedServer`` and decode.

    python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import LayerCost, Partitioner, build_cost_profile
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import PartitionedServer, ServingEngine

__all__ = ["main"]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device (default: the current one)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. model -----------------------------------------------------------
    cfg = get_smoke_config("phi3_mini_3_8b")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    print(f"model: {cfg.name} (reduced) — {cfg.num_layers} layers, "
          f"branches after {cfg.branch_layers}; device {device}")

    # --- 2. serve + calibrate -----------------------------------------------
    engine = ServingEngine(cfg, params, context_len=128, device=device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 16))
    state = engine.start({"tokens": prompts})
    tokens, stats = engine.decode(state, steps=12)
    print(f"decoded {tokens.shape} tokens; exit fractions per branch+final: "
          f"{np.round(stats.exit_fractions(), 3)}")
    p_k = stats.conditional_probs()
    print(f"calibrated conditional exit probs p_k = {np.round(p_k, 3)}")

    # --- 3. per-layer cost model ---------------------------------------------
    costs = [LayerCost(f"block{i}", 0.0, 0.0, cfg.d_model * 2.0, 2e-3)
             for i in range(1, cfg.num_layers + 1)]
    profile = build_cost_profile(
        costs, branch_positions=cfg.branch_layers, exit_probs=p_k,
        network="4g", gamma=50.0, raw_input_bytes=16 * 4,  # the token prompt
    )

    # --- 4. optimal split (the paper's contribution) -------------------------
    plan = Partitioner(profile).solve()
    print(plan.describe())
    splits = {}
    for net in ("3g", "4g", "wifi"):
        alt = Partitioner(profile).with_network(net).solve()
        splits[net] = alt.split_layer
        print(f"  under {net:4s}: split={alt.split_layer} "
              f"E[T]={alt.expected_time_s * 1e3:.2f} ms")

    # --- 5. partitioned serving ----------------------------------------------
    srv = PartitionedServer(cfg, params, plan.split_layer, cost_profile=profile,
                            device=device)
    caches = M.init_caches(cfg, 8, 128, device=device)
    tok, pos = tokens[:, -1:], int(state["pos"])
    shipped_total = 0
    for i in range(8):
        rep, caches = srv.step(tok, pos + i, caches)
        tok = rep.tokens[:, None]
        shipped_total += rep.shipped
    print(f"partitioned decode: {shipped_total}/64 token-steps crossed the "
          f"cut (the rest exited on the edge)")
    return dict(p_k=p_k, split=plan.split_layer, splits=splits,
                shipped=shipped_total, host_syncs=srv.executor.host_syncs)


if __name__ == "__main__":
    main()
