#!/usr/bin/env python3
"""Work out a configuration's exit threshold from the plain fp32
reference: the median, over every position of the first ``--requests``
warm-start prompts of a cell's traffic drawn with seed 0, of the position's
smallest edge-branch normalized entropy, on seed-0 weights.  About half of
the positions then exit at the edge.  Prints the threshold; the
configuration file records it.

    python3 bench/calibrate.py --workload phi3-mini.reason [--requests 8]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def edge_entropies(m: dict, split: int, seed: int, prompts, device):
    """Each position's smallest edge-branch entropy, over all prompts."""
    import numpy as np
    import torch

    from bench.harness import weights
    from bench.harness.check import REFERENCES, edge_branches
    from bench.reference import common

    restore = common.no_tf32()
    try:
        with torch.no_grad():
            w = weights.make(m, seed, device, dtype=torch.float32)
            prec = common.Precision("fp32")
            branches = edge_branches(m, split)
            out = []
            for p in prompts:
                tokens = torch.as_tensor(np.asarray(p, np.int64), device=device)
                keep = torch.ones(tokens.shape[0], dtype=torch.bool, device=device)
                collected, _, _ = REFERENCES[m["arch_type"]](w, m, split, tokens, keep,
                                                       branches, prec)
                ent = torch.stack([common.normalized_entropy(common.logits(
                    w, collected[b], w["branches"]["scale"][m["branch_layers"].index(b)],
                    m, prec)) for b in branches])
                out.append(ent.amin(0))
            return torch.cat(out)
    finally:
        restore()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from bench.harness import spec

    cell = spec.cell(args.workload)
    m, serving, mix = cell["config_file"]["model"], cell["config_file"]["serving"], cell["mix"]
    gen = spec.generator(mix["generator"]).ClosedLoop(mix, 0, m["vocab_size"])
    prompts = [r.prompt for r in gen.first()[: args.requests]]
    h = edge_entropies(m, serving["split"], 0, prompts, args.device)
    q = h.quantile(h.new_tensor([0.1, 0.25, 0.5, 0.75, 0.9])).tolist()
    print(f"{args.workload}: {h.numel()} positions, smallest edge-branch entropy "
          f"quantiles 10/25/50/75/90% {q}; threshold (median) {q[2]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
