"""Train a small BranchyNet LM for a few hundred steps on the synthetic
pipeline — counterpart of ``examples/train_branchy.py``: the joint main +
branch loss (BranchyNet training), AdamW with a cosine schedule, a
checkpoint round trip, and a calibration report from ``ServingEngine``
(the card's ``flash_decode`` and exit kernels) showing that the trained
branches exit.

    python -m repro_torch.examples.train_branchy [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import cosine_schedule, make_optimizer
from repro_torch.training.train_loop import init_train_state, make_train_step
from repro_torch.training.tree import tree_items, tree_leaves

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "branchy_ckpt.npz"))
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the current one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config("olmo_1b")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"training {cfg.name} (reduced, {n_params / 1e6:.1f}M params), "
          f"branches after {cfg.branch_layers}; device {device}")

    opt = make_optimizer("adamw", lr=cosine_schedule(3e-3, warmup=20, total=args.steps))
    state = init_train_state(params, opt)
    train_step = make_train_step(cfg, opt)

    data = iter(SyntheticLM(cfg, args.batch, args.seq))
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"main {float(metrics.get('main_loss', metrics['loss'])):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps / dt:.1f} steps/s)")

    save_checkpoint(args.ckpt, state["params"], step=args.steps)
    restored = restore_checkpoint(args.ckpt, state["params"], device)
    for (path, a), b in zip(tree_items(state["params"]), tree_leaves(restored)):
        if not torch.equal(a, b):
            raise SystemExit(f"checkpoint round trip changed {'##'.join(map(str, path))}")
    print(f"checkpoint round-trip OK (bitwise) -> {args.ckpt}")

    # Trained-branch calibration: exits should now actually fire.
    engine = ServingEngine(cfg, restored, context_len=args.seq + 32, device=device)
    tokens = next(data)["tokens"]
    ops.reset_launches()
    serve = engine.start({"tokens": tokens[:, : args.seq // 2]})
    _, stats = engine.decode(serve, steps=16)
    launches = dict(ops.launches)
    print(f"post-training exit fractions (branches..., final): "
          f"{np.round(stats.exit_fractions(), 3)}")
    print(f"conditional p_k = {np.round(stats.conditional_probs(), 3)}")
    print(f"kernel launches in the serving leg: {json.dumps(launches)}")
    return dict(losses=losses, exit_fractions=stats.exit_fractions().tolist(),
                conditional_probs=stats.conditional_probs().tolist(),
                launches=launches)


if __name__ == "__main__":
    main()
