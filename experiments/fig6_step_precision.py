#!/usr/bin/env python3
"""How far one B-AlexNet SGD step (the Fig. 6 trainer's, batch 2, lr
3e-4, seed-0 weights and images from ``fig6_calibration.make_images``)
lands from the same step in float64 on the CPU, on one card, under each
precision setting:

  * fp32 with TF32 switched on outside the model (the model turns it off
    around its forward and backward passes, ``_fp32_products``);
  * fp32 with TF32 off everywhere, then also ``cudnn.deterministic``;
  * fp32 with cuDNN off (PyTorch's own convolutions);
  * TF32, the model's guard removed;
  * float64 on the card;
  * fp32 on the CPU.

Each line names the four params whose step is furthest off, each as the
largest |g - g64| over the largest |g64| (g: the change the step made,
over lr).  ``chip_smoke.py``'s Fig. 6 phase sets its tolerance from this.

    python3 experiments/fig6_step_precision.py
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LR = 3e-4


def main() -> int:
    import torch

    import repro_torch.models.alexnet as alexnet
    from repro_torch.benchmarks import fig6_calibration as fig6
    from repro_torch.models.alexnet import BAlexNetConfig, init_b_alexnet

    if not torch.cuda.is_available():
        print("fig6_step_precision: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    backends = torch.backends
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_b_alexnet(BAlexNetConfig(), gen, dev)
    img, lab = fig6.make_images(gen, 2)

    def cast(p, dtype, device):
        return {k: {n: t.to(device=device, dtype=dtype) for n, t in v.items()}
                for k, v in p.items()}

    def steps(p, new):
        return {(k, n): (p[k][n].double().cpu() - new[k][n].double().cpu()) / LR
                for k in p for n in p[k]}

    p64 = cast(params, torch.float64, "cpu")
    g64 = steps(p64, fig6.sgd_step(p64, img.double().cpu(), lab.cpu(), LR)[0])

    def report(label, p, x):
        g = steps(p, fig6.sgd_step(p, x, lab.to(x.device), LR)[0])
        errs = {key: float((g[key] - g64[key]).abs().max() / g64[key].abs().max()) for key in g}
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        print(f"{label}: " + ", ".join(f"{k[0]}.{k[1]} {e:.2e}" for k, e in worst), flush=True)

    print(f"device {torch.cuda.get_device_name(0)}")
    cpu32 = cast(params, torch.float32, "cpu")
    report("cpu fp32", cpu32, img.cpu())
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = True
    report("card fp32, TF32 on outside the model", params, img)
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    report("card fp32, TF32 off everywhere", params, img)
    backends.cudnn.deterministic = True
    report("card fp32, cudnn.deterministic", params, img)
    backends.cudnn.deterministic = False
    backends.cudnn.enabled = False
    report("card fp32, cuDNN off", params, img)
    backends.cudnn.enabled = True
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = True
    guard = alexnet._fp32_products
    alexnet._fp32_products = fig6._fp32_products = contextlib.nullcontext
    try:
        report("card TF32, the model's guard removed", params, img)
    finally:
        alexnet._fp32_products = fig6._fp32_products = guard
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    report("card float64", cast(params, torch.float64, dev), img.double())
    return 0


if __name__ == "__main__":
    sys.exit(main())
