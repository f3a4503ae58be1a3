"""Paper Fig. 6: P[classified at the side branch] vs the entropy threshold
under three Gaussian-blur distortion levels (kernel sizes 5 / 15 / 65, as
in the paper), on B-AlexNet — counterpart of
``benchmarks/fig6_calibration.py``.

The paper trains on a cat-vs-dog dataset; offline, the reference trains
on a synthetic two-class image task (class-dependent oriented textures),
and so does the port, drawing from a ``torch.Generator``.  The figure's
claim does not depend on the dataset: heavier blur -> flatter branch
posterior -> higher entropy -> lower exit probability at any threshold.
B-AlexNet trains in full fp32: TF32 is off for the forward and the
backward pass (``models.alexnet._fp32_products``).

    python -m repro_torch.benchmarks.fig6_calibration [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.core import threshold_sweep
from repro_torch.core.calibration import normalized_entropy
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.alexnet import BAlexNetConfig, _fp32_products, forward, init_b_alexnet
from repro_torch.training.tree import tree_leaves, tree_map

__all__ = ["KERNELS", "THRESHOLDS", "make_images", "gaussian_blur", "sgd_step",
           "train_b_alexnet", "report", "rows", "run"]

KERNELS = {"low": 5, "mid": 15, "high": 65}
THRESHOLDS = np.linspace(0.05, 1.0, 20)


def make_images(generator: torch.Generator, n: int, size: int = 224):
    """Two-class oriented-texture 'animals': (images (n, 3, size, size)
    fp32 NCHW, labels (n,) int64) on the generator's device; class 0
    varies along the width, class 1 along the height."""
    dev = generator.device
    labels = (torch.rand(n, generator=generator, device=dev) < 0.5).long()
    xs = torch.linspace(0, 8 * math.pi, size, device=dev)
    phase = torch.rand((n, 1, 1), generator=generator, device=dev) * 2 * math.pi
    base = torch.where(labels[:, None, None] == 0,
                       torch.sin(xs[None, None, :] + phase),
                       torch.sin(xs[None, :, None] + phase))
    img = base[:, None].expand(n, 3, size, size)
    noise = torch.randn(img.shape, generator=generator, device=dev) * 0.3
    return img + noise, labels


def gaussian_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur of an NCHW batch, sigma = ksize / 6 (the
    paper's kernels): shifted adds along H, then W, with edge padding."""
    sigma = max(ksize / 6.0, 1e-3)
    xs = torch.arange(ksize, dtype=torch.float32, device=img.device) - (ksize - 1) / 2
    kern = torch.exp(-0.5 * (xs / sigma) ** 2)
    kern = kern / kern.sum()
    half = ksize // 2

    def blur_axis(x, axis):
        n = x.shape[axis]
        edge = torch.arange(-half, n + ksize - 1 - half, device=x.device).clamp(0, n - 1)
        xp = x.index_select(axis, edge)
        out = torch.zeros_like(x)
        for i in range(ksize):
            out = out + kern[i] * xp.narrow(axis, i, n)
        return out

    return blur_axis(blur_axis(img, 2), 3)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None]).mean()


def sgd_step(params: dict, images: torch.Tensor, labels: torch.Tensor,
             lr: float) -> tuple[dict, torch.Tensor]:
    """One plain SGD step on ``main CE + 0.5 x branch CE``; returns (new
    params, the loss before the step)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    with _fp32_products():
        main, branch = forward(tree_map(lambda _: next(it), params), images)
        loss = _xent(main, labels) + 0.5 * _xent(branch, labels)
        grads = iter(torch.autograd.grad(loss, leaves))
    return tree_map(lambda p: (p - lr * next(grads)).detach(), params), loss.detach()


def train_b_alexnet(generator: torch.Generator, steps: int = 30, batch: int = 16,
                    lr: float = 3e-4) -> tuple[dict, float]:
    """B-AlexNet from seeded weights, ``steps`` SGD steps of ``batch``
    fresh images each; returns (params, the last step's loss)."""
    params = init_b_alexnet(BAlexNetConfig(), generator, generator.device)
    for _ in range(steps):
        img, lab = make_images(generator, batch)
        params, loss = sgd_step(params, img, lab, lr)
    return params, float(loss)


def report(n_eval: int = 48, device=None) -> dict:
    """Train, then evaluate ``n_eval`` images (the paper's 48-sample
    batch) at each blur level: the exit-probability curve over THRESHOLDS
    and the main head's accuracy.  On ``device`` (default: the current
    CUDA device)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(7)
    params, final_loss = train_b_alexnet(gen)
    img, lab = make_images(gen, n_eval)
    curves, accs = {}, {}
    with torch.no_grad():
        for name, ksize in KERNELS.items():
            main, branch = forward(params, gaussian_blur(img, ksize))
            ents = normalized_entropy(branch).cpu().numpy()[None, :]  # (K=1, B)
            curves[name] = threshold_sweep(ents, THRESHOLDS)[:, 0]
            accs[name] = float((main.argmax(-1) == lab).float().mean())
    return dict(seconds=time.perf_counter() - t0, final_loss=final_loss,
                curves=curves, accs=accs)


def rows(rep: dict) -> list[str]:
    """The reference's two rows of a :func:`report`: microseconds of
    training and sweep, the final loss and the low-blur accuracy; then the
    claims."""
    curves, accs = rep["curves"], rep["accs"]
    # Claim: at every threshold, heavier distortion -> lower exit
    # probability (checked in aggregate: mean over thresholds ordered).
    m_low, m_mid, m_high = (curves[k].mean() for k in ("low", "mid", "high"))
    ordered = bool(m_low >= m_mid >= m_high)
    mono = all(bool(np.all(np.diff(c) >= -1e-12)) for c in curves.values())
    return [
        f"fig6/train+sweep,{rep['seconds'] * 1e6:.0f},loss={rep['final_loss']:.3f};"
        f"acc_low={accs['low']:.2f}",
        (f"fig6/claims,0.0,exit_prob_low>=mid>=high={ordered};"
         f"monotone_in_threshold={mono};"
         f"mean_exit_low={m_low:.3f};mid={m_mid:.3f};high={m_high:.3f}"),
    ]


def run(n_eval: int = 48, device=None) -> list[str]:
    return rows(report(n_eval, device))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the current one)")
    for r in run(device=ap.parse_args().device):
        print(r)
