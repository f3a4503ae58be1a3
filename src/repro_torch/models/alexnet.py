"""B-AlexNet — the paper's own evaluation network (Sec. VI).  Counterpart
of ``repro.models.alexnet``.

AlexNet main branch + one side branch after the first conv/pool stage, as
the paper's B-AlexNet [5].  The layers are exposed one by one
(:func:`layer_fns`) because the partitioner needs per-layer costs: this is
the paper's chain graph v_1..v_N.

Layout: NCHW activations and OIHW conv weights (the reference is NHWC /
HWIO); fully connected weights stay (d_in, d_out).  ``fc6`` and ``b1_fc``
flatten an NCHW map, so their input rows are in (C, H, W) order, where the
reference's are in (H, W, C) order: :func:`repro_torch.bridge.
alexnet_params_from_jax` permutes those rows once, and the forward
flattens as PyTorch lays the map out.

Padding and pooling as the reference's XLA ops: conv1's ``"SAME"`` at
stride 4 (11x11 on 224 -> 56) pads 3 before and 4 after (PyTorch's
``padding="same"`` refuses stride > 1), the other convs pad 2/2 (5x5) and
1/1 (3x3); the pools are 3x3 at stride 2 without padding (``"VALID"``):
56 -> 27 -> 13 -> 6.

Precision: fp32 storage and compute, as the reference.  PyTorch runs cuDNN
fp32 convolutions in TF32 by default, so every layer runs with TF32 off
for cuDNN and cuBLAS, the flags restored after.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import resolve_device

__all__ = [
    "BAlexNetConfig",
    "init_b_alexnet",
    "layer_fns",
    "forward",
    "branch_forward",
]


@dataclasses.dataclass(frozen=True)
class BAlexNetConfig:
    """The reference's config less its ``image_size`` and ``branch_after``
    fields, which nothing there reads: ``fc6``'s width fixes the 224 x 224
    input and :func:`forward` takes the branch after conv1."""

    num_classes: int = 2  # the paper's cat-vs-dog task


@contextlib.contextmanager
def _fp32_products():
    """cuDNN convolutions and cuBLAS products in full fp32 (TF32 off) for
    the duration; both flags are restored after.  ``torch.backends.cudnn.
    flags(allow_tf32=False)`` is not used: it also passes its default
    ``enabled=False``, which turns cuDNN off."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def init_b_alexnet(cfg: BAlexNetConfig, generator: torch.Generator,
                   device=None) -> dict:
    """Random fp32 params drawn from ``generator`` (which must live on
    ``device``, by default the current CUDA device): N(0, 1/fan_in)
    weights and zero biases, as the reference's."""
    device = resolve_device(device)

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=generator, device=device)
        return {"w": w.mul_(1.0 / math.sqrt(kh * kw * cin)),
                "b": torch.zeros(cout, device=device)}

    def fc(din, dout):
        w = torch.randn((din, dout), generator=generator, device=device)
        return {"w": w.mul_(1.0 / math.sqrt(din)),
                "b": torch.zeros(dout, device=device)}

    return {
        "conv1": conv(11, 11, 3, 64),
        "conv2": conv(5, 5, 64, 192),
        "conv3": conv(3, 3, 192, 384),
        "conv4": conv(3, 3, 384, 256),
        "conv5": conv(3, 3, 256, 256),
        "fc6": fc(256 * 6 * 6, 4096),
        "fc7": fc(4096, 4096),
        "fc8": fc(4096, cfg.num_classes),
        # Side branch b_1: one conv + pooled classifier (BranchyNet [5]).
        "b1_conv": conv(3, 3, 64, 32),
        "b1_fc": fc(32 * 13 * 13, cfg.num_classes),
    }


def _conv_relu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """ReLU of a stride-1 "SAME" convolution of an NCHW map."""
    return F.relu(F.conv2d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2))


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _fc(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.addmm(p["b"], x, p["w"])


def _fp32(fn: Callable) -> Callable:
    def run(x):
        with _fp32_products():
            return fn(x)

    return run


def layer_fns(params: dict) -> list[tuple[str, Callable]]:
    """The main branch as the paper's chain v_1..v_N (conv stages fused
    with their pools, as the paper's Fig. 5 labels partition points); each
    layer maps an NCHW (or flat) fp32 batch to its output, TF32 off."""

    def l1(x):  # conv1 + pool1; "SAME" at stride 4 pads 3 before, 4 after
        p = params["conv1"]
        return _pool(F.relu(F.conv2d(F.pad(x, (3, 4, 3, 4)), p["w"], p["b"], stride=4)))

    def l2(x):  # conv2 + pool2
        return _pool(_conv_relu(params["conv2"], x))

    def l3(x):
        return _conv_relu(params["conv3"], x)

    def l4(x):
        return _conv_relu(params["conv4"], x)

    def l5(x):  # conv5 + pool5
        return _pool(_conv_relu(params["conv5"], x))

    def l6(x):
        return F.relu(_fc(params["fc6"], x.flatten(1)))

    def l7(x):
        return F.relu(_fc(params["fc7"], x))

    def l8(x):
        return _fc(params["fc8"], x)

    return [(name, _fp32(fn)) for name, fn in (
        ("conv1", l1), ("conv2", l2), ("conv3", l3), ("conv4", l4),
        ("conv5", l5), ("fc6", l6), ("fc7", l7), ("fc8", l8))]


def branch_forward(params: dict, h1: torch.Tensor) -> torch.Tensor:
    """Side branch b_1 logits from the conv1-stage output (NCHW)."""
    with _fp32_products():
        y = _pool(_conv_relu(params["b1_conv"], h1))
        return _fc(params["b1_fc"], y.flatten(1))


def forward(params: dict, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(main logits, branch-1 logits) of an NCHW fp32 image batch."""
    fns = layer_fns(params)
    h1 = h = fns[0][1](images)
    for _, fn in fns[1:]:
        h = fn(h)
    return h, branch_forward(params, h1)
