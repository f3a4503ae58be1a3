"""Exit metric of the BranchyNet confidence test (counterpart of
``repro.core.calibration.normalized_entropy``)."""

from __future__ import annotations

import math

import torch

__all__ = ["normalized_entropy"]


def normalized_entropy(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """H(softmax(logits)) / log(C) in [0, 1].

    Math runs in fp32 whatever the logits dtype, and the log base is the
    logits *width* C (pad lanes included), exactly as the fused exit kernel
    and the reference's ``normalized_entropy`` compute it.

    p comes from ``torch.softmax``, not ``torch.exp(logp)``: on a CPU build
    with MKL the first float32 ``torch.exp`` of a process can come back
    ~1.5e-4 off on one thread's share of the elements
    (``experiments/exit_plain_first_call.py``); the softmax kernels compute
    their exponentials in their own loops."""
    lf = logits.float()
    p = torch.softmax(lf, dim=dim)
    logp = torch.log_softmax(lf, dim=dim)
    h = -(p * logp).sum(dim=dim)
    return h / math.log(logits.shape[dim])
