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
    and the reference's ``normalized_entropy`` compute it."""
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=dim)
    h = -(torch.exp(logp) * logp).sum(dim=dim)
    return h / math.log(logits.shape[dim])
