"""Exit-probability calibration (paper Sec. III + Fig. 6) — counterpart of
``repro.core.calibration``.

BranchyNet exits when the normalized entropy of a side branch's
probability vector clears a threshold.  The calibrator turns measured
branch entropies (from a validation batch, or live decode steps) into the
conditional exit probabilities ``p_k`` the partitioner consumes — ``p_k``
is conditioned on *not* exiting at any earlier branch (paper Eq. 4 then
recovers the unconditional ``p_Y(k)``)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "normalized_entropy",
    "exit_mask",
    "CalibrationResult",
    "calibrate_exit_probs",
    "threshold_sweep",
]


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


def exit_mask(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """True where the sample exits: normalized entropy below threshold."""
    return normalized_entropy(logits) < threshold


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Conditional exit probabilities and supporting statistics."""

    conditional_p: np.ndarray  # (K,) p_k given reached b_k
    unconditional_p: np.ndarray  # (K,) p_Y(k), Eq. 4
    exit_fraction: np.ndarray  # (K+1,) fraction exiting at each branch (+tail)
    threshold: float

    @property
    def survival(self) -> np.ndarray:
        return np.cumprod(1.0 - self.conditional_p)


def calibrate_exit_probs(
    branch_entropies: np.ndarray, threshold: float
) -> CalibrationResult:
    """From per-branch normalized entropies of a validation batch.

    ``branch_entropies``: (K, B) — entropy each of B samples would see at
    each of K branches (branches ordered along the chain).  The sequential
    exit process is simulated exactly: a sample contributes to branch k's
    statistics only if it cleared no earlier branch.
    """
    ents = np.asarray(branch_entropies, dtype=np.float64)
    if ents.ndim != 2:
        raise ValueError("branch_entropies must be (K, B)")
    k, b = ents.shape
    alive = np.ones(b, dtype=bool)
    cond, uncond, frac = [], [], []
    for i in range(k):
        exits = alive & (ents[i] < threshold)
        n_alive = int(alive.sum())
        p_cond = float(exits.sum() / n_alive) if n_alive else 0.0
        cond.append(p_cond)
        uncond.append(float(exits.sum() / b))
        frac.append(float(exits.sum() / b))
        alive &= ~exits
    frac.append(float(alive.sum() / b))  # classified at the output layer
    res = CalibrationResult(
        conditional_p=np.asarray(cond),
        unconditional_p=np.asarray(uncond),
        exit_fraction=np.asarray(frac),
        threshold=threshold,
    )
    # Internal consistency with Eq. 4: p_Y(k) = p_k prod_{i<k}(1 - p_i).
    alive_p = 1.0
    for i in range(k):
        expected = res.conditional_p[i] * alive_p
        assert abs(expected - res.unconditional_p[i]) < 1e-9
        alive_p *= 1.0 - res.conditional_p[i]
    return res


def threshold_sweep(
    branch_entropies: np.ndarray, thresholds: np.ndarray
) -> np.ndarray:
    """Fig. 6: P[classified at side branch] per threshold.

    Returns (T, K) unconditional exit probabilities.  Distortion enters via
    the entropies themselves (blurrier input -> flatter branch posterior ->
    higher entropy -> lower exit probability), reproducing the figure's
    monotone ordering across distortion levels.
    """
    out = np.stack(
        [
            calibrate_exit_probs(branch_entropies, float(t)).unconditional_p
            for t in np.asarray(thresholds)
        ]
    )
    return out
