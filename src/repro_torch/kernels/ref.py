"""Plain PyTorch versions of the kernels on the port's decode path.

Counterparts of ``repro.kernels.ref`` (the reference package's oracles).
They are definitions, written for clarity, not speed: the CPU tests hold
them against the JAX oracles and Pallas kernels, the dispatch wrappers in
:mod:`repro_torch.kernels.ops` run them for CPU tensors, and
``chip_smoke.py`` holds each Hopper kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.calibration import normalized_entropy

__all__ = [
    "entropy_exit_argmax_ref",
    "entropy_exit_argmax_heads_ref",
    "flash_decode_ref",
]

NEG_INF = -1e30


def entropy_exit_argmax_ref(
    logits: torch.Tensor, threshold: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, V) logits -> (normalized entropy (B,) f32, exit flag (B,) bool,
    argmax token (B,) int32, first occurrence on ties)."""
    h = normalized_entropy(logits)
    return h, h < threshold, torch.argmax(logits, dim=-1).to(torch.int32)


def entropy_exit_argmax_heads_ref(
    logits: torch.Tensor,  # (K, B, V) stacked branch-head logits
    thresholds: torch.Tensor | float,  # scalar or (K,) per-head thresholds
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per head exactly :func:`entropy_exit_argmax_ref` on ``logits[k]``
    against ``thresholds[k]`` (a scalar broadcasts to every head).
    Returns (entropy (K, B), exit (K, B) bool, argmax (K, B) int32)."""
    k = logits.shape[0]
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=logits.device)
    th = th.reshape(-1).expand(k)
    h = normalized_entropy(logits)
    return h, h < th[:, None], torch.argmax(logits, dim=-1).to(torch.int32)


def flash_decode_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (Bc, C, Kh, D)
    v: torch.Tensor,  # (Bc, C, Kh, D)
    k_pos: torch.Tensor,  # (C,) shared or (Bc, C) per-sequence, -1 = empty
    q_pos: torch.Tensor,  # () shared or (B,) per-query-row
    rows: torch.Tensor | None = None,  # (B,) query row -> cache row
    window: int = 0,
) -> torch.Tensor:
    """Single-token GQA decode attention with per-sequence slot validity
    (``0 <= k_pos <= q_pos``), an optional sliding window and an optional
    row map into a larger resident cache.  A row index past the cache (the
    compacted runtime's out-of-bounds sentinel) reads the last row, as the
    reference's clamped gather does; its output is discarded by the caller.
    Fully masked rows average uniformly (finite -1e30 mask).  Returns
    (B, H, D) in q's dtype."""
    b, h, d = q.shape
    if rows is not None:
        rows = rows.long().clamp(0, k.shape[0] - 1)
        k, v = k[rows], v[rows]
        if k_pos.dim() == 2:
            k_pos = k_pos[rows]
    kh = k.shape[2]
    g = h // kh
    q_pos = torch.as_tensor(q_pos, device=q.device).expand(b)[:, None]
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :]
    qf = q.reshape(b, kh, g, d).float() / math.sqrt(d)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k.float())
    valid = (k_pos >= 0) & (k_pos <= q_pos)
    if window > 0:
        valid = valid & (q_pos - k_pos < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)
