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
    "entropy_exit_ref",
    "entropy_exit_argmax_ref",
    "entropy_exit_argmax_heads_ref",
    "flash_decode_ref",
    "ssd_scan_ref",
    "ssd_update_ref",
]

NEG_INF = -1e30


def entropy_exit_ref(
    logits: torch.Tensor, threshold: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, V) logits -> (normalized entropy (B,) f32, exit flag (B,) bool);
    fp32 math, normalized by log of the logits width (pad lanes
    included)."""
    h = normalized_entropy(logits)
    return h, h < threshold


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
    if isinstance(thresholds, torch.Tensor):
        th = thresholds.to(device=logits.device, dtype=torch.float32)
    else:  # filled on the device: no host copy (a CUDA-graph capture has none)
        th = torch.full((k,), float(thresholds), dtype=torch.float32,
                        device=logits.device)
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


def _group_to_heads(m: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., G, N) per-group B or C -> (..., H, N), ``rep = H / G``
    consecutive heads per group."""
    return m.float().repeat_interleave(heads // m.shape[-2], dim=-2)


def ssd_scan_ref(
    x: torch.Tensor,  # (B, L, H, P) dt-scaled inputs
    a: torch.Tensor,  # (B, L, H) per-step log decay (negative)
    b_mat: torch.Tensor,  # (B, L, G, N), G divides H
    c_mat: torch.Tensor,  # (B, L, G, N)
    h0: torch.Tensor | None = None,  # (B, H, P, N) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential SSM recurrence, SSD's semantic definition:
        h_t = exp(a_t) h_{t-1} + x_t (x) B_t ;  y_t = h_t . C_t
    fp32 math; B and C are shared by ``H / G`` consecutive heads (G = H is
    the reference oracle's per-head form).  Returns (y (B, L, H, P) in x's
    dtype, final state (B, H, P, N) fp32)."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    xf, af = x.float(), a.float()
    bf, cf = _group_to_heads(b_mat, h), _group_to_heads(c_mat, h)
    hs = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    ys = []
    for t in range(l):
        hs = hs * torch.exp(af[:, t])[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t], bf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", hs, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), hs


def ssd_update_ref(
    h_state: torch.Tensor,  # (Bc, H, P, N) fp32 resident state, updated in place
    x: torch.Tensor,  # (B, H, P) dt-scaled input
    a: torch.Tensor,  # (B, H) dt * A (negative)
    b_vec: torch.Tensor,  # (B, G, N)
    c_vec: torch.Tensor,  # (B, G, N)
    rows: torch.Tensor | None = None,  # (B,) sub-batch row -> state row
) -> torch.Tensor:
    """One recurrent SSD decode step against the resident state, in place:
    row i reads state row ``min(rows[i], Bc - 1)`` (the reference's clamped
    gather), computes ``h' = e^a h + x (x) B`` and ``y = h' . C`` in fp32,
    and writes ``h'`` back to row ``rows[i]`` — a row ``>= Bc`` (the
    compacted runtime's out-of-bounds sentinel) drops its write, as the
    reference's ``.at[rows].set(mode="drop")`` does.  Real rows must be
    distinct.  Returns y (B, H, P) fp32."""
    bc, nh = h_state.shape[:2]
    b = x.shape[0]
    r = (torch.arange(b, device=x.device) if rows is None
         else rows.long().clamp(max=bc))
    h_prev = h_state[r.clamp(max=bc - 1)]
    h_new = h_prev * torch.exp(a.float())[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x.float(), _group_to_heads(b_vec, nh))
    y = torch.einsum("bhpn,bhn->bhp", h_new, _group_to_heads(c_vec, nh))
    # Every sentinel lands on a discarded extra row: no index aliases a
    # real row and nothing has to be fetched to the host.
    stage = torch.cat([h_state, h_state[:1]])
    stage[r] = h_new
    h_state.copy_(stage[:bc])
    return y
