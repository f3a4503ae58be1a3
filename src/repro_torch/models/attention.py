"""GQA attention with a (ring) KV cache — counterpart of the GQA path of
``repro.models.attention``.

Shapes follow the reference:
    q: (B, Sq, K, G, D)   — K kv-head groups, G = num_heads // num_kv_heads
    k/v: (B, Sk, K, D)

KV cache layout (dict of tensors, the reference's layout):
    k, v:   (B, C, K, D)  — C slots (ring: slot = position % C)
    pos:    (B, C) int32  — absolute position held in each slot, -1 empty
    length: () int32      — tokens decoded so far (lock-step write index)

``pos`` is per sequence, so a row that skipped a step downstream of its
early exit leaves a hole that attention masks.  Decode entry points take
``rows``: the sub-batch reads/writes only those rows of the full-batch
cache; a row index >= B is the compacted runtime's out-of-bounds sentinel,
whose write is dropped (the reference's ``mode="drop"``) and whose read is
clamped into the cache (its output is discarded by the caller).

Unlike the reference, whose arrays are immutable, the port updates caches
**in place** (a full-size cache is 12.9 GB) and returns the same dict.
Writes with sentinel rows never map a dropped row onto a real one (torch's
``index_put_`` with duplicate indices is undefined): see
:func:`_write_slots`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.models.layers import apply_rope, dense, rmsnorm

__all__ = [
    "FlashAttention",
    "attn_apply",
    "init_kv_cache",
    "prefill_attention",
    "NEG_INF",
]

NEG_INF = -1e30
_BLOCK_Q = 512  # prompt rows per score tile in prefill_attention


# =================================================================== KV cache
def init_kv_cache(batch: int, capacity: int, num_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """An empty ring cache on ``device`` (default: the current CUDA
    device)."""
    device = kernel_ops.resolve_device(device)
    return {
        "k": torch.zeros((batch, capacity, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def _write_slots(buf: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor,
                 values: torch.Tensor) -> None:
    """``buf[rows[i], slots[i]] = values[i]`` in place, dropping entries
    whose row is an out-of-bounds sentinel (>= Bc).  Real rows must be
    distinct.  Sync-free and exact: the sub-batch is scattered into a
    (Bc + 1)-row staging copy of each row's target slot (every sentinel
    lands on the discarded extra row), then all Bc rows are written back —
    rows outside the sub-batch rewrite the value they already hold."""
    bc = buf.shape[0]
    r = rows.long().clamp(max=bc)
    slot_of = torch.zeros(bc + 1, dtype=torch.long, device=buf.device)
    slot_of[r] = slots.long()
    slot_of = slot_of[:bc]
    every = torch.arange(bc, device=buf.device)
    stage = torch.empty((bc + 1, *buf.shape[2:]), dtype=buf.dtype,
                        device=buf.device)
    stage[:bc] = buf[every, slot_of]
    stage[r] = values.to(buf.dtype)
    buf[every, slot_of] = stage[:bc]


def _cache_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 rows: torch.Tensor | None = None,
                 positions: torch.Tensor | None = None) -> dict:
    """Write one decode step (Sq == 1) into the ring cache, in place.

    ``positions`` (B|Bsub, 1) makes the write per sequence: row i writes
    its own slot ``positions[i] % C`` and records its own position
    (continuous batching).  A 1-D ``positions`` (or None) keeps the
    lock-step write at ``length % C`` recording ``length``.  ``rows``
    targets rows of the full-batch cache (sentinels drop)."""
    c = cache["k"].shape[1]
    b = k_new.shape[0]
    if positions is not None and positions.dim() == 2:
        pos_vec = positions[:, 0].to(torch.int32)
        slots = (pos_vec % c).long()
        if rows is None:
            every = torch.arange(b, device=k_new.device)
            cache["k"][every, slots] = k_new[:, 0]
            cache["v"][every, slots] = v_new[:, 0]
            cache["pos"][every, slots] = pos_vec
        else:
            _write_slots(cache["k"], rows, slots, k_new[:, 0])
            _write_slots(cache["v"], rows, slots, v_new[:, 0])
            _write_slots(cache["pos"], rows, slots, pos_vec)
    else:
        length = cache["length"]
        idx = (length % c).long().reshape(1)
        if rows is None:
            cache["k"].index_copy_(1, idx, k_new.to(cache["k"].dtype))
            cache["v"].index_copy_(1, idx, v_new.to(cache["v"].dtype))
            cache["pos"].index_copy_(
                1, idx, length.to(torch.int32).reshape(1, 1).expand(
                    cache["pos"].shape[0], 1).contiguous())
        else:
            n = rows.shape[0]
            slots = idx.expand(n)
            _write_slots(cache["k"], rows, slots, k_new[:, 0])
            _write_slots(cache["v"], rows, slots, v_new[:, 0])
            _write_slots(cache["pos"], rows, slots,
                         length.to(torch.int32).expand(n))
    cache["length"] += 1
    return cache


def _fresh_rows(k: torch.Tensor, v: torch.Tensor, cap: int, dtype):
    """(k, v, pos) of freshly initialized cache rows that just prefilled a
    whole prompt at positions 0..S-1, honoring slot = position % cap."""
    n, s = k.shape[:2]
    dev = k.device
    if s >= cap:
        shift = s % cap
        fk = torch.roll(k[:, s - cap:], shift, dims=1).to(dtype)
        fv = torch.roll(v[:, s - cap:], shift, dims=1).to(dtype)
        fp = torch.roll(torch.arange(s - cap, s, dtype=torch.int32, device=dev),
                        shift).expand(n, cap).contiguous()
        return fk, fv, fp
    fk = torch.zeros((n, cap, *k.shape[2:]), dtype=dtype, device=dev)
    fv = torch.zeros_like(fk)
    fk[:, :s] = k
    fv[:, :s] = v
    fp = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    fp[:, :s] = torch.arange(s, dtype=torch.int32, device=dev)
    return fk, fv, fp


def _cache_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write a whole prompt (S tokens at positions 0..S-1) into every row
    of the cache in place; slots past the prompt keep what they hold, as
    in the reference."""
    s = k.shape[1]
    cap = cache["k"].shape[1]
    if s >= cap:
        fk, fv, fp = _fresh_rows(k, v, cap, cache["k"].dtype)
        cache["k"].copy_(fk)
        cache["v"].copy_(fv)
        cache["pos"].copy_(fp)
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32,
                                           device=k.device)
    cache["length"].fill_(s)
    return cache


def plan_rows(rows, bc: int, device):
    """A host-side admission plan (CPU tensor, numpy array or list) on
    ``device``: (prompt rows kept, their cache rows), with sentinel rows
    (>= ``bc``) dropped on the host so no device index ever aliases a real
    row; None when every row is a sentinel."""
    rows = torch.as_tensor(rows, dtype=torch.long)
    if rows.is_cuda:
        raise ValueError("prefill rows are a host-side plan: pass them on "
                         "the CPU")
    keep = torch.nonzero(rows < bc).flatten()
    if keep.numel() == 0:
        return None
    return keep.to(device), rows[keep].to(device)


def _cache_prefill_rows(cache: dict, k: torch.Tensor, v: torch.Tensor,
                        rows) -> dict:
    """Row-targeted prompt prefill: row ``rows[i]`` ends exactly as a fresh
    cache that just prefilled prompt i (slots past the prompt reset to
    empty).  ``rows`` is the host-side admission plan (:func:`plan_rows`).
    Other rows and ``length`` are untouched."""
    plan = plan_rows(rows, cache["k"].shape[0], k.device)
    if plan is None:
        return cache
    sel, tgt = plan
    fk, fv, fp = _fresh_rows(k[sel], v[sel], cache["k"].shape[1],
                             cache["k"].dtype)
    cache["k"][tgt] = fk
    cache["v"][tgt] = fv
    cache["pos"][tgt] = fp
    return cache


# ================================================== prefill attention (plain)
def _masked_scores(qf: torch.Tensor, kf: torch.Tensor, q_pos: torch.Tensor,
                   k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """fp32 scores (B, Sq, K, G, Sk) of scaled queries against keys, -1e30
    where the causal (optionally banded) mask or an empty slot excludes the
    key."""
    sc = torch.einsum("bqkgd,bskd->bqkgs", qf, kf)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    mask = mask & (k_pos[None, :] >= 0)
    return torch.where(mask[None, :, None, None, :], sc, NEG_INF)


def _attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, window: int):
    """(out, m, l): the output and each row's softmax max and sum."""
    s, d = q.shape[1], q.shape[-1]
    qf = (q * (1.0 / math.sqrt(d))).float()
    kf, vf = k.float(), v.float()
    outs, ms, ls = [], [], []
    for q0 in range(0, s, _BLOCK_Q):
        sc = _masked_scores(qf[:, q0:q0 + _BLOCK_Q], kf,
                            positions[q0:q0 + _BLOCK_Q], positions, window)
        m = sc.amax(dim=-1).clamp(min=NEG_INF)
        p = torch.exp(sc - m[..., None])
        l = p.sum(dim=-1)
        acc = torch.einsum("bqkgs,bskd->bqkgd", p, vf)
        outs.append(acc / l.clamp(min=1e-30)[..., None])
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(ms, dim=1), torch.cat(ls, dim=1)


def prefill_attention(
    q: torch.Tensor,  # (B, S, K, G, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    positions: torch.Tensor,  # (S,)
    *,
    window: int = 0,
) -> torch.Tensor:
    """Causal (optionally banded) attention over a prompt, fp32 scores and
    the reference's softmax form (m = max(-1e30, max s), p = e^(s - m),
    out = p v / max(sum p, 1e-30)).  Not a kernel in either package: the
    reference runs plain jnp here.  Queries are taken ``_BLOCK_Q`` at a
    time to bound the (S, S) score memory."""
    return _attention_fwd(q, k, v, positions, window)[0]


class FlashAttention(torch.autograd.Function):
    """:func:`prefill_attention` with the reference's recompute backward
    (``_flash_vjp``): the forward keeps only (q, k, v, out, m, l), and the
    backward recomputes each query block's probabilities p from them, with
    ``delta = sum(dout * out)``, ``ds = p (dp - delta)`` and the scale
    folded into dq at the end.  Nothing of size (Sq, Sk) is saved, where
    plain autograd would keep every block's fp32 scores.  Plain PyTorch,
    as the reference's is plain jnp: neither package trains on a kernel.

    ``FlashAttention.apply(q, k, v, positions, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, positions, window):
        out, m, l = _attention_fwd(q, k, v, positions, window)
        ctx.save_for_backward(q, k, v, positions, out, m, l)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, positions, out, m, l = ctx.saved_tensors
        s, d = q.shape[1], q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        qf = (q * scale).float()
        kf, vf = k.float(), v.float()
        do = dout.float()
        lsafe = l.clamp(min=1e-30)
        delta = (do * out.float()).sum(dim=-1)  # (B, Sq, K, G)
        dq = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(kf.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(vf.shape, dtype=torch.float32, device=v.device)
        for q0 in range(0, s, _BLOCK_Q):
            blk = slice(q0, q0 + _BLOCK_Q)
            sc = _masked_scores(qf[:, blk], kf, positions[blk], positions, ctx.window)
            p = torch.exp(sc - m[:, blk, ..., None]) / lsafe[:, blk, ..., None]
            dv += torch.einsum("bqkgs,bqkgd->bskd", p, do[:, blk])
            dp = torch.einsum("bqkgd,bskd->bqkgs", do[:, blk], vf)
            ds = p * (dp - delta[:, blk, ..., None])
            dq[:, blk] = torch.einsum("bqkgs,bskd->bqkgd", ds, kf)
            dk += torch.einsum("bqkgs,bqkgd->bskd", ds, qf[:, blk])
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None)


# ============================================================== standard GQA
def attn_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,) shared, or (B, 1) per sequence at decode
    cache: dict | None = None,
    *,
    window: int | None = None,
    rows=None,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """One attention op.  ``cache=None``: full causal attention over x
    (training, or a prefill that writes no cache), through
    :class:`FlashAttention`'s recompute backward.
    Cache given with S > 1: prompt prefill writing the cache (``rows``
    targets admitted rows of the resident cache, a host-side plan).  Cache
    given with S == 1: decode — write this step, then attend over the
    cache; ``rows`` (device tensor) maps the compacted sub-batch onto cache
    rows and ``use_kernels`` sends the attention to the Hopper
    ``flash_decode`` kernel instead of its plain version."""
    b, s, _ = x.shape
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // kh
    window = cfg.sliding_window if window is None else window
    dtype = x.dtype

    q = dense(params["wq"], x, dtype).reshape(b, s, kh * g, hd)
    k = dense(params["wk"], x, dtype).reshape(b, s, kh, hd)
    v = dense(params["wv"], x, dtype).reshape(b, s, kh, hd)
    if cfg.use_qk_norm:
        # Qwen3: each head normalized over head_dim before RoPE, so the
        # cache holds normalized, rotated keys (prefill and decode alike).
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, s, kh, g, hd)

    if cache is not None and s > 1:
        if rows is None:
            _cache_prefill(cache, k, v)
        else:
            _cache_prefill_rows(cache, k, v, rows)
        out = prefill_attention(qg, k, v, positions, window=window)
    elif cache is not None:
        _cache_write(cache, k, v, rows, positions)
        q_pos = positions[:, 0] if positions.dim() == 2 else positions[0]
        decode = kernel_ops.flash_decode if use_kernels else flash_decode_ref
        out = decode(qg.reshape(b, kh * g, hd), cache["k"], cache["v"],
                     cache["pos"], q_pos, rows, window=window)
    else:
        out = FlashAttention.apply(qg, k, v, positions, window)
    out = out.reshape(b, s, kh * g * hd)
    return dense(params["wo"], out, dtype), cache
