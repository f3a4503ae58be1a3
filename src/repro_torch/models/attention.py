"""GQA attention with a (ring) KV cache, and DeepSeek-V3's Multi-head
Latent Attention (MLA) with its latent ring — counterpart of
``repro.models.attention``.

Shapes follow the reference:
    q: (B, Sq, K, G, D)   — K kv-head groups, G = num_heads // num_kv_heads
    k/v: (B, Sk, K, D)

KV cache layout (dict of tensors, the reference's layout):
    k, v:   (B, C, K, D)  — C slots (ring: slot = position % C)
    pos:    (B, C) int32  — absolute position held in each slot, -1 empty
    length: () int32      — tokens decoded so far (lock-step write index)

MLA's latent ring has the same ``pos`` and ``length`` beside ``ckv`` (B,
C, kv_rank) and ``k_rope`` (B, C, rope_dim) in place of ``k`` / ``v``; the
ring writes below take the new values by leaf name, so both rings share
them.

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
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.models.layers import apply_rope, dense, rmsnorm
from repro_torch.sharding import ctx as shard_ctx

__all__ = [
    "FlashAttention",
    "attn_apply",
    "init_kv_cache",
    "init_mla_cache",
    "mla_apply",
    "prefill_attention",
    "NEG_INF",
    "PaddedPrompt",
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


def _cache_write(cache: dict, new: dict, rows: torch.Tensor | None = None,
                 positions: torch.Tensor | None = None) -> dict:
    """Write one decode step (Sq == 1) into a ring cache, in place: each
    entry of ``new`` (B|Bsub, 1, ...) into the cache leaf of its name (K
    and V; MLA's latent and shared RoPE key).

    ``positions`` (B|Bsub, 1) makes the write per sequence: row i writes
    its own slot ``positions[i] % C`` and records its own position
    (continuous batching).  A 1-D ``positions`` (or None) keeps the
    lock-step write at ``length % C`` recording ``length``.  ``rows``
    targets rows of the full-batch cache (sentinels drop)."""
    if shard_ctx.is_dtensor(cache["pos"]):
        return _cache_write_sharded(cache, new, rows, positions)
    c = cache["pos"].shape[1]
    b = next(iter(new.values())).shape[0]
    if positions is not None and positions.dim() == 2:
        pos_vec = positions[:, 0].to(torch.int32)
        slots = (pos_vec % c).long()
        if rows is None:
            every = torch.arange(b, device=pos_vec.device)
            for key, val in new.items():
                cache[key][every, slots] = val[:, 0]
            cache["pos"][every, slots] = pos_vec
        else:
            for key, val in new.items():
                _write_slots(cache[key], rows, slots, val[:, 0])
            _write_slots(cache["pos"], rows, slots, pos_vec)
    else:
        length = cache["length"]
        idx = (length % c).long().reshape(1)
        if rows is None:
            for key, val in new.items():
                cache[key].index_copy_(1, idx, val.to(cache[key].dtype))
            cache["pos"].index_copy_(
                1, idx, length.to(torch.int32).reshape(1, 1).expand(
                    cache["pos"].shape[0], 1).contiguous())
        else:
            n = rows.shape[0]
            slots = idx.expand(n)
            for key, val in new.items():
                _write_slots(cache[key], rows, slots, val[:, 0])
            _write_slots(cache["pos"], rows, slots,
                         length.to(torch.int32).expand(n))
    cache["length"] += 1
    return cache


def _fresh_rows(new: dict, cap: int, dtypes: dict):
    """({name: rows}, pos) of freshly initialized cache rows that just
    prefilled a whole prompt at positions 0..S-1, honoring slot = position
    % cap: each entry of ``new`` (n, S, ...) as ``dtypes[name]``."""
    first = next(iter(new.values()))
    n, s = first.shape[:2]
    dev = first.device
    if s >= cap:
        shift = s % cap
        vals = {key: torch.roll(v[:, s - cap:], shift, dims=1).to(dtypes[key])
                for key, v in new.items()}
        fp = torch.roll(torch.arange(s - cap, s, dtype=torch.int32, device=dev),
                        shift).expand(n, cap).contiguous()
        return vals, fp
    vals = {}
    for key, v in new.items():
        vals[key] = torch.zeros((n, cap, *v.shape[2:]), dtype=dtypes[key], device=dev)
        vals[key][:, :s] = v
    fp = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    fp[:, :s] = torch.arange(s, dtype=torch.int32, device=dev)
    return vals, fp


def _cache_prefill(cache: dict, new: dict) -> dict:
    """Write a whole prompt (S tokens at positions 0..S-1) into every row
    of the cache in place (``new``: {leaf name: (B, S, ...)}); slots past
    the prompt keep what they hold, as in the reference.  A DTensor ring
    (a sharded segment) is written on each rank's shard."""
    if shard_ctx.is_dtensor(cache["pos"]):
        _cache_prefill({k: shard_ctx.local(t) for k, t in cache.items()},
                       {k: shard_ctx.like(v, cache[k]) for k, v in new.items()})
        return cache
    first = next(iter(new.values()))
    s = first.shape[1]
    cap = cache["pos"].shape[1]
    if s >= cap:
        vals, fp = _fresh_rows(new, cap, {key: cache[key].dtype for key in new})
        for key, v in vals.items():
            cache[key].copy_(v)
        # Every row's positions are the same: a sharded ring may hold its
        # positions whole beside a batch-sharded K / V (the policy's spec).
        cache["pos"].copy_(fp[:1].expand_as(cache["pos"]))
    else:
        for key, v in new.items():
            cache[key][:, :s] = v
        cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32,
                                           device=first.device)
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


class PaddedPrompt(NamedTuple):
    """A device-side admission plan: one prompt, padded on the right to the
    length its tokens have, whose first ``length`` positions are real and
    whose state lands in cache row ``row``.  Both are (1,) int64 tensors on
    the device, so a prefill under this plan makes no host sync and can be
    captured in a CUDA graph; a ``row`` >= the batch is a sentinel, whose
    writes leave every row as it was."""

    row: torch.Tensor
    length: torch.Tensor


def write_row(buf: torch.Tensor, row: torch.Tensor, head: torch.Tensor,
              fill: float = 0) -> None:
    """Set row ``row`` of ``buf`` in place, sync-free (``row`` (1,) on the
    device): its leading slots along dim 1 to ``head[0]`` (``head``: (1,
    s, ...)), every later slot to ``fill``.  The row index is clamped into
    the batch, and a sentinel (>= the batch) writes back what the clamped
    row holds.  One row is read and written, whatever the batch."""
    bc, s = buf.shape[0], head.shape[1]
    r = row.clamp(max=bc - 1)
    live = (row < bc).reshape(1, *([1] * (buf.dim() - 1)))
    out = buf.index_select(0, r)
    out[:, :s] = torch.where(live, head.to(buf.dtype), out[:, :s])
    out[:, s:].masked_fill_(live, fill)
    buf.index_copy_(0, r, out)


def _cache_prefill_padded(cache: dict, new: dict, plan: PaddedPrompt) -> dict:
    """:func:`_cache_prefill_rows` of one right-padded prompt under a
    device-side plan: row ``plan.row`` ends as a fresh cache that just
    prefilled the prompt's ``plan.length`` real positions (their payload at
    slots 0..L-1, payload 0 and position -1 in every slot past them), the
    padding dropped.  ``new``: {leaf name: (1, S, ...)}, S at most the
    ring's capacity, so no slot wraps (a prompt as long as the ring fills
    it in order, which the roll of :func:`_fresh_rows` leaves as it is)."""
    first = next(iter(new.values()))
    s, cap = first.shape[1], cache["pos"].shape[1]
    if s > cap:
        raise ValueError(f"a padded prompt of {s} positions overflows a ring of {cap}")
    slot = torch.arange(s, device=first.device)
    real = slot < plan.length  # (S,)
    for key, v in new.items():
        write_row(cache[key], plan.row,
                  torch.where(real.reshape(1, s, *([1] * (v.dim() - 2))), v, 0))
    write_row(cache["pos"], plan.row, torch.where(real, slot, -1)[None], fill=-1)
    return cache


def _cache_prefill_rows(cache: dict, new: dict, rows) -> dict:
    """Row-targeted prompt prefill: row ``rows[i]`` ends exactly as a fresh
    cache that just prefilled prompt i (slots past the prompt reset to
    empty; ``new``: {leaf name: (n, S, ...)}).  ``rows`` is the host-side
    admission plan (:func:`plan_rows`), or a :class:`PaddedPrompt`.  Other
    rows and ``length`` are untouched.  A DTensor ring (a sharded segment)
    is written on each rank's shard; its batch must not be sharded."""
    if isinstance(rows, PaddedPrompt):
        return _cache_prefill_padded(cache, new, rows)
    if shard_ctx.is_dtensor(cache["pos"]):
        from torch.distributed.tensor import Shard

        if any(isinstance(p, Shard) and p.dim == 0
               for t in cache.values() for p in t.placements):
            raise NotImplementedError(
                "row-targeted admission into a ring whose batch is sharded")
        _cache_prefill_rows({k: shard_ctx.local(t) for k, t in cache.items()},
                            {k: shard_ctx.like(v, cache[k]) for k, v in new.items()}, rows)
        return cache
    first = next(iter(new.values()))
    plan = plan_rows(rows, cache["pos"].shape[0], first.device)
    if plan is None:
        return cache
    sel, tgt = plan
    vals, fp = _fresh_rows({key: v[sel] for key, v in new.items()},
                           cache["pos"].shape[1],
                           {key: cache[key].dtype for key in new})
    for key, v in vals.items():
        cache[key][tgt] = v
    cache["pos"][tgt] = fp
    return cache


# ============================================= sharded rings (on each shard)
def _cache_write_sharded(cache: dict, new: dict, rows, positions) -> dict:
    """:func:`_cache_write` on a DTensor ring (a sharded tier segment).
    DTensor has no in-place rule for a row-indexed write into a leaf whose
    batch is sharded, so each leaf is written on this rank's shard: every
    write is a row write (lock-step: all rows at ``length % C``), the new
    values are whole over the written rows and take the leaf's shard of
    its other dims, and rows outside the shard become sentinels."""
    c = cache["pos"].shape[1]
    b = next(iter(new.values())).shape[0]
    length = shard_ctx.plain(cache["length"])
    if positions is not None and positions.dim() == 2:
        pos_vec = shard_ctx.plain(positions)[:, 0].to(torch.int32)
    else:
        pos_vec = length.to(torch.int32).expand(b)
    slots = (pos_vec % c).long()
    rows = (torch.arange(b, device=slots.device) if rows is None
            else shard_ctx.plain(rows).long())
    vals = {key: val[:, 0] for key, val in new.items()}
    vals["pos"] = pos_vec
    for key, val in vals.items():
        buf, off = shard_ctx.local_rows(cache[key])
        local = shard_ctx.to_layout_of(val, cache[key], 1)
        r = rows - off
        r = torch.where((r < 0) | (r >= buf.shape[0]), buf.shape[0], r)
        _write_slots(buf, r, slots, local)
    cache["length"] += 1
    return cache


def _local_heads(fn, q, k, v, *args, **kwargs):
    """``fn(q, k, v, ...)`` of plain attention; DTensor operands (a sharded
    segment) run it on this rank's heads, each rank a share of the kv
    heads when the model axes divide them, else every head, and their
    batch shard.  DTensor's rules cannot split an attention einsum whose
    heads are sharded (it flattens them with the batch), so the call runs
    on local tensors."""
    if not shard_ctx.is_dtensor(q):
        return fn(q, k, v, *args, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, kh = q.device_mesh, k.shape[2]
    model = [i for i, n in enumerate(mesh.mesh_dim_names) if n == "model"]
    split = kh % math.prod(mesh.size(i) for i in model) == 0
    pl = [Shard(2) if i in model and split else
          Shard(0) if i not in model and q.shape[0] % mesh.size(i) == 0 else Replicate()
          for i in range(mesh.ndim)]
    out = fn(*(t.redistribute(mesh, pl).to_local() for t in (q, k, v)), *args, **kwargs)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _decode_sharded(qg: torch.Tensor, cache: dict, q_pos, rows, window: int) -> torch.Tensor:
    """:func:`flash_decode_ref` on a DTensor ring (a sharded segment), on
    each rank's shard, with the collectives explicit: DTensor's rules cannot
    split the attention einsum over sharded heads.  ``qg`` (B, 1, K, G, D)
    takes the ring's layout; a ring sharded over head_dim sums its partial
    scores across those ranks; a ring sharded over the batch answers the
    rows it holds, zero elsewhere, and the answers are summed across those
    ranks.  Returns (B, 1, K*G*D), a DTensor sharded over the heads or
    whole."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    k = cache["k"]
    mesh = k.device_mesh
    b, s, kh, g, d = qg.shape
    ring = [p.dim % 4 if isinstance(p, Shard) else None for p in k.placements]
    qpl = [Shard(2) if x == 2 else Shard(4) if x == 3 else Replicate() for x in ring]
    if not shard_ctx.is_dtensor(qg):
        qg = DTensor.from_local(qg, mesh, [Replicate()] * mesh.ndim, run_check=False)
    q = qg.redistribute(mesh, qpl).to_local()[:, 0].float() / math.sqrt(d)
    k_loc, off = shard_ctx.local_rows(k)
    v_loc = cache["v"].to_local()
    k_pos = shard_ctx.plain(cache["pos"])
    bc = k_pos.shape[0]
    r = (torch.arange(b, device=q.device) if rows is None
         else shard_ctx.plain(rows).long().clamp(0, bc - 1))
    mine = (r >= off) & (r < off + k_loc.shape[0])
    lr = torch.where(mine, r - off, 0)
    kk, vv = k_loc[lr].float(), v_loc[lr].float()
    q_pos = torch.as_tensor(shard_ctx.plain(q_pos), device=q.device).expand(b)[:, None]
    sc = torch.einsum("bkgd,bckd->bkgc", q, kk)
    for i, x in enumerate(ring):
        if x == 3:  # head_dim shards: partial scores
            dist.all_reduce(sc, group=mesh.get_group(i))
    kp = k_pos[r]
    valid = (kp >= 0) & (kp <= q_pos)
    if window > 0:
        valid = valid & (q_pos - kp < window)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    o = torch.einsum("bkgc,bckd->bkgd", torch.softmax(sc, dim=-1), vv).to(qg.dtype)
    for i, x in enumerate(ring):
        if x == 0:  # batch shards: each row from the rank that holds it
            o = torch.where(mine[:, None, None, None], o, 0)
            dist.all_reduce(o, group=mesh.get_group(i))
            mine = torch.ones_like(mine)
    opl = [Shard(1) if x == 2 else Shard(3) if x == 3 else Replicate() for x in ring]
    out = DTensor.from_local(o, mesh, opl, run_check=False)
    if any(x == 3 for x in ring):  # head_dim shards: whole before the heads flatten
        out = out.redistribute(mesh, [Replicate() if x == 3 else p
                                      for x, p in zip(ring, opl)])
    return out.reshape(b, s, kh * g * d)


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


def _scale(q: torch.Tensor, scale: float | None) -> float:
    """The score scale: ``scale``, else 1/sqrt of q's last dimension."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, window: int,
                   scale: float | None = None, k_pos: torch.Tensor | None = None):
    """(out, m, l): the output and each row's softmax max and sum.  The
    queries sit at ``positions``, the keys at ``k_pos`` (default: the
    same positions)."""
    s = q.shape[1]
    k_pos = positions if k_pos is None else k_pos
    qf = (q * _scale(q, scale)).float()
    kf, vf = k.float(), v.float()
    outs, ms, ls = [], [], []
    for q0 in range(0, s, _BLOCK_Q):
        sc = _masked_scores(qf[:, q0:q0 + _BLOCK_Q], kf,
                            positions[q0:q0 + _BLOCK_Q], k_pos, window)
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
    scale: float | None = None,
    k_pos: torch.Tensor | None = None,  # (Sk,): keys' positions if not q's
) -> torch.Tensor:
    """Causal (optionally banded) attention over a prompt, fp32 scores and
    the reference's softmax form (m = max(-1e30, max s), p = e^(s - m),
    out = p v / max(sum p, 1e-30)).  Not a kernel in either package: the
    reference runs plain jnp here.  Queries are taken ``_BLOCK_Q`` at a
    time to bound the (S, S) score memory.  ``scale`` multiplies the
    queries (default 1/sqrt(D)); v's head width may differ from q's and
    k's (MLA: 192 against 128).  ``k_pos``: the keys' own positions
    (cross-attention over encoder frames)."""
    return _attention_fwd(q, k, v, positions, window, scale, k_pos)[0]


class FlashAttention(torch.autograd.Function):
    """:func:`prefill_attention` with the reference's recompute backward
    (``_flash_vjp``): the forward keeps only (q, k, v, out, m, l), and the
    backward recomputes each query block's probabilities p from them, with
    ``delta = sum(dout * out)``, ``ds = p (dp - delta)`` and the scale
    folded into dq at the end.  Nothing of size (Sq, Sk) is saved, where
    plain autograd would keep every block's fp32 scores.  Plain PyTorch,
    as the reference's is plain jnp: neither package trains on a kernel.

    ``FlashAttention.apply(q, k, v, positions, window, scale=None,
    k_pos=None)``; ``k_pos`` as in :func:`prefill_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, positions, window, scale=None, k_pos=None):
        k_pos = positions if k_pos is None else k_pos
        out, m, l = _attention_fwd(q, k, v, positions, window, scale, k_pos)
        ctx.save_for_backward(q, k, v, positions, k_pos, out, m, l)
        ctx.window = window
        ctx.scale = _scale(q, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, positions, k_pos, out, m, l = ctx.saved_tensors
        s, scale = q.shape[1], ctx.scale
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
            sc = _masked_scores(qf[:, blk], kf, positions[blk], k_pos, ctx.window)
            p = torch.exp(sc - m[:, blk, ..., None]) / lsafe[:, blk, ..., None]
            dv += torch.einsum("bqkgs,bqkgd->bskd", p, do[:, blk])
            dp = torch.einsum("bqkgd,bskd->bqkgs", do[:, blk], vf)
            ds = p * (dp - delta[:, blk, ..., None])
            dq[:, blk] = torch.einsum("bqkgs,bskd->bqkgd", ds, kf)
            dk += torch.einsum("bqkgs,bqkgd->bskd", ds, qf[:, blk])
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


# ============================================================== standard GQA
def attn_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,) shared, or (B, 1) per sequence at decode
    cache: dict | None = None,
    *,
    use_rope: bool = True,
    window: int | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
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
    ``flash_decode`` kernel instead of its plain version.

    ``use_rope=False``: no rotation (Whisper's absolute positions are
    added to the embeddings instead).  ``kv_override`` (cache None): the
    precomputed encoder (K, V), each (B, S_enc, Kh, D): cross-attention,
    the queries at position S_enc over keys at 0..S_enc-1 (every frame
    visible, as the reference masks it), no cache write.  Plain PyTorch:
    the reference has no kernel for it."""
    b, s, _ = x.shape
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // kh
    window = cfg.sliding_window if window is None else window
    dtype = x.dtype

    q = shard_ctx.split_dim(dense(params["wq"], x, dtype), -1, (kh * g, hd))
    if kv_override is None:
        k = shard_ctx.split_dim(dense(params["wk"], x, dtype), -1, (kh, hd))
        v = shard_ctx.split_dim(dense(params["wv"], x, dtype), -1, (kh, hd))
    else:
        k, v = kv_override
    if cfg.use_qk_norm:
        # Qwen3: each head normalized over head_dim before RoPE, so the
        # cache holds normalized, rotated keys (prefill and decode alike).
        q = rmsnorm(params["q_norm"], q)
        if kv_override is None:
            k = rmsnorm(params["k_norm"], k)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_override is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    qg = shard_ctx.split_dim(q, 2, (kh, g))

    if kv_override is not None:
        s_enc = k.shape[1]
        k_pos = torch.arange(s_enc, dtype=torch.int32, device=x.device)
        q_pos = torch.full((s,), s_enc, dtype=torch.int32, device=x.device)
        out = _local_heads(FlashAttention.apply, qg, k, v, q_pos, 0, None, k_pos)
    elif cache is not None and s > 1:
        if rows is None:
            _cache_prefill(cache, {"k": k, "v": v})
        else:
            _cache_prefill_rows(cache, {"k": k, "v": v}, rows)
        out = _local_heads(prefill_attention, qg, k, v, positions, window=window)
    elif cache is not None:
        _cache_write(cache, {"k": k, "v": v}, rows, positions)
        if cfg.decode_qhd_shard:
            # Attention in the cache's head-dim-sharded layout: scores
            # become partial sums instead of resharding the cache or q.
            qg = shard_ctx.constrain(qg, "b...v")
        q_pos = positions[:, 0] if positions.dim() == 2 else positions[0]
        if shard_ctx.is_dtensor(cache["k"]):
            out = _decode_sharded(qg, cache, q_pos, rows, window)
        else:
            decode = kernel_ops.flash_decode if use_kernels else flash_decode_ref
            out = decode(qg.reshape(b, kh * g, hd), cache["k"], cache["v"],
                         cache["pos"], q_pos, rows, window=window)[:, None]
    else:
        out = _local_heads(FlashAttention.apply, qg, k, v, positions, window)
    out = shard_ctx.merge_dims(out, 2)
    return dense(params["wo"], out, dtype), cache


# ======================================================================= MLA
def init_mla_cache(batch: int, capacity: int, cfg: ModelConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    """An empty MLA latent ring on ``device`` (default: the current CUDA
    device): ``ckv`` (B, C, kv_rank), the latent every head's K and V
    expand from; ``k_rope`` (B, C, rope_dim), the RoPE key all heads share;
    ``pos`` and ``length`` as in the KV ring."""
    device = kernel_ops.resolve_device(device)
    return {
        "ckv": torch.zeros((batch, capacity, cfg.mla_kv_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, capacity, cfg.mla_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def _mla_qkr(params: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The query path through its low-rank bottleneck: (q_nope (B, S, H,
    hd), q_rope (B, S, H, rope_dim) with RoPE applied)."""
    b, s, _ = x.shape
    h, hd, r_rope = cfg.num_heads, cfg.head_dim, cfg.mla_rope_dim
    dtype = x.dtype
    qa = rmsnorm(params["q_norm"], dense(params["wq_a"], x, dtype))
    qb = dense(params["wq_b"], qa, dtype).reshape(b, s, h, hd + r_rope)
    q_nope, q_rope = qb[..., :hd], qb[..., hd:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_decode(params: dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
                cache: dict, cfg: ModelConfig, positions: torch.Tensor,
                rows, scale: float) -> torch.Tensor:
    """Absorbed decode over the latent ring (cache already written): W_uk
    folded into the query, scores and the latent read-out in fp32 (the
    reference's casts), then W_uv.  Returns (B, 1, H, hd).  A sentinel
    row reads a clamped row; its output is discarded by the caller."""
    h, hd, r_kv = cfg.num_heads, cfg.head_dim, cfg.mla_kv_rank
    dtype = q_nope.dtype
    ckv, rope, pos = cache["ckv"], cache["k_rope"], cache["pos"]
    if rows is not None:
        r = rows.long().clamp(max=ckv.shape[0] - 1)
        ckv, rope, pos = ckv[r], rope[r], pos[r]
    ckv_f = ckv.float()
    wk_b = params["wk_b"].to(dtype).reshape(r_kv, h, hd)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)
    s_lat = torch.einsum("bshr,bcr->bshc", q_lat.float(), ckv_f)
    s_rope = torch.einsum("bshr,bcr->bshc", q_rope.float(), rope.float())
    logits = (s_lat + s_rope) * scale  # (B, 1, H, C)
    q_pos = positions if positions.dim() == 2 else positions[None]  # (B|1, 1)
    mask = (q_pos[..., None] >= pos[:, None, :]) & (pos[:, None, :] >= 0)
    if cfg.sliding_window > 0:
        mask = mask & (q_pos[..., None] - pos[:, None, :] < cfg.sliding_window)
    logits = torch.where(mask[:, :, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bshc,bcr->bshr", p, ckv_f)
    wv_b = params["wv_b"].to(dtype).reshape(r_kv, h, hd)
    return torch.einsum("bshr,rhd->bshd", o_lat.to(dtype), wv_b)


def mla_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,) shared, or (B, 1) per sequence at decode
    cache: dict | None = None,
    *,
    rows=None,
) -> tuple[torch.Tensor, dict | None]:
    """DeepSeek-V3's Multi-head Latent Attention [arXiv:2412.19437]: the
    queries through a low-rank bottleneck, keys and values through one
    latent shared by the heads, plus a small RoPE key every head shares;
    only (latent, RoPE key) is cached — 1,152 B a slot a layer in bf16 at
    the published ranks, against 64 KiB for 128 full K/V heads of 128.

    ``cache=None`` or S > 1 (training, prefill): the latent expanded to
    per-head K (128 + 64 wide with the shared RoPE key) and V (128), through
    :class:`FlashAttention` (cache-free) or :func:`prefill_attention`
    (writing the ring: ``rows`` targets admitted rows, a host-side plan),
    scaled by 1/sqrt(hd + rope_dim).  S == 1 with a cache: the absorbed
    decode in the latent space (:func:`_mla_decode`) after writing the
    step — lock-step at ``length``, per sequence under (B, 1) positions,
    or into ``rows`` of the full-batch ring (a device tensor; sentinel
    rows drop their writes).  Plain PyTorch: the reference has no kernel
    for MLA."""
    b, s, _ = x.shape
    h, hd, r_rope = cfg.num_heads, cfg.head_dim, cfg.mla_rope_dim
    r_kv = cfg.mla_kv_rank
    dtype = x.dtype
    scale = 1.0 / math.sqrt(hd + r_rope)

    q_nope, q_rope = _mla_qkr(params, x, cfg, positions)
    kv = dense(params["wkv_a"], x, dtype)  # (B, S, r_kv + r_rope)
    ckv = rmsnorm(params["kv_norm"], kv[..., :r_kv])
    k_rope = apply_rope(kv[..., None, r_kv:], positions, cfg.rope_theta)[:, :, 0]

    if cache is None or s > 1:
        k_nope = dense(params["wk_b"], ckv, dtype).reshape(b, s, h, hd)
        v = dense(params["wv_b"], ckv, dtype).reshape(b, s, h, hd)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, r_rope)],
                           dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1).reshape(b, s, h, 1, hd + r_rope)
        if cache is None:
            out = _local_heads(FlashAttention.apply, q_full, k_full, v, positions,
                               cfg.sliding_window, scale)
        else:
            new = {"ckv": ckv, "k_rope": k_rope}
            if rows is None:
                _cache_prefill(cache, new)
            else:
                _cache_prefill_rows(cache, new, rows)
            out = _local_heads(prefill_attention, q_full, k_full, v, positions,
                               window=cfg.sliding_window, scale=scale)
    else:
        _cache_write(cache, {"ckv": ckv, "k_rope": k_rope}, rows, positions)
        out = _mla_decode(params, q_nope, q_rope, cache, cfg, positions, rows, scale)
    out = shard_ctx.merge_dims(out, 2)
    return dense(params["wo"], out, dtype), cache
