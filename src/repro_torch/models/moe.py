"""Mixture-of-Experts: top-k router + capacity-based dispatch/combine —
counterpart of ``repro.models.moe``.

Tokens are processed in fixed-size groups (``group_size``, the last group
padded with zero tokens); per group every expert has
``C = ceil(group_tokens * top_k * capacity_factor / num_experts)`` slots.
A (token, choice) takes the next free slot of its expert in token-major
order over the flattened ``(T * k)`` axis; choices past ``C`` are dropped
(their combine weight is zero and the residual path carries the token).
At a decode step of 8 rows of Qwen3-30B-A3B (128 experts, top-8) ``C`` is
1, so which choices survive depends on every other row of the group: the
reference drops them too, and so does the port.

Three dispatch modes, as in the reference:

  * ``"einsum"`` — the dense one-hot ``(G, T, k, E, C)`` dispatch and
    combine, contracted with ``torch.einsum`` (slot ``C`` is the drop
    bucket, cut off);
  * ``"onehot_small"`` — the same math through an owner table per group
    (which token fills each ``(expert, slot)``) and gathers;
  * ``"auto"`` — ``"einsum"`` while the reference's dense-dispatch
    footprint rule (``disp_bytes <= 2e9``) allows it.

Routing is a softmax in fp32, then the top ``k`` with the reference's tie
rule: ``jax.lax.top_k`` keeps the lower expert index first among equal
probabilities, and bf16 router logits tie often.  ``torch.topk`` does not
promise an order among ties; a stable descending sort does.  The router's
Switch load-balance loss is ``E * sum_e(frac_tokens_e / k * mean_prob_e)``
over every token of every group, padding tokens included, as the reference
computes it.

Everything here has static shapes (``C`` and the group count come from
shapes on the host) and makes no host sync, so a served step that runs it
captures in a CUDA graph.  Under a sharded segment's activation context
the ``constrain`` calls pin the expert axis to ``model`` and the output's
batch (the reference's sharding annotations); without one they return
their input.

Params of a stack of ``n`` MoE blocks (leading ``(n,)`` axis):
    {"router": (n, d, E), "w_gate", "w_up": (n, E, d, ff),
     "w_down": (n, E, ff, d),
     "shared": {"w_gate", "w_up": (n, d, ff * S), "w_down": (n, ff * S, d)}
               (with ``num_shared_experts`` S > 0)}
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, silu, truncated_normal_
from repro_torch.sharding.ctx import constrain, is_dtensor, local_part

__all__ = ["moe_init", "moe_apply", "router_topk", "expert_slots"]


def moe_init(cfg: ModelConfig, n_layers: int, generator: torch.Generator,
             device, dtype: torch.dtype = torch.float32) -> dict:
    """Random params of ``n_layers`` MoE blocks, stacked, in ``dtype``:
    the router N(0, 0.02^2) truncated at 2 sigma, fan-in scaled truncated
    normals for the experts.  The expert leaves are drawn one layer at a
    time and cast as they are copied into the stack, so the fp32 draw of
    one layer's leaf is the transient (Qwen3-30B-A3B: 0.8 GB, against 38.6
    GB for a whole fp32 stack; DeepSeek-V3: 15 GB)."""
    d, ff, e, n = cfg.d_model, cfg.moe_d_ff, cfg.num_experts, n_layers

    def draw(shape, scale):
        t = torch.empty(shape, device=device)
        return truncated_normal_(t, generator, scale).to(dtype)

    def experts(d_in, d_out):
        # Each layer's fp32 draw is cast as it is copied into the stack, so
        # no second (bf16) copy of the layer stands beside it.
        out = torch.empty((n, e, d_in, d_out), dtype=dtype, device=device)
        for i in range(n):
            t = torch.empty((e, d_in, d_out), device=device)
            out[i].copy_(truncated_normal_(t, generator, d_in ** -0.5))
            del t
        return out

    p = {
        "router": draw((n, d, e), 0.02),
        "w_gate": experts(d, ff),
        "w_up": experts(d, ff),
        "w_down": experts(ff, d),
    }
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": draw((n, d, sff), d ** -0.5),
            "w_up": draw((n, d, sff), d ** -0.5),
            "w_down": draw((n, sff, d), sff ** -0.5),
        }
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``idx[..., None] == arange(n)`` as ``dtype``: a comparison, so no
    value check (``F.one_hot`` reads the indices' range on the CPU)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_topk(logits: torch.Tensor, top_k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax-then-top-k routing, the selected mass renormalized.

    Returns (weights (..., top_k) in ``logits.dtype``, indices (...,
    top_k) int64, the Switch aux loss () fp32).  Among equal
    probabilities the lower expert index comes first."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :top_k], idx[..., :top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    e = logits.shape[-1]
    onehot = _one_hot(idx, e, torch.float32)  # (..., top_k, E)
    # Sums over the leading dims, not over a flattened view: DTensor cannot
    # unflatten the gradient of a sharded group axis.
    frac = onehot.sum(dim=tuple(range(onehot.dim() - 1)))
    mean_prob = probs.mean(dim=tuple(range(probs.dim() - 1)))
    frac = frac / float(math.prod(onehot.shape[:-2]))
    aux = e * torch.sum(frac / top_k * mean_prob)
    return w.to(logits.dtype), idx, aux


def expert_slots(idx: torch.Tensor, num_experts: int, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot (G, T, k), keep (G, T, k)) of each choice: its place in its
    expert's buffer, counted over the group's choices token-major (the
    flattened ``(T * k)`` axis), and whether that place is below ``cap``."""
    g, t, k = idx.shape
    flat = idx.reshape(g, t * k)
    onehot = _one_hot(flat, num_experts, torch.int32)  # (G, T*k, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - 1
    pos = pos_in_e.gather(-1, flat[..., None])[..., 0].reshape(g, t, k)
    return pos, pos < cap


def _experts_ffn(p: dict, x_e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-expert SwiGLU on (G, E, C, d) -> (G, E, C, d): one batched
    product per expert weight, every group's slots together.  DTensor
    operands (a sharded segment) run on each rank's experts."""
    if is_dtensor(x_e):
        return _experts_ffn_local(p, x_e, dtype)
    g = torch.einsum("gecd,edf->gecf", x_e, p["w_gate"].to(dtype))
    u = torch.einsum("gecd,edf->gecf", x_e, p["w_up"].to(dtype))
    return torch.einsum("gecf,efd->gecd", silu(g) * u, p["w_down"].to(dtype))


def _experts_ffn_local(p: dict, x_e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_experts_ffn` on each rank's shards, on local tensors.
    DTensor's einsum rules flatten the expert axis with the slots, which
    they cannot split as the policy shards it (a local view that does not
    exist, or no rule).  Per mesh axis, by the weights' placements:

      * experts sharded: ``x_e`` and the output take the same experts;
      * the hidden (ff) dim sharded in all three weights: each rank runs
        its slice of the hidden units and the output is a partial sum
        (no weight moves);
      * otherwise the weights are gathered over the axis (the FSDP gather)
        and ``x_e`` keeps a shard of its groups, or is whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x_e.device_mesh

    def sharded(t):
        return {i: q.dim for i, q in enumerate(t.placements) if isinstance(q, Shard)}

    gate, up, down = (sharded(p[k]) for k in ("w_gate", "w_up", "w_down"))
    w_pl = {k: [] for k in ("w_gate", "w_up", "w_down")}
    x_pl, out_pl, x_partial, w_partial = [], [], [], []
    for i, q in enumerate(x_e.placements):
        if gate.get(i) == 0:  # experts
            x, out, keep = Shard(1), Shard(1), True
        elif gate.get(i) == 2 and up.get(i) == 2 and down.get(i) == 1:  # hidden
            x, out, keep = Replicate(), Partial(), True
            x_partial.append(i)
        else:
            x = q if isinstance(q, Shard) and q.dim == 0 else Replicate()
            out, keep = x, False
            if isinstance(x, Shard):
                w_partial.append(i)
        x_pl.append(x)
        out_pl.append(out)
        for k in w_pl:
            w_pl[k].append(p[k].placements[i] if keep else Replicate())
    w = {k: local_part(p[k], pl, w_partial) for k, pl in w_pl.items()}
    y = _experts_ffn(w, local_part(x_e, x_pl, x_partial), dtype)
    return DTensor.from_local(y, mesh, out_pl, run_check=False)


def _combine(comb: torch.Tensor, y_e: torch.Tensor) -> torch.Tensor:
    """``einsum("gtec,gecd->gtd")``: each token's weighted sum of its slots'
    outputs.  DTensor operands (a sharded segment) run on each rank's
    shards: the einsum would flatten the expert axis with the slots, which
    DTensor (torch 2.11) cannot do with the experts sharded.  ``comb``
    takes ``y_e``'s expert and group shards; a sum over this rank's
    experts (or its share of the hidden units) is a partial sum."""
    if not is_dtensor(y_e):
        return torch.einsum("gtec,gecd->gtd", comb, y_e)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = y_e.device_mesh
    if not is_dtensor(comb):
        comb = DTensor.from_local(comb, mesh, [Replicate()] * mesh.ndim, run_check=False)
    y_pl, c_pl, out_pl = [], [], []
    for q, cq in zip(y_e.placements, comb.placements):
        if isinstance(q, Shard) and q.dim == 1:  # experts
            y_pl.append(q), c_pl.append(Shard(2)), out_pl.append(Partial())
        elif q.is_partial():  # the hidden units' partial sums
            y_pl.append(q), c_pl.append(Replicate()), out_pl.append(Partial())
        elif isinstance(q, Shard) and q.dim == 0 or isinstance(cq, Shard) and cq.dim == 0:
            y_pl.append(Shard(0)), c_pl.append(Shard(0)), out_pl.append(Shard(0))
        else:
            y_pl.append(Replicate()), c_pl.append(Replicate()), out_pl.append(Replicate())
    partial = [i for i, q in enumerate(y_e.placements) if q.is_partial()]
    y = torch.einsum("gtec,gecd->gtd", local_part(comb, c_pl, partial),
                     local_part(y_e, y_pl))
    return DTensor.from_local(y, mesh, out_pl, run_check=False)


def moe_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    group_size: int = 256,
    dispatch: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), router aux loss () fp32)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dtype = x.dtype
    if dispatch == "auto":
        # The reference's per-device dense-dispatch footprint on its
        # canonical 16 x 16 mesh: tokens * gsz * topk * cf * 2 B / 256.
        tokens_total = b * s
        disp_bytes = (tokens_total * min(group_size, tokens_total) * k
                      * cfg.capacity_factor * 2 / 256)
        dispatch = "einsum" if disp_bytes <= 2e9 else "onehot_small"
    if dispatch not in ("einsum", "onehot_small"):
        raise ValueError(dispatch)

    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    gsz = min(group_size, t)
    pad = (-t) % gsz
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    ng = tokens.shape[0] // gsz
    xg = tokens.reshape(ng, gsz, d)

    logits = dense(params["router"], xg, dtype)  # (G, T, E)
    w, idx, aux = router_topk(logits, k)  # (G, T, k) each
    cap = max(math.ceil(gsz * k * cfg.capacity_factor / e), 1)
    pos, keep = expert_slots(idx, e, cap)
    w = torch.where(keep, w, 0.0)

    if dispatch == "einsum":
        slot = torch.where(keep, pos, cap)
        disp = (_one_hot(idx, e, dtype)[..., None]
                * _one_hot(slot, cap + 1, dtype)[..., None, :])[..., :cap]
        # (G, T, k, E, C): slot `cap` was the drop bucket.
        x_e = torch.einsum("gtec,gtd->gecd", disp.sum(2), xg)
        # The expert axis on "model": the experts' FFN runs expert-parallel.
        x_e = constrain(x_e, ".v..")
        y_e = _experts_ffn(params, x_e, dtype)
        comb = (disp * w[..., None, None]).sum(2)  # (G, T, E, C)
        yg = _combine(comb, y_e)
    else:
        # The owner table: which token fills each (expert, slot), the pad
        # index gsz where none does.  Every write lands in range: dropped
        # choices all go to the extra column `cap`, which is cut off (the
        # reference's scatter with mode="drop" writes the same table).
        slot = torch.where(keep, pos, cap)
        tok_ids = torch.arange(gsz, device=x.device).view(1, gsz, 1).expand(ng, gsz, k)
        owner = torch.full((ng, e * (cap + 1)), gsz, dtype=torch.int64, device=x.device)
        owner.scatter_(1, (idx * (cap + 1) + slot).reshape(ng, -1),
                       tok_ids.reshape(ng, -1))
        owner = owner.view(ng, e, cap + 1)[:, :, :cap]
        grp = torch.arange(ng, device=x.device).view(ng, 1, 1)
        xg_pad = torch.cat([xg, xg.new_zeros(ng, 1, d)], dim=1)
        y_e = _experts_ffn(params, xg_pad[grp, owner], dtype)  # (G, E, C, d)
        # Combine: each token sums its surviving choices.
        gathered = y_e[grp, idx, torch.where(keep, pos, 0)]  # (G, T, k, d)
        yg = (gathered * w[..., None]).sum(2)

    y = constrain(yg.reshape(-1, d)[:t].reshape(b, s, d), "b..")
    if cfg.num_shared_experts:
        sp = params["shared"]
        g = dense(sp["w_gate"], x, dtype)
        u = dense(sp["w_up"], x, dtype)
        y = y + dense(sp["w_down"], silu(g) * u, dtype)
    return y, aux
