"""Train step with gradient accumulation and the BranchyNet joint loss —
counterpart of ``repro.training.train_loop``.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``, a function of its inputs: the state it is given is left as it
was.  Gradients come from ``torch.autograd.grad`` over the leaves of the
params tree; with accumulation the global batch is cut into ``accum``
microbatches, one after the other, whose gradients add up in
``cfg.accum_dtype`` and are divided by ``accum``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward_train
from repro_torch.sharding.ctx import constrain, is_dtensor
from repro_torch.training.optimizer import Optimizer, global_norm
from repro_torch.training.tree import tree_leaves, tree_map

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(params: dict, opt: Optimizer, policy=None) -> dict:
    """{"params", "opt" (the optimizer's state), "step" (int32, on the
    params' device)}.  With a sharding ``policy`` the params are placed by
    its ``shard_params`` and the optimizer state (``policy.cfg.optimizer``'s)
    by its ``shard_opt_state``; ``step`` stays a plain tensor, which the
    mesh context counts as replicated."""
    device = tree_leaves(params)[0].device
    if policy is None:
        opt_state = opt.init(params)
    else:
        params = policy.shard_params(params)
        opt_state = policy.shard_opt_state(opt.init(params), params, policy.cfg.optimizer)
    return {"params": params, "opt": opt_state,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _value_and_grad(params: dict, batch: dict, cfg: ModelConfig,
                    moe_dispatch: str = "einsum"):
    """(forward_train's outputs, the loss's gradient tree)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    out = forward_train(tree_map(lambda _: next(it), params), batch, cfg,
                        moe_dispatch=moe_dispatch)
    grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else _placed_like(g, p)
              for p, g in zip(leaves, grads))
    return out, tree_map(lambda _: next(it), params)


def _placed_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` in ``ref``'s placements (a DTensor: a partial sum is reduced,
    a whole tensor sliced); ``t`` itself without a mesh."""
    if is_dtensor(ref) and tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def _microbatches(v: torch.Tensor, accum: int) -> list[torch.Tensor]:
    """The ``accum`` microbatches of a batch leaf: microbatch ``i`` holds
    rows ``[i * B / accum, (i + 1) * B / accum)`` of its leading axis, as
    the reference cuts it.  A DTensor leaf is gathered once and each
    microbatch split over the batch axes again (the reference's
    ``constrain(a, ".b...")``), so no rank holds a microbatch whole."""
    if not is_dtensor(v):
        return list(v.reshape(accum, v.shape[0] // accum, *v.shape[1:]).unbind(0))
    from torch.distributed.tensor import Replicate

    whole = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)
    m = v.shape[0] // accum
    return [constrain(whole[i * m:(i + 1) * m], "b" + "." * (v.dim() - 1))
            for i in range(accum)]


def make_train_step(cfg: ModelConfig, opt: Optimizer, *,
                    moe_dispatch: str = "einsum",
                    accum: int | None = None) -> Callable[[dict, dict], tuple[dict, dict]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` leaves have a leading global-batch axis; ``accum`` (default
    ``cfg.grad_accum``) cuts it into that many equal microbatches.
    ``moe_dispatch``: the MoE blocks' dispatch mode in ``forward_train``.
    Metrics: ``loss``, ``grad_norm`` (before clipping) and, when ``accum
    == 1``, ``main_loss`` and ``aux_loss``."""
    accum = max(accum if accum is not None else cfg.grad_accum, 1)
    acc_dtype = torch.bfloat16 if cfg.accum_dtype == "bfloat16" else torch.float32

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        if accum == 1:
            out, grads = _value_and_grad(params, batch, cfg, moe_dispatch)
            loss = out["loss"]
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype), params)
            loss = 0.0
            micros = {k: _microbatches(v, accum) for k, v in batch.items()}
            for i in range(accum):
                micro = {k: ms[i] for k, ms in micros.items()}
                out, g = _value_and_grad(params, micro, cfg, moe_dispatch)
                tree_map(lambda a, b: a.add_(b.to(acc_dtype)), grads, g)
                loss = loss + out["loss"].detach()
                del out, g
            tree_map(lambda g: g.div_(accum), grads)
            loss = loss / accum
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, state["opt"], params, state["step"])
            new_params = tree_map(_placed_like, new_params, params)
            new_opt = tree_map(_placed_like, new_opt, state["opt"])
            metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        if accum == 1:
            metrics["main_loss"] = out["main_loss"].detach()
            metrics["aux_loss"] = out["aux_loss"].detach()
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step
