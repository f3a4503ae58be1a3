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
from repro_torch.training.optimizer import Optimizer, global_norm
from repro_torch.training.tree import tree_leaves, tree_map

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(params: dict, opt: Optimizer) -> dict:
    """{"params", "opt" (the optimizer's state), "step" (int32, on the
    params' device)}."""
    device = tree_leaves(params)[0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _value_and_grad(params: dict, batch: dict, cfg: ModelConfig,
                    moe_dispatch: str = "einsum"):
    """(forward_train's outputs, the loss's gradient tree)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    out = forward_train(tree_map(lambda _: next(it), params), batch, cfg,
                        moe_dispatch=moe_dispatch)
    grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return out, tree_map(lambda _: next(it), params)


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
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                   device=p.device), params)
            loss = 0.0
            for i in range(accum):
                micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                         for k, v in batch.items()}
                out, g = _value_and_grad(params, micro, cfg, moe_dispatch)
                tree_map(lambda a, b: a.add_(b.to(acc_dtype)), grads, g)
                loss = loss + out["loss"].detach()
                del out, g
            tree_map(lambda g: g.div_(accum), grads)
            loss = loss / accum
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, state["opt"], params, state["step"])
            metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        if accum == 1:
            metrics["main_loss"] = out["main_loss"].detach()
            metrics["aux_loss"] = out["aux_loss"].detach()
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step
