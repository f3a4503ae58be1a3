"""Optimizers over dicts of tensors: AdamW and Adafactor — counterpart of
``repro.training.optimizer``.

The reference's functional form is kept: ``Optimizer(init, update)`` with
``update(grads, state, params, step) -> (new_params, new_state)``, ``step``
an int32 tensor (the number of updates taken so far).  Each update runs in
fp32 and casts back to each param's dtype; nothing is updated in place.

Adafactor (factored second moments, no first moment) is the reference's
choice above ~30B params, where AdamW's 8 bytes/param of fp32 state do not
fit.  ``torch.optim.Adafactor`` scales its step differently and
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so both are
written out as the reference writes them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.training.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer", "cosine_schedule",
           "global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor`` x
    ``peak_lr`` at ``total``; ``lr(step)`` is an fp32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        frac = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else (lambda _: lr)


def adamw(
    lr: Callable | float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):  # a DTensor param's moments take its placements
            return torch.zeros_like(p, dtype=torch.float32)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        grads = _clip_by_global_norm(grads, grad_clip)
        stepf = step.float() + 1.0
        lr_t = lr_fn(step)

        def upd(g, m, v, p):
            # The reference's arithmetic op for op; the in-place steps act
            # on temporaries only, so that a leaf's update holds fewer fp32
            # copies of it at once.
            g = g.float()
            m = (b1 * m).add_((1 - b1) * g)
            v = (b2 * v).add_(((1 - b2) * g).mul_(g))
            denom = torch.sqrt(v / (1 - b2 ** stepf)).add_(eps)
            delta = (m / (1 - b1 ** stepf)).div_(denom)
            del denom
            delta = delta.add_(weight_decay * p.float()).mul_(lr_t)
            return torch.sub(p.float(), delta).to(p.dtype), m, v

        out = tree_map(upd, grads, state["m"], state["v"], params)
        return _part(out, 0, 3), {"m": _part(out, 1, 3), "v": _part(out, 2, 3)}

    return Optimizer(init, update)


def adafactor(
    lr: Callable | float = 1e-2,
    decay: float = 0.8,
    eps1: float = 1e-30,
    eps2: float = 1e-3,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Shazeer & Stern 2018, factored second moments for >= 2-D params."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros((*p.shape[:-2], p.shape[-1]), **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return tree_map(st, params)

    def update(grads, state, params, step):
        stepf = step.float() + 1.0
        beta = 1.0 - stepf ** (-decay)
        lr_t = lr_fn(step)

        def upd(s, g, p):
            g = g.float()
            g2 = g * g + eps1
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True).clamp(min=eps1)
                u = g / torch.sqrt((vr / denom)[..., None] * vc[..., None, :] + eps1)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / torch.sqrt(v + eps1)
                new_s = {"v": v}
            # Update clipping (RMS <= clip_threshold).
            rms = torch.sqrt((u * u).mean() + eps1)
            u = u / (rms / clip_threshold).clamp(min=1.0)
            scale = _rms(p).clamp(min=eps2) * lr_t
            newp = p.float() - scale * u
            if weight_decay:
                newp = newp - lr_t * weight_decay * p.float()
            return newp.to(p.dtype), new_s

        # The per-param state dicts are the traversal's leaves; grads and
        # params align underneath as tensors.
        out = tree_map(upd, state, grads, params, is_leaf=_state_leaf)
        return _part(out, 0, 2), _part(out, 1, 2)

    return Optimizer(init, update)


def make_optimizer(name: str, lr=None, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr or 3e-4, **kw)
    if name == "adafactor":
        return adafactor(lr=lr or 1e-2, **kw)
    raise ValueError(name)


# ----------------------------------------------------------------- helpers
def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.float().square().mean())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


def _clip_by_global_norm(grads, max_norm: float):
    if not max_norm:
        return grads
    scale = (max_norm / global_norm(grads).clamp(min=1e-12)).clamp(max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def _part(out, i: int, n: int):
    """Field ``i`` of the ``n``-tuples at the leaves of ``out``."""
    def tup(x):
        return isinstance(x, tuple) and len(x) == n

    return tree_map(lambda t: t[i], out, is_leaf=tup)


def _state_leaf(x) -> bool:
    return isinstance(x, dict) and ("v" in x or "vr" in x)
