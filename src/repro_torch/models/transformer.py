"""Block assembly and layer-stack execution — counterpart of
``repro.models.transformer`` for ``BlockKind("gqa", "dense")``.

Parameters keep the reference's stacked layout: every leaf of a stack
carries a leading ``(n_layers,)`` axis.  A Python loop over the layers
takes the place of ``lax.scan``; each layer reads its slice of the stacked
params and of the stacked caches (views, so cache writes land in place).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import mlp_apply, norm_apply

__all__ = ["BlockKind", "block_apply", "layer_slice", "run_stack"]


@dataclasses.dataclass(frozen=True)
class BlockKind:
    mixer: str  # "gqa" (the only mixer ported so far)
    mlp: str  # "dense"
    use_rope: bool = True


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree (views of every leaf)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def block_apply(
    params: dict,
    h: torch.Tensor,
    cfg: ModelConfig,
    kind: BlockKind,
    positions: torch.Tensor,
    cache: dict | None = None,
    *,
    rows=None,
    use_kernels: bool = False,
) -> torch.Tensor:
    """One pre-norm residual block: attention then MLP.  ``cache`` (this
    layer's view) is updated in place."""
    if kind != BlockKind("gqa", "dense"):
        raise NotImplementedError(f"the port has no {kind} block yet")
    hn = norm_apply(cfg.norm_type, params["norm1"], h)
    y, _ = attn_mod.attn_apply(
        params["attn"], hn, cfg, positions,
        cache["self"] if cache else None,
        rows=rows, use_kernels=use_kernels and cache is not None,
    )
    h = h + y
    hn = norm_apply(cfg.norm_type, params["norm2"], h)
    return h + mlp_apply(params["mlp"], hn, cfg.mlp_type)


def run_stack(
    stacked_params: dict,
    h: torch.Tensor,
    cfg: ModelConfig,
    kind: BlockKind,
    positions: torch.Tensor,
    caches: dict | None = None,
    *,
    lo: int,
    hi: int,
    rows=None,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Run layers ``[lo, hi)`` of a stack over the residual stream; stacked
    ``caches`` are updated in place."""
    for i in range(lo, hi):
        h = block_apply(
            layer_slice(stacked_params, i), h, cfg, kind, positions,
            layer_slice(caches, i) if caches is not None else None,
            rows=rows, use_kernels=use_kernels,
        )
    return h
