"""Block assembly and layer-stack execution — counterpart of
``repro.models.transformer`` for ``BlockKind("gqa", "dense")`` (the dense
trunk and Zamba2's shared attention block) and ``BlockKind("mamba",
"none")`` (the Mamba2 trunk).

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
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.layers import mlp_apply, norm_apply, truncated_normal_

__all__ = [
    "BlockKind",
    "block_apply",
    "init_block_cache",
    "layer_slice",
    "run_stack",
    "stack_init",
]

_PORTED = {("gqa", "dense"), ("mamba", "none")}


@dataclasses.dataclass(frozen=True)
class BlockKind:
    mixer: str  # "gqa" | "mamba"
    mlp: str  # "dense" | "none"
    use_rope: bool = True


def _check(kind: BlockKind) -> None:
    if (kind.mixer, kind.mlp) not in _PORTED:
        raise NotImplementedError(f"the port has no {kind} block yet")


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree (views of every leaf)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def stack_init(cfg: ModelConfig, kind: BlockKind, n_layers: int,
               generator: torch.Generator, device) -> dict:
    """Random fp32 params of ``n_layers`` blocks, stacked: fan-in scaled
    truncated normals for the projections, unit norm scales."""
    _check(kind)
    d, ff, n = cfg.d_model, cfg.d_ff, n_layers

    def proj(d_in, d_out):
        t = torch.empty((n, d_in, d_out), device=device)
        return truncated_normal_(t, generator, d_in ** -0.5)

    def ones(*shape):
        return torch.ones((n, *shape), device=device)

    p: dict = {"norm1": {"scale": ones(d)}}
    if kind.mixer == "gqa":
        p["attn"] = {
            "wq": proj(d, cfg.q_dim),
            "wk": proj(d, cfg.kv_dim),
            "wv": proj(d, cfg.kv_dim),
            "wo": proj(cfg.q_dim, d),
        }
        if cfg.use_qk_norm:  # Qwen3: RMSNorm of each q and k head
            p["attn"]["q_norm"] = {"scale": ones(cfg.head_dim)}
            p["attn"]["k_norm"] = {"scale": ones(cfg.head_dim)}
    else:
        p["mamba"] = mamba_mod.mamba_init(cfg, n, generator, device)
    if kind.mlp == "dense":
        p["norm2"] = {"scale": ones(d)}
        p["mlp"] = {
            "w_gate": proj(d, ff),
            "w_up": proj(d, ff),
            "w_down": proj(ff, d),
        }
    return p


def init_block_cache(batch: int, capacity: int, cfg: ModelConfig,
                     kind: BlockKind, dtype, device) -> dict:
    """Decode-time cache of one block: a KV ring for attention, the fp32
    conv window and SSM state for Mamba2."""
    _check(kind)
    if kind.mixer == "gqa":
        return {"self": attn_mod.init_kv_cache(
            batch, capacity, cfg.num_kv_heads, cfg.head_dim, dtype, device)}
    return {"self": mamba_mod.init_ssm_state(batch, cfg, device)}


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
    """One pre-norm residual block: the mixer (attention or Mamba2), then
    the MLP if the block has one.  ``cache`` (this layer's view) is updated
    in place."""
    _check(kind)
    hn = norm_apply(cfg.norm_type, params["norm1"], h)
    kernels = use_kernels and cache is not None
    if kind.mixer == "gqa":
        y, _ = attn_mod.attn_apply(
            params["attn"], hn, cfg, positions,
            cache["self"] if cache else None, rows=rows, use_kernels=kernels,
        )
    else:
        y, _ = mamba_mod.mamba_apply(
            params["mamba"], hn, cfg, cache["self"] if cache else None,
            rows=rows if cache else None, use_kernels=kernels,
        )
    h = h + y
    if kind.mlp == "dense":
        hn = norm_apply(cfg.norm_type, params["norm2"], h)
        h = h + mlp_apply(params["mlp"], hn, cfg.mlp_type)
    return h


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
