"""Block assembly and layer-stack execution — counterpart of
``repro.models.transformer`` for ``BlockKind("gqa", "dense")`` (the dense
and vlm trunks and Zamba2's shared attention block), ``BlockKind("gqa",
"moe")`` (the routed-expert trunk of Qwen3-30B-A3B), ``BlockKind("mla",
"dense")`` and ``BlockKind("mla", "moe")`` (DeepSeek-V3's two stacks) and
``BlockKind("mamba", "none")`` (the Mamba2 trunk), and Whisper's two
GQA kinds: its decoder block (``cross_attention=True``: self-attention,
then cross-attention over the encoder frames, then a GELU MLP) and its
encoder block (``causal=False``).  Both run without RoPE.

Parameters keep the reference's stacked layout: every leaf of a stack
carries a leading ``(n_layers,)`` axis.  A Python loop over the layers
takes the place of ``lax.scan``.  A forward unbinds each stacked leaf once
(:func:`unstack`) and each layer reads its views; each layer's cache is a
view of the stacked caches (:func:`layer_slice`), so cache writes land in
place.  ``remat`` is the reference's ``jax.checkpoint`` around each layer:
``torch.utils.checkpoint`` per block when gradients are on.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import mlp_apply, norm_apply, norm_init, truncated_normal_
from repro_torch.sharding.ctx import constrain

__all__ = [
    "BlockKind",
    "block_apply",
    "cast_tree",
    "init_block_cache",
    "layer_slice",
    "run_stack",
    "recomputed",
    "stack_init",
    "unstack",
]

#: (mixer, mlp, cross_attention, causal) of every block kind the port runs.
_PORTED = {("gqa", "dense", False, True), ("gqa", "moe", False, True),
           ("mla", "dense", False, True), ("mla", "moe", False, True),
           ("mamba", "none", False, True),
           ("gqa", "dense", True, True),  # Whisper's decoder
           ("gqa", "dense", False, False)}  # Whisper's encoder


@dataclasses.dataclass(frozen=True)
class BlockKind:
    mixer: str  # "gqa" | "mla" | "mamba"
    mlp: str  # "dense" | "moe" | "none"
    cross_attention: bool = False  # Whisper's decoder
    causal: bool = True  # False for encoder blocks: no sliding window
    use_rope: bool = True


def _check(kind: BlockKind) -> None:
    """Every block kind of the reference's configs is ported; no config
    makes any other."""
    if (kind.mixer, kind.mlp, kind.cross_attention, kind.causal) not in _PORTED:
        raise ValueError(f"no config has a {kind} block")


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree (views of every leaf)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, lo: int, hi: int) -> dict:
    """Layers ``[lo, hi)`` of a stacked tree, keyed by layer index, each
    leaf a view.  One ``torch.unbind`` per leaf: under autograd its
    backward stacks the layers' gradients into one buffer, where indexing
    each layer (:func:`layer_slice`) adds a zero-filled gradient the size
    of the whole stack per layer.  Only the layers asked for are unbound
    (a whole stack is unbound as it is: no slice adds a copy to its
    backward)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, lo, hi) for k, v in tree.items()}
        return {i: {k: p[i] for k, p in parts.items()} for i in range(lo, hi)}
    part = tree if (lo, hi) == (0, tree.shape[0]) else tree[lo:hi]
    return dict(zip(range(lo, hi), torch.unbind(part)))


def recomputed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of saved (the reference's ``jax.checkpoint``); a plain call
    when gradients are off."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def cast_tree(tree, dtype: torch.dtype):
    """Every leaf of a params tree (or one tensor) as ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def stack_init(cfg: ModelConfig, kind: BlockKind, n_layers: int,
               generator: torch.Generator, device,
               dtype: torch.dtype = torch.float32) -> dict:
    """Random params of ``n_layers`` blocks, stacked, in ``dtype``:
    fan-in scaled truncated normals for the projections, unit norm scales.
    Each leaf is drawn in fp32 and cast as soon as it is drawn, so the
    draw of one leaf is the fp32 transient (the MoE experts: one layer's
    leaf, :func:`repro_torch.models.moe.moe_init`)."""
    _check(kind)
    d, ff, n = cfg.d_model, cfg.d_ff, n_layers

    def proj(d_in, d_out):
        t = torch.empty((n, d_in, d_out), device=device)
        return truncated_normal_(t, generator, d_in ** -0.5).to(dtype)

    def ones(*shape):
        return torch.ones((n, *shape), dtype=dtype, device=device)

    def norm():
        return cast_tree(norm_init(cfg.norm_type, d, device, (n,)), dtype)

    def attn():
        a = {
            "wq": proj(d, cfg.q_dim),
            "wk": proj(d, cfg.kv_dim),
            "wv": proj(d, cfg.kv_dim),
            "wo": proj(cfg.q_dim, d),
        }
        if cfg.use_qk_norm:  # Qwen3: RMSNorm of each q and k head
            a["q_norm"] = {"scale": ones(cfg.head_dim)}
            a["k_norm"] = {"scale": ones(cfg.head_dim)}
        return a

    p: dict = {"norm1": norm()}
    if kind.mixer == "gqa":
        p["attn"] = attn()
    elif kind.mixer == "mla":
        h, hd, r_rope = cfg.num_heads, cfg.head_dim, cfg.mla_rope_dim
        r_q, r_kv = cfg.mla_q_rank, cfg.mla_kv_rank
        p["attn"] = {
            "wq_a": proj(d, r_q),
            "q_norm": {"scale": ones(r_q)},
            "wq_b": proj(r_q, h * (hd + r_rope)),
            "wkv_a": proj(d, r_kv + r_rope),
            "kv_norm": {"scale": ones(r_kv)},
            "wk_b": proj(r_kv, h * hd),  # latent -> per-head key
            "wv_b": proj(r_kv, h * hd),  # latent -> per-head value
            "wo": proj(h * hd, d),
        }
    else:
        p["mamba"] = cast_tree(mamba_mod.mamba_init(cfg, n, generator, device), dtype)
    if kind.cross_attention:
        p["norm_x"] = norm()
        p["xattn"] = attn()
    if kind.mlp == "dense":
        p["norm2"] = norm()
        if cfg.mlp_type == "gelu":
            p["mlp"] = {"w_up": proj(d, ff), "w_down": proj(ff, d)}
        else:
            p["mlp"] = {
                "w_gate": proj(d, ff),
                "w_up": proj(d, ff),
                "w_down": proj(ff, d),
            }
    elif kind.mlp == "moe":
        p["norm2"] = norm()
        p["moe"] = moe_mod.moe_init(cfg, n, generator, device, dtype)
    return p


def init_block_cache(batch: int, capacity: int, cfg: ModelConfig,
                     kind: BlockKind, dtype, device) -> dict:
    """Decode-time cache of one block: a KV ring for attention, a latent
    ring for MLA, the fp32 conv window and SSM state for Mamba2."""
    _check(kind)
    if kind.mixer == "gqa":
        return {"self": attn_mod.init_kv_cache(
            batch, capacity, cfg.num_kv_heads, cfg.head_dim, dtype, device)}
    if kind.mixer == "mla":
        return {"self": attn_mod.init_mla_cache(batch, capacity, cfg, dtype, device)}
    return {"self": mamba_mod.init_ssm_state(batch, cfg, device)}


def block_apply(
    params: dict,
    h: torch.Tensor,
    cfg: ModelConfig,
    kind: BlockKind,
    positions: torch.Tensor,
    cache: dict | None = None,
    *,
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    moe_dispatch: str = "einsum",
    rows=None,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One pre-norm residual block: the mixer (attention, MLA or Mamba2),
    then (a cross-attention block given this layer's encoder ``cross_kv``,
    each (B, S_enc, Kh, D)) cross-attention, then the MLP (dense or routed
    experts) if the block has one.  ``cache`` (this layer's view) is
    updated in place.  Returns (h, the router's aux loss; None for a block
    without experts).  MLA and cross-attention have no kernel (nor have
    the reference's): ``use_kernels`` leaves them as they are."""
    _check(kind)
    hn = norm_apply(cfg.norm_type, params["norm1"], h)
    kernels = use_kernels and cache is not None
    if kind.mixer == "gqa":
        y, _ = attn_mod.attn_apply(
            params["attn"], hn, cfg, positions,
            cache["self"] if cache else None, use_rope=kind.use_rope,
            window=None if kind.causal else 0, rows=rows, use_kernels=kernels,
        )
    elif kind.mixer == "mla":
        y, _ = attn_mod.mla_apply(
            params["attn"], hn, cfg, positions, cache["self"] if cache else None,
            rows=rows if cache else None,
        )
    else:
        y, _ = mamba_mod.mamba_apply(
            params["mamba"], hn, cfg, cache["self"] if cache else None,
            rows=rows if cache else None, use_kernels=kernels,
        )
    h = h + y
    if kind.cross_attention and cross_kv is not None:
        if rows is not None:
            # A compacted sub-batch: the encoder rows follow the survivors.
            # A sentinel row reads a clamped row; its output is discarded.
            r = rows.long().clamp(max=cross_kv[0].shape[0] - 1)
            cross_kv = (cross_kv[0][r], cross_kv[1][r])
        hn = norm_apply(cfg.norm_type, params["norm_x"], h)
        y, _ = attn_mod.attn_apply(params["xattn"], hn, cfg, positions,
                                   use_rope=False, window=0, kv_override=cross_kv)
        h = h + y
    aux = None
    if kind.mlp == "dense":
        hn = norm_apply(cfg.norm_type, params["norm2"], h)
        h = h + mlp_apply(params["mlp"], hn, cfg.mlp_type)
    elif kind.mlp == "moe":
        hn = norm_apply(cfg.norm_type, params["norm2"], h)
        y, aux = moe_mod.moe_apply(params["moe"], hn, cfg, dispatch=moe_dispatch)
        h = h + y
    return h, aux


def run_stack(
    layers: dict,
    h: torch.Tensor,
    cfg: ModelConfig,
    kind: BlockKind,
    positions: torch.Tensor,
    caches: dict | None = None,
    *,
    lo: int,
    hi: int,
    cross: dict | None = None,
    moe_dispatch: str = "einsum",
    rows=None,
    use_kernels: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Run layers ``[lo, hi)`` of a stack (``layers``: :func:`unstack` of
    its params, holding at least those layers) over the residual stream;
    stacked ``caches`` are updated in place.  ``cross``: each layer's
    encoder (K, V) by layer index, as ``layers`` (Whisper's decoder).
    ``remat`` (cache-free, gradients on) recomputes each block in the
    backward pass instead of saving its activations.  Returns (h, the
    summed router aux loss of the MoE blocks; 0.0 when the stack has
    none)."""
    aux = 0.0
    for i in range(lo, hi):
        ckv = cross[i] if cross is not None else None
        if remat and caches is None:
            h, a = recomputed(
                lambda p, x, *kv: block_apply(p, x, cfg, kind, positions,
                                              cross_kv=kv or None,
                                              moe_dispatch=moe_dispatch),
                layers[i], h, *(ckv or ()))
            if cfg.seq_shard_activations:
                # The recomputed layer's carry is sequence-sharded over the
                # model axis (sequence parallelism).
                h = constrain(h, "bv.")
        else:
            h, a = block_apply(
                layers[i], h, cfg, kind, positions,
                layer_slice(caches, i) if caches is not None else None,
                cross_kv=ckv, moe_dispatch=moe_dispatch, rows=rows,
                use_kernels=use_kernels,
            )
        if a is not None:
            aux = aux + a
    return h, aux
