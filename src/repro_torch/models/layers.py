"""Primitive layers: dense, norms, RoPE, sinusoidal positions, the SwiGLU
and GELU MLPs, embeddings.

Counterparts of ``repro.models.layers``.  Functions on tensors: parameters
are kept in fp32 and cast to the compute dtype at use; norm reductions stay
in fp32.  ``dense`` and ``embed`` cast a weight only when it is not already
bf16, so a caller that holds bf16 compute copies of its fp32 weights
(:func:`repro_torch.models.model.compute_params`) gets bitwise the same
result without paying the cast at every call.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.sharding.ctx import is_dtensor, local_part

__all__ = [
    "truncated_normal_",
    "dense",
    "rmsnorm",
    "nonparametric_ln",
    "norm_apply",
    "norm_init",
    "rope_frequencies",
    "apply_rope",
    "sinusoidal_positions",
    "sinusoidal_embed",
    "silu",
    "gelu",
    "mlp_apply",
    "embed",
]


def truncated_normal_(t: torch.Tensor, generator: torch.Generator,
                      scale: float = 1.0) -> torch.Tensor:
    """In-place truncated normal on [-2, 2] times ``scale`` (the reference's
    fan-in ``dense_init`` uses ``scale = 1/sqrt(d_in)``)."""
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def dense(w: torch.Tensor, x: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ w`` in ``dtype`` (the reference's ``einsum("...i,io->...o")``
    after casting both operands).

    A sharded weight (a DTensor: a sharded tier) whose contraction dim is
    split, or an input split along it, leaves each rank a partial sum.
    Only then is the product taken in fp32, and the partial sums reduced in
    fp32 before the one rounding to ``dtype``, as one device's product
    accumulates in fp32 and rounds once; summing rounded partials would
    move every output by about an ulp.  (DTensor has no rule for a bf16
    product with an fp32 output, ``aten.mm.dtype``.)  Any other sharded
    product is the plain one in ``dtype``.  A DTensor ``x`` is folded to
    two dims with its sharded leading dim first (:func:`_dense_folded`)."""
    if is_dtensor(x) and x.dim() > 2 and w.dim() == 2:
        return _dense_folded(w, x, dtype)
    if is_dtensor(w):
        from torch.distributed.tensor import Replicate, Shard

        if not any(isinstance(p, Shard) and p.dim % w.dim() == w.dim() - 2
                   for p in w.placements):
            y = torch.matmul(x.to(dtype), w.to(dtype))
            if not any(p.is_partial() for p in y.placements):
                return y
        # DTensor may contract a split input against a replicated weight
        # too: that product is redone in fp32.
        y = torch.matmul(x.to(dtype).float(), w.to(dtype).float())
        whole = [Replicate() if p.is_partial() else p for p in y.placements]
        return y.redistribute(y.device_mesh, whole).to(dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def _dense_folded(w: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`dense` of a DTensor ``x`` of three or more dims.  A product
    folds ``x``'s leading dims into one, which DTensor (torch 2.11) can do
    only when the sharded one comes first (a (K, B, S, d) stack of branch
    states is sharded over B): that dim is moved to the front for the
    product and back after it, and a second sharded leading dim is
    gathered first."""
    from torch.distributed.tensor import Replicate, Shard

    lead = x.dim() - 1
    sharded = sorted({p.dim % x.dim() for p in x.placements
                      if isinstance(p, Shard) and p.dim % x.dim() < lead})
    if len(sharded) > 1:
        keep = sharded[0]
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim % x.dim() not in (keep, lead)
            else p for p in x.placements])
    d = sharded[0] if sharded else 0
    xm = x.movedim(d, 0)
    y = dense(w, xm.reshape(-1, xm.shape[-1]), dtype)
    return y.reshape(*xm.shape[:-1], y.shape[-1]).movedim(0, d)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def nonparametric_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias; the population
    variance (``jnp.var``), hence ``correction=0``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_init(norm_type: str, d: int, device, lead: tuple[int, ...] = ()) -> dict:
    """A norm's params, with leading axes ``lead`` (a stack): a unit scale
    for RMSNorm, nothing for the non-parametric LayerNorm."""
    if norm_type == "rmsnorm":
        return {"scale": torch.ones((*lead, d), device=device)}
    if norm_type == "nonparametric_ln":
        return {}
    raise ValueError(norm_type)


def norm_apply(norm_type: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rmsnorm(params, x)
    if norm_type == "nonparametric_ln":
        return nonparametric_ln(x)
    raise ValueError(norm_type)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding; (head_dim // 2,) fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(
    x: torch.Tensor,  # (..., seq, heads, head_dim)
    positions: torch.Tensor,  # (..., seq) absolute token positions
    theta: float,
) -> torch.Tensor:
    """Rotate the split halves (x[:D/2], x[D/2:]) — what the reference code
    does; its docstring's "pairs" is wrong.  fp32 trig, output in x.dtype."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * inv_freq  # (..., S, D/2)
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table (seq_len, d_model): computed in
    numpy float64 and cast to fp32, as the reference does (prefill and the
    encoder add it)."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d_model)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def sinusoidal_embed(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """The sinusoidal embedding at positions held on the device, (...,
    d_model) in fp32 math (decode adds it).  Not bitwise the float64 table
    of :func:`sinusoidal_positions` at the same position, in either
    package."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=positions.device)
    angle = positions.float()[..., None] / torch.pow(10_000.0, 2 * dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` op by op in x's dtype — the reference's
    ``jax.nn.silu`` lowering, which rounds after every op in bf16
    (``F.silu`` rounds once and differs in about a third of bf16 outputs)."""
    return x * (1 / (1 + torch.exp(-x)))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (numpy's ``astype`` of a constant)."""
    return float(torch.tensor(value, dtype=dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form, op by op in x's dtype with its
    constants rounded to that dtype first (``x * (0.5 * (1 + tanh(c * (x +
    k * x**3))))``, c = sqrt(2 / pi), k = 0.044715), as the reference's
    lowering rounds after every op.  Over the 65,280 finite bf16 inputs it
    equals the reference's result on all but 508, where an input or an
    output is at most 2^-126 (XLA's CPU flushes subnormals to zero) and
    the two differ by at most 2^-126; ``F.gelu(approximate="tanh")``,
    which rounds once, differs on 1,518."""
    c = _rounded(math.sqrt(2 / math.pi), x.dtype)
    k = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    dtype = x.dtype
    if mlp_type == "swiglu":
        g = dense(params["w_gate"], x, dtype)
        u = dense(params["w_up"], x, dtype)
        return dense(params["w_down"], silu(g) * u, dtype)
    if mlp_type == "gelu":
        u = dense(params["w_up"], x, dtype)
        return dense(params["w_down"], gelu(u), dtype)
    raise ValueError(mlp_type)


def _embed_sharded(table: torch.Tensor, tokens: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """:func:`embed` of a DTensor table (a sharded segment or train step).
    Each rank looks its tokens up in its own rows of a vocab-sharded
    table, zero for a token another rank holds, and the rows are summed
    across those ranks: one nonzero term, so the lookup is exact.  (DTensor's
    own embedding rule gives a masked partial whose mask the backward pass
    cannot take, and an index would gather the whole table.)  The table's
    other shards (its hidden dim under FSDP) are gathered; the tokens keep
    their batch shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_pl = [Replicate() if v or not isinstance(p, Shard) else p
              for v, p in zip(vocab, tokens.placements)]
    tab_pl = [Shard(0) if v else Replicate() for v in vocab]
    loc = local_part(table, tab_pl, [i for i, p in enumerate(tok_pl) if isinstance(p, Shard)])
    off, width = 0, table.shape[0]  # this rank's first vocab row
    for i, v in enumerate(vocab):
        if v:
            width //= mesh.size(i)
            off += mesh.get_local_rank(i) * width
    idx = tokens.redistribute(mesh, tok_pl).to_local() - off
    inside = (idx >= 0) & (idx < loc.shape[0])
    rows = loc.to(dtype)[idx.clamp(0, loc.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, 0)
    out = DTensor.from_local(rows, mesh, [Partial() if v else p
                                          for v, p in zip(vocab, tok_pl)],
                             run_check=False)
    return out.redistribute(mesh, tok_pl)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if is_dtensor(table):
        return _embed_sharded(table, tokens, dtype)
    return table.to(dtype)[tokens]

