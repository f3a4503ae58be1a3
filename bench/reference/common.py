"""Plain PyTorch pieces of the references: fp32 math, TF32 off, and no
code, weights or tables of the program.

A :class:`Precision` does every weight product.  ``fp32`` is the
reference itself.  ``fp8`` is the control: both operands of every weight
product are rounded to float8 e4m3 (the weight with one scale per matrix,
the activations with one scale per row, each scale mapping the largest
magnitude to 448) and multiplied in fp32.  That is the step below the
bf16 the configurations serve in."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
RMS_EPS = 1e-6  # the port's rmsnorm epsilon (Phi-3's published one is 1e-5)
_Q_BLOCK = 1024  # query rows per score block in attention


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    @staticmethod
    def _fp8(t: torch.Tensor, dims) -> torch.Tensor:
        scale = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for activations x (..., d_in) and a weight (d_in, d_out)."""
        if self.name == "fp8":
            x, w = self._fp8(x, -1), self._fp8(w, (-2, -1))
        return torch.matmul(x, w)


def no_tf32():
    """Turn TF32 off for the reference's fp32 products; returns a restore
    function."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return restore


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + RMS_EPS) * scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (T, heads, D) at ``positions`` (T,), rotating
    the two halves of each head (the HF ``rotate_half`` form)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = (positions.double()[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of one sequence, rows in position order: q (T, H,
    D), k and v (T, Kh, D) -> (T, H * D)."""
    t, h, d = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    out = []
    for i in range(0, t, _Q_BLOCK):
        s = torch.einsum("qhd,khd->hqk", q[i:i + _Q_BLOCK], k) / math.sqrt(d)
        rows = torch.arange(i, min(i + _Q_BLOCK, t), device=q.device)
        s = s.masked_fill(rows[None, :, None] < torch.arange(t, device=q.device), -math.inf)
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v))
    return torch.cat(out).reshape(t, h * d)


def gqa_block(p: dict, h: torch.Tensor, positions: torch.Tensor, m: dict,
              prec: Precision) -> torch.Tensor:
    """A pre-norm attention block then a SwiGLU MLP block, over one
    sequence h (T, d) at ``positions``."""
    hd = m["head_dim"]
    x = rmsnorm(h, p["norm1"]["scale"])
    q = prec.mm(x, p["attn"]["wq"]).unflatten(-1, (-1, hd))
    k = prec.mm(x, p["attn"]["wk"]).unflatten(-1, (-1, hd))
    v = prec.mm(x, p["attn"]["wv"]).unflatten(-1, (-1, hd))
    q, k = rope(q, positions, m["rope_theta"]), rope(k, positions, m["rope_theta"])
    h = h + prec.mm(attention(q, k, v), p["attn"]["wo"])
    x = rmsnorm(h, p["norm2"]["scale"])
    mlp = p["mlp"]
    return h + prec.mm(silu(prec.mm(x, mlp["w_gate"])) * prec.mm(x, mlp["w_up"]),
                       mlp["w_down"])


def logits(w: dict, h: torch.Tensor, scale: torch.Tensor, m: dict,
           prec: Precision) -> torch.Tensor:
    """A head: its RMSNorm, then the LM head; pad lanes at -1e30."""
    out = prec.mm(rmsnorm(h, scale), w["lm_head"])
    if out.shape[-1] != m["vocab_size"]:
        out[..., m["vocab_size"]:] = NEG_INF
    return out


def normalized_entropy(lg: torch.Tensor) -> torch.Tensor:
    """H(softmax) / log(width), the width counting pad lanes."""
    logp = torch.log_softmax(lg, dim=-1)
    return -(logp.exp() * logp).sum(-1) / math.log(lg.shape[-1])


def layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
