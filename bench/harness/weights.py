"""Seeded random weights in the layout the port's model reads.

The benchmark makes the weights itself and hands the same values to the
program (in bf16, as the configuration serves them) and to the plain
reference (upcast to fp32).  Each stacked leaf is one draw on the device
from one ``torch.Generator`` seeded by ``--seed``, in a fixed order, so a
second call with the same seed gives the same values bit for bit.

Distributions: projections N(0, 1) clipped to [-2, 2] times 1/sqrt(fan-in);
embedding and LM head N(0, 0.02^2); norm scales 1; for Mamba2, A
log-uniform on [1, 16), dt log-uniform on [1e-3, 1e-1] (stored as the
inverse softplus, ``dt_bias``), conv weights 0.1 N(0, 1), conv bias 0,
D = 1.
"""

from __future__ import annotations

import math

import torch


def _dims(m: dict) -> dict:
    inner = m["ssm_expand"] * m["d_model"]
    h = m["ssm_num_heads"] or inner // m["ssm_head_dim"]
    n, g = m["ssm_state_dim"], m["ssm_num_groups"]
    return dict(inner=inner, h=h, p=inner // h, n=n, g=g, conv_dim=inner + 2 * g * n)


def leaves(m: dict):
    """(path, shape, kind, arg) of every leaf, in draw order.  ``m`` is the
    configuration file's ``model`` object."""
    d, v, ff = m["d_model"], m["vocab_size"], m["d_ff"]
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    if v % 256 and v % 16:
        v = (v + 255) // 256 * 256  # padded rows, as the port pads them
    out = [(("embed",), (v, d), "normal", 0.02)]

    def attn_block(prefix, lead):
        return [
            (prefix + ("norm1", "scale"), (*lead, d), "ones", None),
            (prefix + ("attn", "wq"), (*lead, d, q), "proj", d),
            (prefix + ("attn", "wk"), (*lead, d, kv), "proj", d),
            (prefix + ("attn", "wv"), (*lead, d, kv), "proj", d),
            (prefix + ("attn", "wo"), (*lead, q, d), "proj", q),
            (prefix + ("norm2", "scale"), (*lead, d), "ones", None),
            (prefix + ("mlp", "w_gate"), (*lead, d, ff), "proj", d),
            (prefix + ("mlp", "w_up"), (*lead, d, ff), "proj", d),
            (prefix + ("mlp", "w_down"), (*lead, ff, d), "proj", ff),
        ]

    n_layers = m["num_layers"]
    if m["arch_type"] == "dense":
        out += attn_block(("blocks",), (n_layers,))
    elif m["arch_type"] == "hybrid":
        s = _dims(m)
        lead, mb = (n_layers,), ("blocks", "mamba")
        out += [
            (("blocks", "norm1", "scale"), (n_layers, d), "ones", None),
            (mb + ("w_z",), (*lead, d, s["inner"]), "proj", d),
            (mb + ("w_xbc",), (*lead, d, s["conv_dim"]), "proj", d),
            (mb + ("w_dt",), (*lead, d, s["h"]), "proj", d),
            (mb + ("conv_w",), (*lead, m["ssm_conv_width"], s["conv_dim"]), "normal", 0.1),
            (mb + ("conv_b",), (*lead, s["conv_dim"]), "zeros", None),
            (mb + ("A_log",), (*lead, s["h"]), "a_log", None),
            (mb + ("D",), (*lead, s["h"]), "ones", None),
            (mb + ("dt_bias",), (*lead, s["h"]), "dt_bias", None),
            (mb + ("norm_scale",), (*lead, s["inner"]), "ones", None),
            (mb + ("out_proj",), (*lead, s["inner"], d), "proj", s["inner"]),
        ]
        out += attn_block(("shared_attn",), ())
    else:
        raise ValueError(f"no weights for arch_type {m['arch_type']!r}")
    out += [(("final_norm", "scale"), (d,), "ones", None),
            (("lm_head",), (d, v), "normal", 0.02),
            (("branches", "scale"), (len(m["branch_layers"]), d), "ones", None)]
    return out


def _draw(kind, arg, shape, gen, device) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(shape, device=device)
    if kind == "zeros":
        return torch.zeros(shape, device=device)
    if kind in ("a_log", "dt_bias"):
        lo, hi = (1.0, 16.0) if kind == "a_log" else (1e-3, 1e-1)
        t = torch.empty(shape, device=device).uniform_(
            math.log(lo), math.log(hi), generator=gen).exp_()
        return t.log_() if kind == "a_log" else torch.log(torch.expm1(t))
    t = torch.randn(shape, generator=gen, device=device)
    if kind == "proj":
        return t.clamp_(-2.0, 2.0).mul_(arg ** -0.5)
    return t.mul_(arg)


def make(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights tree drawn from ``seed`` on ``device``, each leaf as
    ``dtype`` (drawn in fp32 and rounded to bf16 first, so an fp32 tree
    holds the bf16 values the program serves)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    tree: dict = {}
    for path, shape, kind, arg in leaves(model):
        t = _draw(kind, arg, shape, gen, device).to(torch.bfloat16).to(dtype)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree
