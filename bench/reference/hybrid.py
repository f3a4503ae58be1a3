"""Plain fp32 reference of the Zamba2 hybrid BranchyModel served in two
tiers: Mamba2 (SSD) blocks, one shared attention block (RoPE GQA and a
SwiGLU MLP, one set of weights) after every ``attn_every``-th layer, and
the tied-head side branches and final head of :mod:`bench.reference.dense`.

Mamba2 mixer: in-projections to z, xBC and dt; a causal depthwise conv of
width W over xBC from a zero window, then SiLU; dt = softplus(dt_raw +
dt_bias), A = -exp(A_log); the recurrence h_t = exp(dt_t A) h_{t-1} +
(dt_t x_t) B_t^T from a zero state, y_t = h_t C_t + D x_t; y = RMSNorm(y *
SiLU(z)) times its scale; the out-projection.  The recurrence is computed
chunk by chunk in its quadratic (SSD) form, which is the same sum.

Two tiers: as in :mod:`bench.reference.dense`.  A position that exited at
an edge branch skips every cloud layer, so the cloud's conv windows and
states, and its shared-block sites' K/V, see only the positions that
reached them: the cloud runs over that subsequence."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import Precision, gqa_block, layer, rmsnorm, silu


def _ssd(x, a, b, c, chunk: int):
    """x (T, H, P) dt-scaled, a (T, H) = dt A, b and c (T, H, N): y (T, H, P)
    of the recurrence from a zero state."""
    t, h, p = x.shape
    n = b.shape[-1]
    state = x.new_zeros(h, p, n)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ys = []
    for i in range(0, t, chunk):
        xc, ac, bc, cc = x[i:i + chunk], a[i:i + chunk], b[i:i + chunk], c[i:i + chunk]
        L = xc.shape[0]
        cum = ac.cumsum(0)  # (L, H)
        seg = (cum[:, None, :] - cum[None, :, :]).masked_fill(~tri[:L, :L, None], -float("inf"))
        y = torch.einsum("ihn,jhn,ijh,jhp->ihp", cc, bc, seg.exp(), xc)
        y = y + torch.einsum("ihn,hpn->ihp", cc, state) * cum.exp()[:, :, None]
        decay = (cum[-1:] - cum).exp()  # (L, H)
        state = state * cum[-1].exp()[:, None, None] + torch.einsum(
            "jhn,jh,jhp->hpn", bc, decay, xc)
        ys.append(y)
    return torch.cat(ys)


def mamba(p: dict, x: torch.Tensor, m: dict, prec: Precision) -> torch.Tensor:
    """The Mamba2 mixer over one sequence x (T, d)."""
    inner = m["ssm_expand"] * m["d_model"]
    h = m["ssm_num_heads"] or inner // m["ssm_head_dim"]
    hp, n, g, w = inner // h, m["ssm_state_dim"], m["ssm_num_groups"], m["ssm_conv_width"]
    z = prec.mm(x, p["w_z"])
    xbc = prec.mm(x, p["w_xbc"])
    dt_raw = prec.mm(x, p["w_dt"])
    t = x.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    conv = sum(pad[i:i + t] * p["conv_w"][i] for i in range(w)) + p["conv_b"]
    act = silu(conv)
    xs = act[:, :inner].reshape(t, h, hp)
    b = act[:, inner:inner + g * n].reshape(t, g, n).repeat_interleave(h // g, dim=1)
    c = act[:, inner + g * n:].reshape(t, g, n).repeat_interleave(h // g, dim=1)
    dt = F.softplus(dt_raw + p["dt_bias"])
    y = _ssd(xs * dt[..., None], dt * -p["A_log"].exp(), b, c, m["ssm_chunk"])
    y = (y + xs * p["D"][:, None]).reshape(t, inner)
    return prec.mm(rmsnorm(y * silu(z), p["norm_scale"]), p["out_proj"])


def _layers(w, m, h, pos, lo, hi, branches, prec, collected=None):
    every = m["attn_every"]
    for i in range(lo, hi):
        p = layer(w["blocks"], i)
        h = h + mamba(p["mamba"], rmsnorm(h, p["norm1"]["scale"]), m, prec)
        if every and (i + 1) % every == 0:
            h = gqa_block(w["shared_attn"], h, pos, m, prec)
        if collected is not None and i + 1 in branches:
            collected[i + 1] = h
    return h


def run(w: dict, m: dict, split: int, tokens: torch.Tensor, keep: torch.Tensor,
        branches: tuple[int, ...], prec: Precision):
    """As :func:`bench.reference.dense.run`."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    collected: dict = {}
    h = _layers(w, m, w["embed"][tokens.long()], pos, 0, split, branches, prec,
                collected)
    kept = pos[keep]
    hc = _layers(w, m, h[keep], kept, split, m["num_layers"], branches, prec)
    return collected, hc, kept
