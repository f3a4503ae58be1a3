"""Plain fp32 reference of the dense GQA BranchyModel served in two
tiers (Phi-3-mini): embedding, pre-norm blocks of RoPE attention and a
SwiGLU MLP, tied-head side branches (each its own RMSNorm, then the LM
head) and the final head.

Two-tier semantics, as the port's tier runtime defines them
(``serving/tiers.py``): every position runs the edge layers [0, split); a
decode position whose row exited at an edge branch runs no cloud layer,
so it writes no cloud-layer K/V and later positions never see it there.
The cloud layers therefore run over the subsequence of positions that
reached them (the whole prompt and the decode positions that did not
exit), at their own positions."""

from __future__ import annotations

import torch

from bench.reference.common import Precision, gqa_block, layer


def run(w: dict, m: dict, split: int, tokens: torch.Tensor, keep: torch.Tensor,
        branches: tuple[int, ...], prec: Precision):
    """One sequence: ``tokens`` (T,) at positions 0..T-1, ``keep`` (T,)
    bool, the positions that ran the cloud layers.  Returns ({branch:
    hidden (T, d) after that layer}, the cloud's output hidden at the kept
    positions (Tc, d), their positions (Tc,))."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    h = w["embed"][tokens.long()]
    collected = {}
    for i in range(split):
        h = gqa_block(layer(w["blocks"], i), h, pos, m, prec)
        if i + 1 in branches:
            collected[i + 1] = h
    kept = pos[keep]
    hc = h[keep]
    for i in range(split, m["num_layers"]):
        hc = gqa_block(layer(w["blocks"], i), hc, kept, m, prec)
    return collected, hc, kept
