"""What decides ``correct``: the served tokens and exit decisions of a
sample of the window's finished requests, against the plain fp32
reference run over each prompt and its served tokens.

Sample: drawn from ``--seed`` among the requests that finished in the
window, the longest always in it, until it holds ``min_tokens`` served
tokens.  Each request's first decode input (the argmax of its admission's
last-position logits, which the scheduler keeps on the device) is judged
with them.

Per served token the reference reads the program's exit decision
(exited at the edge or not), which also sets the positions that run the
cloud layers, and computes every edge branch's normalized entropy H_b and
logits and, at the positions that reached the cloud, the final head's.

  * ``exit_margin``: how far the reference's entropies must move for the
    program's decision to be the one the threshold t makes.  Exit at the
    edge: the least, over the edge branches b, of max((H_b - t)+, max over
    the branches before b of (t - H_b')+).  No exit: the largest (t -
    H_b)+.  The largest over the sample.
  * ``exit_flip_share``: the share of the sample's decode positions whose
    decision needs a margin above 0, that is, that the reference's
    entropies would decide the other way.
  * ``token_gap``: the reference's largest logit minus its logit of the
    served token, under the head that served it: the final head, or for an
    exit at the edge (the program does not report at which branch) the
    edge branch under which the gap is least.  The largest over the
    sample.

The control (``control=True``, run by ``bench/control.py`` and never by a
benchmark run) is the same reference computed with float8 products
(:class:`bench.reference.common.Precision`) over the same prompts and
tokens: at each position it decides the exit by its own entropies and
takes its own first token there, and those are judged as above
(``control_exit_margin``, ``control_exit_flip_share``,
``control_token_gap``).  Where it stays where
the program exited, the cloud did not run the position, so only its
margin is read there.
"""

from __future__ import annotations

import numpy as np

from bench.harness import weights
from bench.reference import common, dense, hybrid

REFERENCES = {"dense": dense.run, "hybrid": hybrid.run}


def sample(finished: list, sched, seed: int, min_tokens: int) -> list:
    if not finished:
        return []
    longest = max(finished, key=lambda r: len(sched.results[r].tokens))
    rest = [r for r in finished if r != longest]
    order = np.random.default_rng((int(seed) % 2 ** 63, 1)).permutation(len(rest))
    out, n = [longest], len(sched.results[longest].tokens)
    for i in order:
        if n >= min_tokens:
            break
        out.append(rest[i])
        n += len(sched.results[rest[i]].tokens)
    return out


def gather(sched, rids: list, prompts: dict, tok0: dict) -> list[dict]:
    """Host copies of what the reference needs: prompt, first decode
    input, served tokens, and which of them exited at the edge."""
    out = []
    for rid in rids:
        res = sched.results[rid]
        t0, i = tok0[rid]
        out.append({
            "prompt": prompts[rid],
            "tok0": int(t0[i].item()),
            "served": list(res.tokens),
            "edge": [t == 0 for t in res.exit_tiers],
        })
    return out


def edge_branches(m: dict, split: int) -> tuple[int, ...]:
    return tuple(b for b in m["branch_layers"] if b < split)


def _margins(h, thr, exit_edge):
    """The margin of each position's decision (see the module doc).
    ``h`` (K, n) entropies, ``exit_edge`` (n,) bool."""
    import torch

    above = (h - thr).clamp(min=0)  # what an exit at b must lose
    below = (thr - h).clamp(min=0)  # what staying at b must gain
    k = h.shape[0]
    need = torch.stack([
        torch.maximum(above[i], below[:i].amax(0) if i else torch.zeros_like(above[i]))
        for i in range(k)])
    return torch.where(exit_edge, need.amin(0), below.amax(0))


def _gap(lg, tok):
    """Largest logit minus the logit of ``tok``, row by row."""
    return lg.amax(-1) - lg.gather(-1, tok[:, None])[:, 0]


def _judge_one(w, m, split, s, prec, ref_out=None):
    """(readings of the served sequence, or of the control's choices when
    ``ref_out`` holds the fp32 reference's outputs) for one request."""
    import torch

    dev = w["embed"].device
    prompt = torch.as_tensor(np.asarray(s["prompt"], np.int64), device=dev)
    served = torch.as_tensor(s["served"], dtype=torch.long, device=dev)
    n, p = served.shape[0], prompt.shape[0]
    tokens = torch.cat([prompt, torch.tensor([s["tok0"]], device=dev), served[:-1]])
    edge = torch.as_tensor(s["edge"], dtype=torch.bool, device=dev)
    keep = torch.ones(p + n, dtype=torch.bool, device=dev)
    keep[p:] = ~edge
    branches = edge_branches(m, split)
    collected, hc, kept = REFERENCES[m["arch_type"]](w, m, split, tokens, keep, branches, prec)
    row = torch.full((p + n,), -1, dtype=torch.long, device=dev)
    row[kept] = torch.arange(kept.shape[0], device=dev)
    br = {b: common.logits(w, collected[b][p:], w["branches"]["scale"][m["branch_layers"].index(b)],
                           m, prec) for b in branches}
    ent = torch.stack([common.normalized_entropy(br[b]) for b in branches])
    final_rows = row[torch.cat([torch.tensor([p - 1], device=dev), p + torch.arange(n, device=dev)])]
    at = final_rows >= 0
    final = common.logits(w, hc[final_rows[at]], w["final_norm"]["scale"], m, prec)
    out = {"br": br, "ent": ent, "final": final, "at": at}
    thr = float(m["exit_threshold"])
    if ref_out is None:
        margin = _margins(ent, thr, edge)
        gaps = [_gap(final[:1], torch.tensor([s["tok0"]], device=dev))]
        # The program reports an exit at the edge, not at which branch: the
        # token is judged under the branch that serves it best.
        exit_gap = torch.stack([_gap(br[b], served) for b in branches]).amin(0)
        head_gap = torch.zeros(n, device=dev)
        head_gap[at[1:]] = _gap(final[1:], served[at[1:]])
        gaps.append(torch.where(edge, exit_gap, head_gap))
        return out, {"exit_margin": float(margin.max()) if n else 0.0,
                     "exit_flips": int((margin > 0).sum()), "decisions": n,
                     "token_gap": float(torch.cat(gaps).max())}
    # The control: its own exits and first tokens, judged by the reference.
    ref = ref_out
    c_exit_at = torch.full((n,), -1, dtype=torch.long, device=dev)
    for i in reversed(range(len(branches))):
        c_exit_at = torch.where(ent[i] < thr, i, c_exit_at)
    c_edge = c_exit_at >= 0
    margin = _margins(ref["ent"], thr, c_edge)
    gaps = [_gap(ref["final"][:1], final[:1].argmax(-1))]
    idx = torch.arange(n, device=dev)
    for i, b in enumerate(branches):
        sel = c_exit_at == i
        gaps.append(_gap(ref["br"][b][idx[sel]], br[b][idx[sel]].argmax(-1)))
    stay = ~c_edge & at[1:]
    pos_in_final = torch.cumsum(at[1:].long(), 0)  # row of position k in final[1:]
    sel = pos_in_final[stay] - 1
    gaps.append(_gap(ref["final"][1:][sel], final[1:][sel].argmax(-1)))
    return out, {"control_exit_margin": float(margin.max()) if n else 0.0,
                 "control_exit_flips": int((margin > 0).sum()),
                 "control_token_gap": float(torch.cat(gaps).max())}


def compare(readings: dict, limits: dict, prefix: str = "") -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether every one is
    within it.  ``prefix="control_"`` holds the control's readings to the
    same limits."""
    numbers = {k: {"value": readings[prefix + k], "limit": lim} for k, lim in limits.items()}
    return numbers, all(v["value"] <= v["limit"] for v in numbers.values())


def judge(m: dict, split: int, seed: int, seqs: list, device, *, control: bool = False
          ) -> dict:
    """The readings over the sample (see the module doc).  Runs
    after the program's state is freed; the weights are drawn again from
    the seed and upcast to fp32."""
    import torch

    restore = common.no_tf32()
    try:
        with torch.no_grad():
            w = weights.make(m, seed, device, dtype=torch.float32)
            got = []
            for s in seqs:
                ref, r = _judge_one(w, m, split, s, common.Precision("fp32"))
                if control:
                    r.update(_judge_one(w, m, split, s, common.Precision("fp8"), ref)[1])
                got.append(r)
                del ref
    finally:
        restore()
    n = max(1, sum(r["decisions"] for r in got))
    readings = {k: max((r[k] for r in got), default=0.0) for k in (
        "exit_margin", "token_gap") + (("control_exit_margin", "control_token_gap")
                                        if control else ())}
    readings["exit_flip_share"] = sum(r["exit_flips"] for r in got) / n
    if control:
        readings["control_exit_flip_share"] = sum(r["control_exit_flips"] for r in got) / n
    return readings
