"""K-tier partitioning (beyond-paper) — counterpart of
``repro.core.multitier``, numpy only.

The paper splits across two tiers (edge, cloud).  Real fleets have more:
end device -> edge server -> regional cloud -> core cloud, with a bandwidth
cliff at every hop.  The same shortest-path insight generalizes: execution
is monotone through tiers (layers only move forward), so the optimal
assignment is a monotone non-decreasing map layer->tier, i.e. a path in a
layered (layer x tier) lattice:

    state (i, k): layers 1..i done, currently on tier k
    stay:  (i, k) -> (i+1, k)   cost surv(i) * t_{i+1}^k
    hop:   (i, k) -> (i, k+1)   cost surv(i) * alpha_i / B_k
    exits: side branches scale everything downstream by (1 - p_b), exactly
           as in the 2-tier model (evaluated on whichever tier holds them).

Solved by DP over the lattice (topological order), O(N * K).
With K == 2 this reduces to the paper's problem; tests assert agreement.

Overlap (pipelined) mode.  The serial cost above is the latency of one
isolated sample: every stage waits for the previous one.  A pipelined
deployment (``overlap=True``) overlaps tier j's uplink transfer with tier
j+1's compute and double-buffers decode steps, so the *steady-state* cost
per step is the pipeline bottleneck stage

    max_j( compute_j, transfer_j )

rather than the serial sum — matching the reference's
``TierExecutor(overlap="pipelined")`` (not in the port's runtime yet).

Sharded tiers (``TierSpec.devices > 1``).  A tier that is a device *mesh*
rather than a chip computes each layer ``devices`` times faster but pays an
intra-tier collective per layer: a ring all-reduce of the layer's
activation (``alpha_i`` bytes) over the tier's ``ici_bps`` interconnect
(the field keeps the reference's name: NVLink between H100s),
``_COLLECTIVES_PER_LAYER`` times per layer.  Both the enumeration and the
lattice DP price this through :func:`_tier_layer_seconds`, so the solver
can trade "shard tier j over d chips" against "add a hop" — the
generalization arXiv 2210.12219 argues for (per-device compute and
collective/hop traffic priced jointly).
Per-stage weights (reach / bucketed padding) are identical to serial mode;
only the aggregation changes.  A bottleneck is not edge-decomposable over
the lattice, so the overlap solve enumerates monotone cut vectors directly
(K keeps the combinatorics tiny); above ``_BUCKETED_ENUM_CAP`` candidates
it falls back to the serial DP's cuts re-scored under overlap (documented
approximation).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.types import CostProfile

__all__ = [
    "TierSpec",
    "MultiTierPlan",
    "solve_multitier",
    "expected_time_multitier",
    "from_cost_profile",
    "bucket_ladder",
    "bucket_for",
]


def bucket_ladder(batch: int) -> tuple[int, ...]:
    """Sub-batch widths survivors are padded to: powers of two below
    ``batch``, plus ``batch`` itself (a no-exit step compacts through the
    identity permutation at full width)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    out = []
    b = 1
    while b < batch:
        out.append(b)
        b *= 2
    out.append(batch)
    return tuple(out)


def bucket_for(n: int, batch: int) -> int:
    """Smallest ladder bucket that fits ``n`` survivors (min 1: even an
    all-exit step keeps one padding row downstream so per-layer cache
    write indices stay in lockstep across tiers)."""
    for b in bucket_ladder(batch):
        if b >= max(int(n), 1):
            return b
    return batch


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One tier: per-layer compute times, uplink bandwidth to the NEXT
    tier (bits/s; last tier's uplink is unused), and the tier's shard
    width.

    ``devices > 1`` models a tensor/expert-parallel tier (a group of cards,
    not a chip): per-layer compute scales ``1/devices``, and every layer
    pays an intra-tier collective term — a ring all-reduce of the layer's
    activation over ``ici_bps`` (bits/s of intra-tier interconnect),
    ``_COLLECTIVES_PER_LAYER`` times per layer.  An unset/zero ``ici_bps``
    with ``devices > 1`` prices the collectives infinite (the shards
    cannot reduce), mirroring :func:`_hop_seconds`'s dead-uplink policy.
    """

    name: str
    gamma: float  # t_i at this tier = gamma * t_c (paper's convention)
    uplink_bps: float = 0.0
    devices: int = 1  # shard width (tensor/expert-parallel fan-out)
    ici_bps: float = 0.0  # intra-tier interconnect (per-device, bits/s)
    #: Uplink health: the estimated probability a transfer over this
    #: tier's uplink succeeds (the controller feeds its EWMA of observed
    #: fault events here).  A flaky hop's expected cost scales
    #: ``1/availability`` (retries until success); ``availability <= 0``
    #: — a breaker-open link — prices the hop infinite, so the solver
    #: routes the cut around a sick link exactly as it routes around a
    #: dead one.
    availability: float = 1.0


#: All-reduces a sharded trunk layer pays on its activation (attention wo
#: partial-sum + MLP w_down partial-sum under Megatron-style sharding).
_COLLECTIVES_PER_LAYER = 2.0


def _collective_seconds(devices: int, bits: float, ici_bps: float) -> float:
    """Intra-tier ring all-reduce time for one layer's activation: each
    device moves ``2 * (d-1)/d * bits`` over its ``ici_bps`` link, twice per layer
    (see ``_COLLECTIVES_PER_LAYER``).  Free at devices==1 or zero bits;
    infinite over an unset interconnect (same policy as _hop_seconds)."""
    if devices <= 1 or bits <= 0.0:
        return 0.0
    if not ici_bps or ici_bps <= 0.0:
        return math.inf
    ring = 2.0 * (devices - 1) / devices
    return _COLLECTIVES_PER_LAYER * ring * bits / ici_bps


def _tier_layer_seconds(tier: TierSpec, t_c_i: float, alpha_i: float) -> float:
    """Unweighted seconds tier ``tier`` spends on one trunk layer: the
    paper's ``gamma * t_c`` scaled by the shard width, plus the sharded
    layer's collective term on its activation ``alpha_i`` bytes."""
    d = max(int(tier.devices), 1)
    t = tier.gamma * t_c_i / d
    if d > 1:
        t += _collective_seconds(d, alpha_i * 8.0, tier.ici_bps)
    return t


@dataclasses.dataclass(frozen=True)
class MultiTierPlan:
    cut_after: tuple[int, ...]  # layer after which each hop happens (K-1,)
    expected_time_s: float
    tier_of_layer: tuple[int, ...]  # (N,) tier index per layer


def _padded_frac(reach_i: float, batch: int) -> float:
    """Fraction of the full batch a downstream tier actually computes on:
    expected survivors rounded up to the runtime's bucket ladder."""
    n = int(np.ceil(reach_i * batch - 1e-9))
    return bucket_for(n, batch) / batch


def _hop_seconds(
    bits: float, uplink_bps: float, availability: float = 1.0
) -> float:
    """Transfer seconds for ``bits`` over a hop.  A hop that ships nothing
    is free; a hop that ships over an unset/zero uplink — or one whose
    estimated ``availability`` is zero (breaker open) — is unusable
    (infinite cost), never a ZeroDivisionError.  A flaky-but-alive hop
    costs ``1/availability`` times its raw transfer (expected attempts
    until one succeeds under i.i.d. failures)."""
    if bits <= 0.0:
        return 0.0
    if not uplink_bps or uplink_bps <= 0.0:
        return math.inf
    if availability <= 0.0:
        return math.inf
    return bits / uplink_bps / min(float(availability), 1.0)


def _infeasible_error(tiers: list[TierSpec]) -> ValueError:
    """Diagnostic for a profile with no finite-cost plan, naming the first
    unreachable tier when a dead uplink is the culprit."""
    dead = next(
        (j for j in range(len(tiers) - 1)
         if not tiers[j].uplink_bps or tiers[j].uplink_bps <= 0.0
         or tiers[j].availability <= 0.0),
        None,
    )
    detail = (
        f"tier {tiers[dead + 1].name!r} is unreachable "
        f"(tier {tiers[dead].name!r} has uplink_bps="
        f"{tiers[dead].uplink_bps!r}, availability="
        f"{tiers[dead].availability!r})"
        if dead is not None
        else "check the t_c/alpha/gamma profile for infs or NaNs"
    )
    return ValueError(f"no finite-cost multi-tier plan: {detail}")


#: Above this many candidate cut vectors the bucketed/overlap solve falls
#: back to the (approximate) lattice DP instead of exact enumeration.
_BUCKETED_ENUM_CAP = 50_000


def _tier_head_layers(
    branch_layers: Sequence[int], lo: int, hi: int, j: int, k: int, n: int
) -> list[int]:
    """Branch heads tier ``j`` (running layers ``(lo, hi]``) evaluates —
    the runtime's placement (``serving.tiers.segments_for_cuts``): strict
    at a cut (a branch there is discarded), none on the final tier of a
    K>=2 stack, and the deepest branch included at the trunk end of a
    single-tier plan."""
    if j == k - 1 and k > 1:
        return []
    return [b for b in branch_layers
            if lo < b and (b <= hi if hi == n else b < hi)]


def _solve_enumerated(
    t_c, alpha, p, tiers, batch, overlap, occupancy=None,
    head_cost=None, branch_layers=None,
) -> "MultiTierPlan | None":
    """Exact solve by enumeration: argmin over monotone cut vectors of the
    closed-form fixed-cut cost (entry-frozen bucketed and/or pipelined).
    Returns None when the enumeration would exceed ``_BUCKETED_ENUM_CAP``
    (caller falls back to the DP)."""
    n = len(t_c) - 1
    k = len(tiers)
    if k == 1:
        cost = expected_time_multitier(
            t_c, alpha, p, tiers, (), batch=batch, overlap=overlap,
            occupancy=occupancy, head_cost=head_cost,
            branch_layers=branch_layers,
        )
        return MultiTierPlan((), cost, tuple([0] * n))
    if math.comb(n + k - 1, k - 1) > _BUCKETED_ENUM_CAP:
        return None
    best_cost, best_cuts = np.inf, None
    for cuts in itertools.combinations_with_replacement(range(n + 1), k - 1):
        c = expected_time_multitier(
            t_c, alpha, p, tiers, cuts, batch=batch, overlap=overlap,
            occupancy=occupancy, head_cost=head_cost,
            branch_layers=branch_layers,
        )
        if c < best_cost:
            best_cost, best_cuts = c, cuts
    if best_cuts is None:
        raise _infeasible_error(tiers)
    bounds = (0, *best_cuts, n)
    tier_of_layer: list[int] = []
    for j in range(k):
        tier_of_layer += [j] * (bounds[j + 1] - bounds[j])
    return MultiTierPlan(tuple(best_cuts), float(best_cost), tuple(tier_of_layer))


def solve_multitier(
    t_c: np.ndarray,  # (N+1,) cloud-reference per-layer times, [0] == 0
    alpha: np.ndarray,  # (N+1,) output bytes, [0] == raw input
    branch_probs: np.ndarray,  # (N+1,) conditional exit prob per layer
    tiers: list[TierSpec],
    batch: int | None = None,
    *,
    overlap: bool = False,
    occupancy: float | None = None,
    head_cost: Callable[[int], float] | None = None,
    branch_layers: Sequence[int] | None = None,
) -> MultiTierPlan:
    """``batch=None`` is the paper's ideal per-sample model: every layer's
    cost is weighted by the probability the sample still runs it.

    ``batch`` given models the *survivor-compacted batched runtime*: the
    entry tier — the first tier that runs any layer, wherever it sits —
    computes the full batch (exits inside a tier are masked, not skipped),
    and each downstream tier computes a survivor sub-batch padded to the
    bucket ladder, frozen at tier entry.  Because "which tier is entry"
    and "what bucket a tier froze" are properties of the whole cut vector,
    not of a (layer, tier) lattice state, the bucketed solve enumerates
    cut vectors directly against :func:`expected_time_multitier` — exact
    by construction, and K (fleet depth) keeps the combinatorics tiny.
    Only above ``_BUCKETED_ENUM_CAP`` candidate vectors does it fall back
    to the lattice DP with *pointwise* padded stay weights (full batch on
    tier 0), a documented approximation.  Hop transfer is always
    reach-weighted: the wire ships true survivors, padding is a
    compute-shape artifact.

    ``overlap=True`` optimizes the pipelined runtime's steady-state step
    cost (the bottleneck stage ``max_j(compute_j, transfer_j)``) instead of
    the serial sum — see the module docstring.  Like the bucketed case it
    enumerates cut vectors; above the cap the serial DP's cuts are kept and
    re-scored under overlap (a documented approximation).

    ``occupancy`` (continuous batching; requires ``batch``) scales the
    expected live width: only that fraction of the nominal batch holds a
    live request in steady state, so downstream survivor sub-batches and
    hop payloads shrink by it.  The entry tier still computes the full
    nominal batch (dead slots are masked, not skipped — exactly the
    runtime's behavior), which is what moves the optimal cut toward the
    entry tier as occupancy drops.

    ``head_cost`` (with ``branch_layers``) adds the branch-head compute
    term: a callable ``m -> cloud-reference seconds`` for evaluating ``m``
    exit heads in one step (:func:`repro_torch.core.profiler.branch_head_cost`
    builds it, batched or sequential).  The batched price couples a tier's
    heads into one stacked projection, which is not edge-decomposable over
    the lattice — so a ``head_cost`` solve always enumerates cut vectors
    (exact), falling back above ``_BUCKETED_ENUM_CAP`` to the head-less
    DP's cuts re-scored with the head term.  Without it the solver prices
    branch-heavy cuts as if heads were free — or, historically, callers
    padded ``t_c`` with K full per-head passes, over-pricing exactly the
    cuts the batched runtime makes cheap.
    """
    t_c = np.asarray(t_c, float)
    alpha = np.asarray(alpha, float)
    p = np.asarray(branch_probs, float)
    n = len(t_c) - 1
    k = len(tiers)
    assert k >= 1
    if occupancy is not None and batch is None:
        raise ValueError("occupancy models the batched runtime; pass batch=")

    if batch is not None or overlap or head_cost is not None:
        plan = _solve_enumerated(
            t_c, alpha, p, tiers, batch, overlap, occupancy,
            head_cost, branch_layers,
        )
        if plan is not None:
            return plan
    if overlap or head_cost is not None:
        # Enumeration overflowed the cap: take the serial DP's plan and
        # re-score it under the full cost.  (The batched head price
        # couples every branch a tier keeps into one stacked projection,
        # so — like the overlap bottleneck — it is not edge-decomposable
        # over the lattice; the DP solves without it, a documented
        # approximation above the cap.)
        plan = solve_multitier(t_c, alpha, p, tiers, batch)
        return dataclasses.replace(
            plan,
            expected_time_s=expected_time_multitier(
                t_c, alpha, p, tiers, plan.cut_after, batch=batch,
                overlap=overlap, occupancy=occupancy,
                head_cost=head_cost, branch_layers=branch_layers,
            ),
        )

    surv = np.cumprod(1.0 - p)  # surv[i] = alive after layer i's branch
    reach = np.concatenate([[1.0], surv[:-1]])  # alive entering layer i
    occ = 1.0 if occupancy is None else float(occupancy)

    def stay_w(i: int, j: int) -> float:
        if batch is None:
            return reach[i]
        return 1.0 if j == 0 else _padded_frac(reach[i] * occ, batch)

    # Branch semantics (paper Sec. IV-B): side branches run on every tier
    # EXCEPT the last (the cloud evaluates none), and the branch sitting
    # exactly at a cut is discarded (Fig. 2(c)).  So on tiers 0..K-2 the
    # survival bookkeeping is the global reach[] array, and the last tier's
    # whole tail is frozen at the survival of the final hop.  (For K >= 3
    # this treats a branch at an *intermediate* hop as evaluated by the
    # next branchy tier — exact whenever no branch sits exactly at a cut.)
    last = k - 1
    # dist[i][j]: layers 1..i done on branchy tiers, currently on tier j<last.
    dist = np.full((n + 1, max(last, 1)), np.inf)
    parent = np.full((n + 1, max(last, 1), 2), -1, dtype=int)
    dist[0][0] = 0.0
    for j in range(1, last):
        cand = dist[0][j - 1] + _hop_seconds(
            occ * alpha[0] * 8.0, tiers[j - 1].uplink_bps,
            tiers[j - 1].availability,
        )
        if cand < dist[0][j]:
            dist[0][j] = cand
            parent[0][j] = (0, j - 1)
    for i in range(1, n + 1):
        for j in range(last):
            cand = dist[i - 1][j] + stay_w(i, j) * _tier_layer_seconds(
                tiers[j], t_c[i], alpha[i]
            )
            if cand < dist[i][j]:
                dist[i][j] = cand
                parent[i][j] = (i - 1, j)
        for j in range(1, last):
            cand = dist[i][j - 1] + _hop_seconds(
                occ * reach[i] * alpha[i] * 8.0, tiers[j - 1].uplink_bps,
                tiers[j - 1].availability,
            )
            if cand < dist[i][j]:
                dist[i][j] = cand
                parent[i][j] = (i, j - 1)

    # Closed-form frozen tail on the last tier (no branches there); per-
    # layer seconds include the last tier's shard-width/collective terms.
    eff_last = np.array(
        [0.0]
        + [_tier_layer_seconds(tiers[last], t_c[i], alpha[i])
           for i in range(1, n + 1)]
    )
    tail = np.concatenate([np.cumsum(eff_last[::-1])[::-1][1:], [0.0]])
    best_cost, best_i, end_on_last = np.inf, n, False
    best_j_final: int | None = None
    if last >= 1:
        for j in range(last):
            if dist[n][j] < best_cost:  # finish without reaching the cloud
                best_cost, best_i, end_on_last = float(dist[n][j]), n, False
                best_j_final = j
        for i in range(0, n + 1):
            tail_w = (
                reach[i] if batch is None
                else _padded_frac(reach[i] * occ, batch)
            )
            hop = dist[i][last - 1] + (
                _hop_seconds(
                    occ * reach[i] * alpha[i] * 8.0,
                    tiers[last - 1].uplink_bps,
                    tiers[last - 1].availability,
                )
                + tail_w * tail[i]
            )
            if hop < best_cost:
                best_cost, best_i, end_on_last = float(hop), i, True
                best_j_final = last - 1
    else:  # single tier: everything runs there (full batch when bucketed)
        w1 = reach[1:] if batch is None else np.ones(n)
        eff0 = np.array(
            [_tier_layer_seconds(tiers[0], t_c[i], alpha[i])
             for i in range(1, n + 1)]
        )
        best_cost = float(np.sum(w1 * eff0))
        best_i, end_on_last, best_j_final = n, False, 0

    if best_j_final is None or not np.isfinite(best_cost):
        # Degenerate profile: no candidate assignment has finite cost (a
        # clear diagnostic instead of the historical UnboundLocalError).
        raise _infeasible_error(tiers)

    # Backtrack the branchy-tier assignment up to best_i.
    tier_of_layer = [last] * (n + 1)
    i, j = best_i, best_j_final
    while i > 0 or j > 0:
        pi, pj = parent[i][j]
        if pi < 0:
            break
        if pi == i - 1 and pj == j:
            tier_of_layer[i] = j
        i, j = int(pi), int(pj)
    cuts = []
    for j in range(1, k):
        after = max([i for i in range(1, n + 1) if tier_of_layer[i] < j],
                    default=0)
        cuts.append(after)
    return MultiTierPlan(
        cut_after=tuple(cuts),
        expected_time_s=best_cost,
        tier_of_layer=tuple(tier_of_layer[1:]),
    )


def expected_time_multitier(
    t_c: np.ndarray,
    alpha: np.ndarray,
    branch_probs: np.ndarray,
    tiers: list[TierSpec],
    cuts: tuple[int, ...],
    batch: int | None = None,
    *,
    overlap: bool = False,
    occupancy: float | None = None,
    head_cost: Callable[[int], float] | None = None,
    branch_layers: Sequence[int] | None = None,
) -> float:
    """Closed-form E[T] of one *fixed* monotone cut vector (the plan the
    runtime executes), same semantics as :func:`solve_multitier`: branches
    run on tiers 0..K-2 (reach-weighted), the last tier's tail is frozen at
    the wire survival, and a hop is charged iff layers still run after it.

    ``batch`` given switches to the survivor-compacted runtime's cost: the
    entry tier computes the full batch, and every later tier computes the
    bucket its entering survivors were padded to — *frozen at tier entry*
    (the runtime recompacts only at hops), so this is exact for the
    executed plan, padding waste included.  Transfers stay reach-weighted.

    ``overlap=True`` returns the pipelined runtime's steady-state step
    cost: the bottleneck stage ``max_j(compute_j, transfer_j)`` over the
    2K-1 pipeline stages (K tier computes interleaved with K-1 hop
    transfers) instead of their serial sum.  Per-stage weights are
    unchanged.  This models the real multi-host deployment where tiers
    compute concurrently; the single-host simulator serializes tier
    computes, so it matches this cost only when transfers dominate (see
    the ``serving.tiers`` module docstring).

    ``occupancy`` (requires ``batch``): the continuous-batching scheduler
    keeps only this fraction of the nominal batch live in steady state.
    The entry tier still computes the full nominal batch (dead slots are
    masked in place, exactly like intra-tier exits), while downstream
    survivor sub-batches — and every hop's payload — scale with the
    *live* width ``occupancy * batch`` before bucket padding.  This is
    the occupancy-weighted expected-batch term ``est_latency_s`` and the
    reference's ``RepartitionController`` price.

    ``head_cost`` (``m -> cloud-reference seconds`` for one step's ``m``
    exit heads; see :func:`repro_torch.core.profiler.branch_head_cost`) adds a
    branch-head compute term per tier.  ``branch_layers`` names the branch
    positions (default: layers with nonzero ``branch_probs``); each tier's
    evaluated heads follow the runtime's placement (strict at a cut, none
    on the final tier of a K>=2 stack).  The tier's ``m`` heads are priced
    as ONE joint evaluation — ``head_cost(m)`` scaled by the tier's
    ``gamma / devices`` — weighted like its layer compute (bucketed
    sub-batch fraction; under ``batch=None`` each head is charged its
    reach times the amortized per-head share ``head_cost(m) / m``, which
    for a sequential-price callable degenerates to exactly the historical
    per-head charge).
    """
    t_c = np.asarray(t_c, float)
    alpha = np.asarray(alpha, float)
    p = np.asarray(branch_probs, float)
    n = len(t_c) - 1
    k = len(tiers)
    if len(cuts) != k - 1:
        raise ValueError(f"need {k - 1} cuts for {k} tiers, got {cuts}")
    bounds = (0, *(int(c) for c in cuts), n)
    if any(b > a for a, b in zip(bounds[1:], bounds[:-1])):
        raise ValueError(f"cuts must be non-decreasing in [0, {n}]: {cuts}")
    if occupancy is not None:
        if batch is None:
            raise ValueError(
                "occupancy models the batched runtime; pass batch="
            )
        if not 0.0 < occupancy <= 1.0:
            raise ValueError(f"occupancy must be in (0, 1]: {occupancy}")

    surv = np.cumprod(1.0 - p)
    reach = np.concatenate([[1.0], surv[:-1]])
    occ = 1.0 if occupancy is None else float(occupancy)
    entry = next((j for j in range(k) if bounds[j] < bounds[j + 1]), None)
    compute = [0.0] * k  # per-tier compute stage
    xfer = [0.0] * max(k - 1, 0)  # per-hop transfer stage
    for j in range(k):
        lo, hi = bounds[j], bounds[j + 1]
        for i in range(lo + 1, hi + 1):
            if batch is None:
                w = reach[bounds[k - 1]] if (j == k - 1 and k > 1) else reach[i]
            else:
                w = 1.0 if j == entry else _padded_frac(reach[lo] * occ, batch)
            compute[j] += w * _tier_layer_seconds(tiers[j], t_c[i], alpha[i])
    if head_cost is not None:
        blayers = (
            tuple(int(b) for b in branch_layers)
            if branch_layers is not None
            else tuple(i for i in range(1, n + 1) if p[i] > 0.0)
        )
        for j in range(k):
            lo, hi = bounds[j], bounds[j + 1]
            heads = _tier_head_layers(blayers, lo, hi, j, k, n)
            m = len(heads)
            if not m:
                continue
            scale = tiers[j].gamma / max(int(tiers[j].devices), 1)
            if batch is None:
                # Reach-weighted expected work: the joint evaluation's
                # amortized per-head share, charged at each head's reach.
                unit = head_cost(m) / m
                compute[j] += scale * sum(reach[i] * unit for i in heads)
            else:
                w = 1.0 if j == entry else _padded_frac(reach[lo] * occ, batch)
                compute[j] += scale * w * head_cost(m)
    for j in range(k - 1):
        c = bounds[j + 1]
        if c < n:  # layers still run downstream -> the hop really happens
            xfer[j] = _hop_seconds(
                occ * reach[c] * alpha[c] * 8.0, tiers[j].uplink_bps,
                tiers[j].availability,
            )
    if overlap:
        return float(max(compute + xfer))
    return float(sum(compute) + sum(xfer))


def from_cost_profile(profile: CostProfile, tiers: list[TierSpec]) -> MultiTierPlan:
    return solve_multitier(
        profile.t_c, profile.alpha, profile.branch_exit_probs(), tiers
    )
