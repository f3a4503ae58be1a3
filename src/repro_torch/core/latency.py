"""Expected-inference-time model for a partitioned BranchyNet.

Counterpart of ``repro.core.latency``, numpy only.

Implements paper Eqs. 1-6 and their natural generalization to many branches.

Semantics (Sec. IV-B/IV-C of the paper):

  * the edge processes ``v_1 .. v_s`` and evaluates the side branches
    ``b_k`` with ``after_layer < s`` (the branch sitting exactly at the cut,
    ``after_layer == s``, is *not* evaluated — Fig. 2(c) ships ``alpha_s``
    immediately);
  * the cloud never evaluates side branches (Sec. IV-B);
  * every cost incurred strictly after branch ``b_k`` is weighted by the
    survival probability ``prod_{j <= k} (1 - p_j)`` — in the paper's
    single-branch case this is exactly the ``(1 - p_Y(k))`` factor of Eq. 5.

Eq. 8 in the paper writes the multiplier as ``p_Y(k)``; read literally that
*up*-weights late links when exits are likely, contradicting both Eq. 5 and
the quoted text ("the higher the probability ... the less significant are the
weights of links after the side branch").  We therefore implement the
survival-probability reading, which reproduces Eq. 5 exactly.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import CostProfile, PartitionPlan

__all__ = [
    "expected_time",
    "expected_time_all_splits",
    "plan_from_split",
]


def _edge_layer_weights(profile: CostProfile, include_branches: bool) -> np.ndarray:
    """Per-main-layer expected *edge* cost, reach-probability weighted.

    Returns ``w`` of shape (N+1,) where ``w[i]`` is the expected time the edge
    spends on layer ``v_i`` (plus its branch head, if modeled) given that the
    partition lies at or beyond ``i``.  ``w[0] == 0``.
    """
    t_e = profile.t_e
    surv = profile.survival_after()  # surv[i] = P[alive after v_i's branch]
    n = profile.num_layers
    w = np.zeros(n + 1)
    # reach(v_i) = survival after branch b_{i-1} = surv[i-1].
    w[1:] = t_e[1:] * surv[:-1]
    if include_branches:
        for b in profile.branches:
            # Branch b_k runs right after v_k, reached with prob surv[k-1].
            # It is evaluated only when the cut lies strictly beyond v_k
            # (Fig. 2(c)), so its cost belongs to splits s >= k+1 -> slot k+1.
            w[b.after_layer + 1] += (
                profile.gamma * b.compute_time_cloud * surv[b.after_layer - 1]
            )
    return w


def expected_time_all_splits(profile: CostProfile) -> np.ndarray:
    """E[T_inf(s)] for every split ``s in 0..N`` as a closed-form vector.

    ``s == 0`` is cloud-only (upload raw input, Eq. 3 with T_e = 0);
    ``s == N`` is edge-only (no transfer).  This is the chain-DAG shortest
    path evaluated exhaustively -- used as the oracle and by the vectorized
    sensitivity sweeps.
    """
    n = profile.num_layers
    t_c = profile.t_c
    t_net = profile.t_net
    w_e = _edge_layer_weights(profile, profile.include_branch_compute)
    surv = profile.survival_after()

    cum_edge = np.cumsum(w_e)  # cum_edge[s] = expected edge time through v_s
    # tail_cloud[s] = sum_{i>s} t_i^c  (cloud evaluates no branches).
    tail_cloud = np.concatenate([np.cumsum(t_c[::-1])[::-1][1:], [0.0]])

    # Survival probability *entering the link* out of v_s: branches evaluated
    # on the edge are those with after_layer <= s-1, i.e. surv at index s-1;
    # cloud-only (s=0) ships with probability 1.
    surv_at_cut = np.ones(n + 1)
    surv_at_cut[1:] = surv[:-1]

    cost = cum_edge + surv_at_cut * (t_net + tail_cloud)
    # Edge-only pays no transfer.
    cost[n] = cum_edge[n]
    return cost


def expected_time(profile: CostProfile, split_layer: int) -> float:
    """E[T_inf] (paper Eq. 5/6) for one split point."""
    n = profile.num_layers
    if not 0 <= split_layer <= n:
        raise ValueError(f"split_layer must be in 0..{n}")
    return float(expected_time_all_splits(profile)[split_layer])


def plan_from_split(
    profile: CostProfile, split_layer: int, method: str = "closed_form"
) -> PartitionPlan:
    n = profile.num_layers
    t = expected_time(profile, split_layer)
    edge_layers = tuple(range(1, split_layer + 1))
    cloud_layers = tuple(range(split_layer + 1, n + 1))
    edge_branches = tuple(
        b.after_layer for b in profile.branches if b.after_layer < split_layer
    )
    tx = float(profile.alpha[split_layer]) if split_layer < n else 0.0
    return PartitionPlan(
        split_layer=split_layer,
        expected_time_s=t,
        edge_layers=edge_layers,
        cloud_layers=cloud_layers,
        edge_branches=edge_branches,
        transfer_bytes=tx,
        method=method,
    )
