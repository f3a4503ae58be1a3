"""Shortest-path solvers for BranchyNet partitioning (paper Sec. V) —
counterpart of ``repro.core.shortest_path``.

Three interchangeable solvers, cross-checked in tests:

  * :func:`dijkstra` — the paper's solver, run on the explicit ``G'_BDNN``
    graph.  O(m + n log n) with a binary heap; control-plane (pure Python).
  * :func:`brute_force_split` — evaluates Eq. 5/6 at every split; the oracle.
  * :func:`solve_chain_torch` — the closed form of the chain shortest path
    on tensors, in the dtype it is given (float64 for exact agreement with
    the numpy solvers), differentiable by autograd and sweepable over
    (bandwidth, gamma, p) grids with ``torch.func.vmap`` or broadcasting
    (a whole figure is one call).  Beyond-paper: the paper runs Dijkstra
    once per parameter point.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.graph import Graph, build_partition_graph, split_of_path
from repro_torch.core.latency import expected_time_all_splits, plan_from_split
from repro_torch.core.types import CostProfile, PartitionPlan

__all__ = [
    "dijkstra",
    "shortest_path_plan",
    "brute_force_split",
    "solve_chain_torch",
    "chain_costs_torch",
]


def dijkstra(
    graph: Graph, source: str = "input", target: str = "output"
) -> tuple[float, list[str]]:
    """Textbook Dijkstra with a lazy-deletion heap.  Returns (dist, path)."""
    if source not in graph.adj or target not in graph.adj:
        raise KeyError("source/target not in graph")
    dist: dict[str, float] = {source: 0.0}
    prev: dict[str, str] = {}
    done: set[str] = set()
    heap: list[tuple[float, str]] = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if u in done:
            continue
        done.add(u)
        if u == target:
            break
        for v, w in graph.adj[u]:
            nd = d + w
            if nd < dist.get(v, float("inf")):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, v))
    if target not in dist:
        raise ValueError("target unreachable")
    path = [target]
    while path[-1] != source:
        path.append(prev[path[-1]])
    path.reverse()
    return dist[target], path


def shortest_path_plan(profile: CostProfile) -> PartitionPlan:
    """Paper's method end to end: build G'_BDNN, run Dijkstra, decode s."""
    g = build_partition_graph(profile)
    cost, path = dijkstra(g)
    s = split_of_path(path)
    plan = plan_from_split(profile, s, method="dijkstra")
    # The graph cost should equal the closed form up to the epsilon link.
    assert abs(cost - plan.expected_time_s) < 1e-6 + 1e-9 * abs(cost), (
        f"graph/closed-form divergence: {cost} vs {plan.expected_time_s}"
    )
    return plan


def brute_force_split(profile: CostProfile) -> PartitionPlan:
    """Oracle: argmin over all N+1 splits of the closed-form E[T]."""
    costs = expected_time_all_splits(profile)
    s = int(np.argmin(costs))
    return plan_from_split(profile, s, method="brute_force")


# ---------------------------------------------------------------------------
# Closed-form solver on tensors (vectorized sensitivity sweeps)
# ---------------------------------------------------------------------------


def chain_costs_torch(
    t_c: torch.Tensor,  # (..., N+1) cloud per-layer seconds, [0] == 0
    alpha: torch.Tensor,  # (..., N+1) output bytes per layer, [0] == raw input
    p: torch.Tensor,  # (..., N+1) conditional exit prob per layer (0 = no branch)
    gamma: torch.Tensor,  # (...) edge slowdown
    bandwidth_bps: torch.Tensor,  # (...)
    branch_t_c: torch.Tensor | None = None,  # (..., N+1) branch head cloud seconds
) -> torch.Tensor:
    """E[T_inf(s)] for all splits s=0..N; differentiable w.r.t. everything.

    Mirrors latency.expected_time_all_splits on tensors (leading batch
    dimensions broadcast: ``gamma`` and ``bandwidth_bps`` carry them without
    the layer axis).  The cumulative products / sums are the scan form of
    Bellman-Ford on the chain DAG: dist[s] = dist[s-1] + w_e[s], relaxed
    once per vertex in topological order, which is all a DAG needs.
    """
    gamma = torch.as_tensor(gamma, dtype=t_c.dtype, device=t_c.device)[..., None]
    bw = torch.as_tensor(bandwidth_bps, dtype=t_c.dtype, device=t_c.device)[..., None]
    t_net = alpha * 8.0 / bw
    t_e = gamma * t_c
    surv = torch.cumprod(1.0 - p, dim=-1)  # surv[i] = alive after v_i's branch
    reach = torch.cat([torch.ones_like(surv[..., :1]), surv[..., :-1]], dim=-1)

    w_e = t_e * reach
    if branch_t_c is not None:
        # Branch head at layer k is paid by splits s >= k+1 (Fig. 2(c)).
        w_b = gamma * branch_t_c * reach
        w_e = w_e + torch.cat([torch.zeros_like(w_b[..., :1]), w_b[..., :-1]], dim=-1)
    cum_edge = torch.cumsum(w_e, dim=-1)

    tail_cloud = torch.cat(
        [torch.flip(torch.cumsum(torch.flip(t_c, (-1,)), dim=-1), (-1,))[..., 1:],
         torch.zeros_like(t_c[..., :1])], dim=-1)
    surv_at_cut = reach  # branch at the cut is not evaluated
    cost = cum_edge + surv_at_cut * (t_net + tail_cloud)
    # Edge-only pays no transfer.
    edge_only = torch.arange(t_c.shape[-1], device=t_c.device) == t_c.shape[-1] - 1
    return torch.where(edge_only, cum_edge, cost)


def solve_chain_torch(
    t_c: torch.Tensor,
    alpha: torch.Tensor,
    p: torch.Tensor,
    gamma: torch.Tensor,
    bandwidth_bps: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(optimal split s*, E[T(s*)]), the first split on ties as numpy's
    argmin.  Sweep with ``torch.func.vmap`` over any argument, or pass
    batched ``gamma`` / ``bandwidth_bps`` (shape (...)) directly."""
    costs = chain_costs_torch(t_c, alpha, p, gamma, bandwidth_bps)
    s = torch.argmin(costs, dim=-1)
    return s, torch.gather(costs, -1, s[..., None])[..., 0]
