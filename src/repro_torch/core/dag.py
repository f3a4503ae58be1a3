"""DAG partitioning — the paper's stated future work, implemented.

Counterpart of ``repro.core.dag``, numpy only.

The paper (Sec. VII): "As future work, our first goal is to extend our
proposal to handle also DAG topology DNN."  For general DAGs the chain
shortest-path construction no longer applies; following DADS [6] the
minimum-expected-time partition of a DAG is a minimum s-t cut:

  * node v on the edge device pays t_v^e, in the cloud pays t_v^c;
  * a data dependency (u, v) crossing edge->cloud pays t_u^net;
  * construction: arc (s, v) with capacity t_v^c (cut when v is assigned
    to the CLOUD side), arc (v, t) with capacity t_v^e (cut when v stays
    on the EDGE side), arc (u, v) with capacity t_u^net and an infinite
    reverse arc (v, u) forbidding cloud->edge data flow.

Early-exit weighting: when the DAG is a chain-with-branches, weights are
pre-scaled by the survival probability exactly as in the chain solver; for
general DAGs the caller provides already-scaled costs (exit semantics on
arbitrary DAGs are application-specific).

Max-flow is Dinic's algorithm — graphs here are model graphs (tens to a
few hundred nodes), so this is control-plane trivial.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

__all__ = ["DagNode", "DagCostModel", "min_cut_partition", "chain_as_dag"]

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class DagNode:
    name: str
    t_edge: float
    t_cloud: float


@dataclasses.dataclass
class DagCostModel:
    nodes: dict[str, DagNode]
    links: list[tuple[str, str, float]]  # (u, v, transfer_time u->v)
    input_upload_time: float = 0.0  # raw-input transfer if the first nodes
    #                                 run in the cloud (alpha_0 / B)
    input_consumers: tuple[str, ...] = ()


class _Dinic:
    def __init__(self):
        self.g: dict[str, list] = collections.defaultdict(list)

    def add(self, u, v, cap):
        # forward edge [v, cap, index_of_reverse], reverse with 0 cap
        self.g[u].append([v, cap, len(self.g[v])])
        self.g[v].append([u, 0.0, len(self.g[u]) - 1])

    def max_flow(self, s, t) -> float:
        flow = 0.0
        while True:
            level = {s: 0}
            dq = collections.deque([s])
            while dq:
                u = dq.popleft()
                for v, cap, _ in self.g[u]:
                    if cap > 1e-12 and v not in level:
                        level[v] = level[u] + 1
                        dq.append(v)
            if t not in level:
                return flow
            it = {u: 0 for u in self.g}

            def dfs(u, f):
                if u == t:
                    return f
                while it[u] < len(self.g[u]):
                    e = self.g[u][it[u]]
                    v, cap, rev = e
                    if cap > 1e-12 and level.get(v, -1) == level[u] + 1:
                        d = dfs(v, min(f, cap))
                        if d > 1e-12:
                            e[1] -= d
                            self.g[v][rev][1] += d
                            return d
                    it[u] += 1
                return 0.0

            while True:
                f = dfs(s, INF)
                if f <= 1e-12:
                    break
                flow += f

    def reachable(self, s) -> set[str]:
        seen = {s}
        dq = collections.deque([s])
        while dq:
            u = dq.popleft()
            for v, cap, _ in self.g[u]:
                if cap > 1e-12 and v not in seen:
                    seen.add(v)
                    dq.append(v)
        return seen


def min_cut_partition(model: DagCostModel) -> tuple[set[str], set[str], float]:
    """Returns (edge_set, cloud_set, expected_time)."""
    net = _Dinic()
    s, t = "__source__", "__sink__"
    for name, node in model.nodes.items():
        net.add(s, name, node.t_cloud)  # cut -> v in cloud pays t_cloud
        net.add(name, t, node.t_edge)  # cut -> v on edge pays t_edge
    for u, v, tx in model.links:
        net.add(u, v, tx)
        net.add(v, u, INF)  # forbid cloud -> edge data flow
    # Raw-input upload: the sample materializes on the edge device (paper
    # Sec. IV-C); pin a virtual input node to the edge side and charge the
    # upload once if any consumer lands in the cloud (via a shared hub).
    if model.input_consumers and model.input_upload_time > 0:
        net.add(s, "__input__", INF)  # cloud assignment impossible
        net.add("__input__", t, 0.0)  # free on the edge
        net.add("__input__", "__uphub__", model.input_upload_time)
        net.add("__uphub__", "__input__", INF)
        for v in model.input_consumers:
            net.add("__uphub__", v, INF)
            net.add(v, "__uphub__", INF)
    cost = net.max_flow(s, t)
    edge_side = net.reachable(s) - {s}
    edge = {n for n in model.nodes if n in edge_side}
    cloud = set(model.nodes) - edge
    return edge, cloud, cost


def chain_as_dag(t_c, alpha, bandwidth_bps: float, gamma: float) -> DagCostModel:
    """Lift the paper's chain model into the DAG solver (for cross-checks:
    with no branches, min-cut and shortest path must agree)."""
    t_c = np.asarray(t_c, float)
    alpha = np.asarray(alpha, float)
    n = len(t_c) - 1
    nodes = {
        f"v{i}": DagNode(f"v{i}", gamma * t_c[i], t_c[i]) for i in range(1, n + 1)
    }
    links = [
        (f"v{i}", f"v{i + 1}", alpha[i] * 8.0 / bandwidth_bps)
        for i in range(1, n)
    ]
    return DagCostModel(
        nodes=nodes,
        links=links,
        input_upload_time=alpha[0] * 8.0 / bandwidth_bps,
        input_consumers=("v1",),
    )
