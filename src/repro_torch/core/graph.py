"""Construction of the partitioning graph ``G'_BDNN`` (paper Sec. V, Eq. 7-8).

Counterpart of ``repro.core.graph``, numpy only.

Vertices (for a main branch of N layers):

  * ``input`` / ``output`` — the two virtual terminals;
  * ``e:i``   — main layer ``v_i`` processed on the edge (``P^e`` chain);
  * ``b:k``   — side branch ``b_k`` on the edge (interleaved into ``P^e``);
  * ``a:i``   — auxiliary cut vertex ``v_i^{*e}`` (paper's orange vertices);
  * ``c:i``   — main layer ``v_i`` processed in the cloud (``P^c`` chain);
  * ``t:out`` — the virtual ``v^{*c}`` predecessor of ``output`` carrying the
    epsilon link that disambiguates the p == 1 case.

Link weights follow Eq. 7, scaled per Eq. 8 by the probability that the
sample is still alive when the link is traversed (see latency.py for why the
multiplier is the survival probability ``prod_{j<=k}(1-p_j)``, not the
literal ``p_Y(k)``).

A shortest ``input -> output`` path therefore costs exactly
``E[T_inf(s)]`` (latency.expected_time) for the split ``s`` it encodes, up to
the epsilon tie-breaker.  ``tests/test_torch_core.py`` asserts the
equivalence property against the closed form and brute force.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import CostProfile

__all__ = ["Graph", "build_partition_graph", "EPSILON"]

#: Paper Sec. V: "The weight epsilon must be a very small value, to not
#: interfere with the result of the shortest path problem."
EPSILON = 1e-12


@dataclasses.dataclass
class Graph:
    """Minimal adjacency-list digraph with non-negative float weights."""

    adj: dict[str, list[tuple[str, float]]] = dataclasses.field(default_factory=dict)

    def add_vertex(self, v: str) -> None:
        self.adj.setdefault(v, [])

    def add_link(self, u: str, v: str, w: float) -> None:
        if w < 0:
            raise ValueError(f"negative link weight {w} on ({u},{v})")
        self.add_vertex(u)
        self.add_vertex(v)
        self.adj[u].append((v, float(w)))

    @property
    def num_vertices(self) -> int:
        return len(self.adj)

    @property
    def num_links(self) -> int:
        return sum(len(out) for out in self.adj.values())


def split_of_path(path: list[str]) -> int:
    """Recover the partition layer ``s`` encoded by an input->output path."""
    edge_layers = [int(v.split(":")[1]) for v in path if v.startswith("e:")]
    return max(edge_layers) if edge_layers else 0


def build_partition_graph(profile: CostProfile) -> Graph:
    """Build ``G'_BDNN`` for a cost profile.

    Weight conventions (Eq. 7), with ``surv(i)`` the probability the sample
    is alive after the branch of layer ``i`` (1 if no branch):

      * edge-chain link out of ``v_i^e``            -> ``surv``-scaled t_i^e
      * cloud-chain link out of ``v_i^c``           -> ``surv``-scaled t_i^c
      * ``input -> c:1``                            -> t_input^net  (Eq. 7 row 3)
      * ``input -> e:1``                            -> 0            (edge-only entry)
      * ``a:i -> c:{i+1}``                          -> surv-scaled t_i^net (cut!)
      * ``a:i -> next edge vertex``                 -> 0            (Eq. 7 row 5)
      * ``c:N -> t:out -> output``                  -> epsilon tie-break
      * ``e:N -> output``                           -> 0 (edge-only exit)

    Side-branch vertices ``b:k`` are interleaved on the edge chain between
    ``a:k`` and ``e:{k+1}``; their outgoing weight is the (optional) branch
    compute time; traversing past them applies the (1-p_k) survival scaling
    to everything downstream.
    """
    n = profile.num_layers
    t_e = profile.t_e
    t_c = profile.t_c
    t_net = profile.t_net
    branches = {b.after_layer: b for b in profile.branches}

    g = Graph()
    g.add_vertex("input")
    g.add_vertex("output")

    # --- cloud chain P^c: cloud-only entry costs the raw-input upload.
    g.add_link("input", "c:1", t_net[0])
    for i in range(1, n):
        g.add_link(f"c:{i}", f"c:{i + 1}", t_c[i])
    g.add_link(f"c:{n}", "t:out", t_c[n])
    g.add_link("t:out", "output", EPSILON)

    # --- edge chain P^e with auxiliary cut vertices and branch vertices.
    g.add_link("input", "e:1", 0.0)
    alive = 1.0  # survival probability at the current position in the chain
    for i in range(1, n + 1):
        # Processing v_i on the edge; every traversal this deep is already
        # conditioned on surviving all branches before v_i.
        w_proc = alive * t_e[i]
        g.add_link(f"e:{i}", f"a:{i}", w_proc)
        if i < n:
            # Cut here: ship alpha_i to the cloud, continue on the cloud chain.
            g.add_link(f"a:{i}", f"c:{i + 1}", alive * t_net[i])
        else:
            # Edge-only exit.
            g.add_link(f"a:{n}", "output", 0.0)
        b = branches.get(i)
        if b is not None and i < n:
            w_b = (
                alive * profile.gamma * b.compute_time_cloud
                if profile.include_branch_compute
                else 0.0
            )
            g.add_link(f"a:{i}", f"b:{i}", 0.0)
            alive *= 1.0 - b.exit_prob
            g.add_link(f"b:{i}", f"e:{i + 1}", w_b)
        elif i < n:
            g.add_link(f"a:{i}", f"e:{i + 1}", 0.0)

    # Cloud-chain weights after a branch position are *not* rescaled on the
    # cloud chain itself: the cloud never evaluates branches, so the cloud
    # chain entered from ``input`` keeps full weights.  The survival scaling
    # of a *partitioned* path is carried entirely by the prefix treatment
    # above... except that the cloud tail after a cut must also be scaled.
    # We achieve that with dedicated scaled tail chains per cut point, see
    # below: replace the naive a:i -> c:{i+1} links with scaled tails.
    return _rescale_cloud_tails(g, profile)


def _rescale_cloud_tails(g: Graph, profile: CostProfile) -> Graph:
    """Replace each cut link ``a:i -> c:{i+1}`` with a scaled private tail.

    A path that cuts after ``v_i`` has survival ``surv(i-1)`` (branches up to
    ``b_{i-1}`` were evaluated on the edge; the branch at the cut is skipped,
    Fig. 2(c)).  The whole remaining cost — transfer *and* the cloud tail —
    must be scaled by it (Eq. 5's ``(1 - p_Y(k))`` factor).  Sharing the
    unscaled ``P^c`` chain would lose that, so each cut gets its own scaled
    copy of the tail; this keeps the graph linear in size: O(N^2) links for
    N layers, still trivially Dijkstra-able for any realistic depth, and an
    exact materialization of Eq. 8's "weights after the branch are scaled".
    """
    n = profile.num_layers
    t_c = profile.t_c
    t_net = profile.t_net
    surv = profile.survival_after()

    # Drop the naive cut links added during construction.
    for i in range(1, n):
        g.adj[f"a:{i}"] = [(v, w) for v, w in g.adj[f"a:{i}"] if not v.startswith("c:")]

    for i in range(1, n):
        alive = surv[i - 1]  # branch at the cut is not evaluated
        g.add_link(f"a:{i}", f"ct:{i}:{i + 1}", alive * t_net[i])
        for j in range(i + 1, n + 1):
            src = f"ct:{i}:{j}"
            if j < n:
                g.add_link(src, f"ct:{i}:{j + 1}", alive * t_c[j])
            else:
                g.add_link(src, "t:out", alive * t_c[n])
    return g
