"""End-to-end partitioner: cost profile -> G'_BDNN -> shortest path -> plan.
Counterpart of ``repro.core.partitioner``.

This is the control plane a deployment calls at admission time (and again
whenever the network profile or the calibrated exit probabilities drift).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.calibration import CalibrationResult
from repro_torch.core.latency import expected_time_all_splits
from repro_torch.core.profiler import LayerCost
from repro_torch.core.shortest_path import brute_force_split, shortest_path_plan
from repro_torch.core.types import (
    UPLINK_PRESETS,
    BranchSpec,
    CostProfile,
    NetworkProfile,
    PartitionPlan,
)

__all__ = ["Partitioner", "build_cost_profile"]


def build_cost_profile(
    layer_costs: Sequence[LayerCost],
    branch_positions: Sequence[int],
    exit_probs: Sequence[float] | CalibrationResult,
    network: NetworkProfile | str,
    gamma: float,
    raw_input_bytes: float,
    branch_costs: Sequence[LayerCost] | None = None,
    include_branch_compute: bool = False,
) -> CostProfile:
    """Assemble a CostProfile from profiler output + calibration.

    ``layer_costs`` covers the N main-branch layers in chain order;
    ``branch_positions[j]`` is the 1-based main layer feeding branch j.
    """
    if isinstance(network, str):
        network = UPLINK_PRESETS[network]
    if isinstance(exit_probs, CalibrationResult):
        exit_probs = exit_probs.conditional_p
    if len(branch_positions) != len(exit_probs):
        raise ValueError("one exit probability per branch position")
    t_c = np.concatenate([[0.0], [c.time_s for c in layer_costs]])
    alpha = np.concatenate([[raw_input_bytes], [c.output_bytes for c in layer_costs]])
    names = ("input", *(c.name for c in layer_costs))
    branches = []
    for j, (pos, p) in enumerate(zip(branch_positions, exit_probs)):
        bc = branch_costs[j].time_s if branch_costs is not None else 0.0
        branches.append(BranchSpec(after_layer=int(pos), exit_prob=float(p), compute_time_cloud=bc))
    return CostProfile(
        t_c=t_c,
        alpha=alpha,
        branches=tuple(branches),
        gamma=gamma,
        network=network,
        include_branch_compute=include_branch_compute,
        layer_names=names,
    )


@dataclasses.dataclass
class Partitioner:
    """Solves the BranchyNet partitioning problem for one cost profile.

    ``method``: "dijkstra" (the paper's solver, run on the explicit graph)
    or "brute_force" (closed-form argmin oracle).  They always agree; the
    graph solver is kept as the deployed path because it extends to DAGs
    (repro_torch.core.dag) where no closed form exists.
    """

    profile: CostProfile
    method: str = "dijkstra"

    def solve(self) -> PartitionPlan:
        if self.method == "dijkstra":
            return shortest_path_plan(self.profile)
        if self.method == "brute_force":
            return brute_force_split(self.profile)
        raise ValueError(f"unknown method {self.method!r}")

    def all_split_times(self) -> np.ndarray:
        return expected_time_all_splits(self.profile)

    def with_network(self, network: NetworkProfile | str) -> "Partitioner":
        if isinstance(network, str):
            network = UPLINK_PRESETS[network]
        return Partitioner(dataclasses.replace(self.profile, network=network), self.method)

    def with_gamma(self, gamma: float) -> "Partitioner":
        return Partitioner(dataclasses.replace(self.profile, gamma=gamma), self.method)

    def with_exit_probs(self, probs: Sequence[float]) -> "Partitioner":
        branches = tuple(
            dataclasses.replace(b, exit_prob=float(p))
            for b, p in zip(self.profile.branches, probs)
        )
        return Partitioner(
            dataclasses.replace(self.profile, branches=branches), self.method
        )
