"""The paper's contribution: BranchyNet partitioning as shortest path —
counterpart of ``repro.core``.

Public API:

    from repro_torch.core import (
        BranchSpec, CostProfile, NetworkProfile, PartitionPlan, UPLINK_PRESETS,
        Partitioner, build_cost_profile,
        expected_time, expected_time_all_splits,
        build_partition_graph, dijkstra, shortest_path_plan, brute_force_split,
        solve_chain_torch, chain_costs_torch,
        normalized_entropy, calibrate_exit_probs, threshold_sweep,
        analyze_layer_costs, measure_layer_times, capture_layer, HardwareSpec,
        H100_SXM,
    )
"""

from repro_torch.core.calibration import (
    CalibrationResult,
    calibrate_exit_probs,
    exit_mask,
    normalized_entropy,
    threshold_sweep,
)
from repro_torch.core.dag import DagCostModel, DagNode, chain_as_dag, min_cut_partition
from repro_torch.core.graph import Graph, build_partition_graph
from repro_torch.core.latency import (
    expected_time,
    expected_time_all_splits,
    plan_from_split,
)
from repro_torch.core.multitier import (
    MultiTierPlan,
    TierSpec,
    expected_time_multitier,
    solve_multitier,
)
from repro_torch.core.partitioner import Partitioner, build_cost_profile
from repro_torch.core.profiler import (
    H100_SXM,
    HardwareSpec,
    LayerCost,
    analyze_layer_costs,
    capture_layer,
    decode_layer_fns,
    measure_layer_times,
    output_bytes,
    profile_decode_layers,
)
from repro_torch.core.shortest_path import (
    brute_force_split,
    chain_costs_torch,
    dijkstra,
    shortest_path_plan,
    solve_chain_torch,
)
from repro_torch.core.types import (
    UPLINK_PRESETS,
    BranchSpec,
    CostProfile,
    NetworkProfile,
    PartitionPlan,
)

__all__ = [
    "BranchSpec",
    "CostProfile",
    "NetworkProfile",
    "PartitionPlan",
    "UPLINK_PRESETS",
    "Partitioner",
    "build_cost_profile",
    "expected_time",
    "expected_time_all_splits",
    "plan_from_split",
    "Graph",
    "build_partition_graph",
    "DagCostModel",
    "DagNode",
    "chain_as_dag",
    "min_cut_partition",
    "TierSpec",
    "MultiTierPlan",
    "solve_multitier",
    "expected_time_multitier",
    "dijkstra",
    "shortest_path_plan",
    "brute_force_split",
    "solve_chain_torch",
    "chain_costs_torch",
    "CalibrationResult",
    "normalized_entropy",
    "exit_mask",
    "calibrate_exit_probs",
    "threshold_sweep",
    "HardwareSpec",
    "H100_SXM",
    "LayerCost",
    "analyze_layer_costs",
    "capture_layer",
    "decode_layer_fns",
    "measure_layer_times",
    "profile_decode_layers",
    "output_bytes",
]
