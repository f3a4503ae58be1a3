"""repro_torch.serving — BranchyNet serving on the K-tier runtime.

    TierExecutor / TierSegment   device-resident exit/compaction core
    ServingEngine                K=1 (calibration: every branch in place)
    PartitionedServer            K=2 (the paper's edge/cloud system)
    MultiTierServer              K>=3 (core.multitier lattice plans)
    RequestScheduler             continuous-batching request lifecycle
"""

from repro_torch.serving.engine import ExitStats, ServingEngine
from repro_torch.serving.multitier import MultiTierServer, MultiTierStepReport
from repro_torch.serving.partitioned import PartitionedServer, StepReport
from repro_torch.serving.scheduler import (
    Request,
    RequestResult,
    RequestScheduler,
    SchedulerStepReport,
    ServesRequests,
)
from repro_torch.serving.tiers import (
    HopCompaction,
    TierExecutor,
    TierSegment,
    TierStepResult,
    bytes_per_sequence,
    segments_for_cuts,
    transfer_seconds,
)

__all__ = [
    "ExitStats",
    "HopCompaction",
    "MultiTierServer",
    "MultiTierStepReport",
    "PartitionedServer",
    "Request",
    "RequestResult",
    "RequestScheduler",
    "SchedulerStepReport",
    "ServesRequests",
    "ServingEngine",
    "StepReport",
    "TierExecutor",
    "TierSegment",
    "TierStepResult",
    "bytes_per_sequence",
    "segments_for_cuts",
    "transfer_seconds",
]
