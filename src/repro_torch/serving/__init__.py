"""repro_torch.serving — BranchyNet serving on the K-tier runtime.

    TierExecutor / TierSegment   device-resident exit/compaction core
    PartitionedServer            K=2 (the paper's edge/cloud system)
    RequestScheduler             continuous-batching request lifecycle
"""

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
)

__all__ = [
    "HopCompaction",
    "PartitionedServer",
    "Request",
    "RequestResult",
    "RequestScheduler",
    "SchedulerStepReport",
    "ServesRequests",
    "StepReport",
    "TierExecutor",
    "TierSegment",
    "TierStepResult",
    "bytes_per_sequence",
    "segments_for_cuts",
]
