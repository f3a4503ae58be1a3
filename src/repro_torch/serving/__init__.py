"""repro_torch.serving — BranchyNet serving on the K-tier runtime.

    TierExecutor / TierSegment   device-resident exit/compaction core
    ServingEngine                K=1 (calibration: every branch in place)
    PartitionedServer            K=2 (the paper's edge/cloud system)
    MultiTierServer              K>=3 (core.multitier lattice plans)
    RequestScheduler             continuous-batching request lifecycle
    RepartitionController        live p_k / network / hop health -> solver
                                 -> hot swap
    LinkFaultModel / HopPolicy   seeded hop faults + retry / breaker policy
                                 (degraded steps, the edge fallback)
"""

from repro_torch.serving.controller import (
    RepartitionController,
    exit_distribution,
    exit_drift_kl,
)
from repro_torch.serving.engine import ExitStats, ServingEngine
from repro_torch.serving.faults import (
    CircuitBreaker,
    FaultEvent,
    FlapWindow,
    HopPolicy,
    LinkDownError,
    LinkFaultModel,
)
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
    SegmentFn,
    TierExecutor,
    TierSegment,
    TierStepResult,
    bytes_per_sequence,
    segments_for_cuts,
    transfer_seconds,
)

__all__ = [
    "CircuitBreaker",
    "ExitStats",
    "FaultEvent",
    "FlapWindow",
    "HopPolicy",
    "LinkDownError",
    "LinkFaultModel",
    "HopCompaction",
    "MultiTierServer",
    "MultiTierStepReport",
    "PartitionedServer",
    "RepartitionController",
    "Request",
    "RequestResult",
    "RequestScheduler",
    "SchedulerStepReport",
    "ServesRequests",
    "SegmentFn",
    "ServingEngine",
    "StepReport",
    "TierExecutor",
    "TierSegment",
    "TierStepResult",
    "bytes_per_sequence",
    "exit_distribution",
    "exit_drift_kl",
    "segments_for_cuts",
    "transfer_seconds",
]
