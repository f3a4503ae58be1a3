"""Partitioned (edge/cloud) BranchyNet serving — the paper's system, a
2-tier configuration of :class:`~repro_torch.serving.tiers.TierExecutor`
(counterpart of ``repro.serving.partitioned``).

One decode step splits at the partition layer ``v_s``: the edge runs the
embedding, trunk layers [0, s) and the side branches before the cut
(sequences that clear the threshold exit there and are never shipped); the
survivors' residual stream (bf16, ``d_model`` per row) crosses the cut; the
cloud runs layers [s, L) and the final head on them.  On one card both
tiers run locally, with the tier boundary real in the program: two
segments and an explicit tensor handoff.

``est_latency_s`` (the paper's Eq. 5 estimate) stays None until the
``core`` cost model is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.scheduler import ServesRequests
from repro_torch.serving.tiers import (
    HopCompaction,
    TierExecutor,
    TierStepResult,
    segments_for_cuts,
)

__all__ = ["PartitionedServer", "StepReport"]


@dataclasses.dataclass
class StepReport:
    tokens: np.ndarray  # (B,)
    exited_on_edge: np.ndarray  # (B,) bool
    shipped: int  # sequences that crossed the cut
    bytes_shipped: float
    est_latency_s: float | None  # not computed until core/ is ported
    compaction: tuple[HopCompaction, ...] = ()
    branch_take: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    overflow_retries: int = 0  # cumulative, executor-wide
    live: int = 0
    tier_result: TierStepResult | None = None


@dataclasses.dataclass
class PartitionedServer(ServesRequests):
    cfg: ModelConfig
    params: Any
    split_layer: int  # the plan's v_s (0 = cloud-only, L = edge-only)
    device: Any = None  # None = the current CUDA device (raises without one)
    compaction: str = "bucketed"  # "off" = masked full-batch cloud
    use_kernels: bool | None = None  # None = cfg, then auto
    heads_batched: bool = True  # one stacked exit decision per tier
    hint_window: int = 8
    bucket_headroom: float = 0.0
    slots: int = 8  # request-scheduler KV slots (submit/run/drain)
    context_len: int = 4096

    def __post_init__(self):
        self.executor = TierExecutor(
            self.cfg, self.params, self._segments(self.split_layer),
            compaction=self.compaction, use_kernels=self.use_kernels,
            batched_heads=self.heads_batched, hint_window=self.hint_window,
            bucket_headroom=self.bucket_headroom, device=self.device,
        )
        self.device = self.executor.device
        self.params = self.executor.params

    def _segments(self, s: int):
        return segments_for_cuts(self.cfg, (s,), names=("edge", "cloud"))

    def set_split(self, split_layer: int) -> None:
        """Move the cut at run time."""
        if split_layer != self.split_layer:
            self.executor.install(self._segments(split_layer))
            self.split_layer = split_layer

    def step(self, tok: torch.Tensor, pos, caches: dict, *, active=None
             ) -> tuple[StepReport, dict]:
        res, caches = self.executor.step(tok, pos, caches, active=active)
        rep = StepReport(
            tokens=res.tokens,
            exited_on_edge=res.exited,
            shipped=res.shipped_per_hop[0] if res.shipped_per_hop else 0,
            bytes_shipped=res.bytes_per_hop[0] if res.bytes_per_hop else 0.0,
            est_latency_s=None,
            compaction=res.compaction,
            branch_take=res.branch_take,
            overflow_retries=self.executor.overflow_retries,
            live=res.live,
            tier_result=res,
        )
        return rep, caches
