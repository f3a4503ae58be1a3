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

With a ``cost_profile``, every step reports ``est_latency_s``: the paper's
Eq. 5 at the installed split with this step's measured exit probabilities,
or the lattice cost of the compacted runtime (``compaction="bucketed"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.latency import expected_time
from repro_torch.core.multitier import TierSpec, expected_time_multitier
from repro_torch.core.profiler import H100_SXM, branch_head_cost
from repro_torch.core.types import CostProfile
from repro_torch.serving.scheduler import ServesRequests
from repro_torch.serving.tiers import (
    HopCompaction,
    TierExecutor,
    TierStepResult,
    measured_exit_probs,
    segments_for_cuts,
)

__all__ = ["PartitionedServer", "StepReport"]


@dataclasses.dataclass
class StepReport:
    tokens: np.ndarray  # (B,)
    exited_on_edge: np.ndarray  # (B,) bool
    shipped: int  # sequences that crossed the cut
    bytes_shipped: float
    est_latency_s: float | None  # paper Eq. 5 with the measured exit fraction
    compaction: tuple[HopCompaction, ...] = ()
    branch_take: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # Sampled probe steps: layer -> rows whose probed head was evaluated.
    branch_probe_mask: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    overflow_retries: int = 0  # cumulative, executor-wide
    live: int = 0
    tier_result: TierStepResult | None = None


@dataclasses.dataclass
class PartitionedServer(ServesRequests):
    cfg: ModelConfig
    params: Any
    split_layer: int  # the plan's v_s (0 = cloud-only, L = edge-only)
    cost_profile: CostProfile | None = None  # for latency estimates
    device: Any = None  # None = the current CUDA device (raises without one)
    compaction: str = "bucketed"  # "off" = masked full-batch cloud
    use_kernels: bool | None = None  # None = cfg, then auto
    # One stacked exit decision per tier; the same knob selects the
    # branch-head pricing mode (core.profiler.branch_head_cost) when
    # ``price_heads`` is on.
    heads_batched: bool = True
    # Add the branch-head compute term (priced on H100_SXM through
    # ``heads_batched``) to est_latency_s' lattice cost.
    price_heads: bool = False
    hint_window: int = 8
    bucket_headroom: float = 0.0
    slots: int = 8  # request-scheduler KV slots (submit/run/drain)
    context_len: int = 4096
    # CUDA graphs per cached segment: None = on CUDA, eager on the CPU;
    # False = eager on the card (the comparison baseline).
    graphs: bool | None = None

    def __post_init__(self):
        self.executor = TierExecutor(
            self.cfg, self.params, self._segments(self.split_layer),
            compaction=self.compaction, use_kernels=self.use_kernels,
            batched_heads=self.heads_batched, hint_window=self.hint_window,
            bucket_headroom=self.bucket_headroom, device=self.device,
            graphs=self.graphs,
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
            est_latency_s=self._estimate(self.split_layer, res),
            compaction=res.compaction,
            branch_take=res.branch_take,
            branch_probe_mask=res.branch_probe_mask,
            overflow_retries=self.executor.overflow_retries,
            live=res.live,
            tier_result=res,
        )
        return rep, caches

    def _estimate(self, s: int, res: TierStepResult) -> float | None:
        """Paper Eq. 5 evaluated at this split with the *measured*
        per-branch conditional exit probabilities substituted for p
        (closing the calibration loop).

        Each branch's conditional probability comes from this step's
        first-exit masks (``res.branch_take``): exits at a branch over the
        sequences still alive when they reached it
        (:func:`~repro_torch.serving.tiers.measured_exit_probs`: a probe
        step's overlapping would-exit masks keep p at or below 1, where the
        reference's running count can pass 1 and raise).  A branch the
        installed plan never evaluates (discarded at the cut, or downstream of it)
        reads p = 0: that is the probability the executed plan actually
        experiences.

        When the runtime compacts (``compaction="bucketed"``) the estimate
        uses the lattice cost of the bucketed runtime, so K=2 reports the
        same padding-honest number as ``MultiTierServer`` rather than the
        ideal serial ``surv(s) * B`` cloud term; the step's live width
        feeds the occupancy term, so under continuous batching it prices
        the steady-state live batch rather than the nominal one."""
        if self.cost_profile is None:
            return None
        prof = self.cost_profile
        batch = res.tokens.shape[0]
        live = res.live or batch
        if prof.branches:
            measured = measured_exit_probs(res)
            branches = tuple(
                dataclasses.replace(b, exit_prob=measured.get(b.after_layer, 0.0))
                for b in prof.branches
            )
            prof = dataclasses.replace(prof, branches=branches)
        if self.compaction == "bucketed" and prof.network is not None:
            tiers = [TierSpec("edge", prof.gamma, prof.network.bandwidth_bps),
                     TierSpec("cloud", 1.0)]
            head_cost = (
                branch_head_cost(self.cfg, batch, heads_batched=self.heads_batched,
                                 hardware=H100_SXM)
                if self.price_heads else None
            )
            return expected_time_multitier(
                prof.t_c, prof.alpha, prof.branch_exit_probs(), tiers, (s,),
                batch=batch, occupancy=live / batch, head_cost=head_cost,
                branch_layers=self.cfg.branch_layers,
            )
        return expected_time(prof, s)
