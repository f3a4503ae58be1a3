"""K-tier BranchyNet serving (beyond-paper; executes core.multitier plans)
— counterpart of ``repro.serving.multitier``.

The paper's deployment has one bandwidth cliff; real fleets have several
(device -> edge server -> regional cloud -> core cloud).  The lattice
solver in :mod:`repro_torch.core.multitier` picks the optimal monotone
layer->tier assignment; this server *executes* it on the
:class:`~repro_torch.serving.tiers.TierExecutor` runtime: one segment per
tier, exit masking on the device, survivors shipped across every hop, and
per-hop byte accounting against each :class:`TierSpec`'s uplink.

With K=2 this is exactly the paper's ``PartitionedServer``.  Each
``TierSpec.uplink_bps`` is its segment's uplink: ``simulate_network``,
``overlap`` and the fault plane (``fault_model`` / ``hop_policy``) work as
on the K=2 server (see :mod:`repro_torch.serving.tiers`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.multitier import MultiTierPlan, TierSpec, expected_time_multitier
from repro_torch.core.profiler import H100_SXM, branch_head_cost
from repro_torch.serving.scheduler import ServesRequests
from repro_torch.serving.tiers import (
    HopCompaction,
    TierExecutor,
    TierStepResult,
    measured_exit_probs,
    segments_for_cuts,
    transfer_seconds,
)

__all__ = ["MultiTierServer", "MultiTierStepReport"]


@dataclasses.dataclass
class MultiTierStepReport:
    tokens: np.ndarray  # (B,)
    exit_tier: np.ndarray  # (B,) int32: tier of the first exit, -1 = head
    exited: np.ndarray  # (B,) bool
    shipped_per_hop: tuple[int, ...]  # survivors crossing each hop
    bytes_per_hop: tuple[float, ...]
    transfer_s_per_hop: tuple[float, ...]  # bytes * 8 / uplink_bps per hop
    est_latency_s: float | None  # lattice cost model at the installed cuts
    compaction: tuple[HopCompaction, ...] = ()  # per-hop (survivors, bucket)
    branch_take: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # Sampled probe steps: layer -> rows whose probed head was evaluated.
    branch_probe_mask: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    sim_transfer_s: tuple[float, ...] = ()  # simulated uplink time per hop
    overflow_retries: int = 0  # cumulative, executor-wide
    pipeline_fallbacks: int = 0  # cumulative: pipelined steps paid serially
    live: int = 0  # live request slots this step decoded (B in lock-step)
    tier_result: TierStepResult | None = None
    #: The fault plane's outputs: rows finalized from the fallback head,
    #: rows that could not emit, the step's fault trace, and the broken hop
    #: (None = healthy step).
    degraded: np.ndarray | None = None
    failed: np.ndarray | None = None
    fault_events: tuple = ()
    degraded_hop: int | None = None


@dataclasses.dataclass
class MultiTierServer(ServesRequests):
    cfg: ModelConfig
    params: Any
    tiers: Sequence[TierSpec]
    cuts: tuple[int, ...]  # layer after which each hop happens (K-1,)
    cost: tuple[np.ndarray, np.ndarray] | None = None  # (t_c, alpha) estimates
    device: Any = None  # None = the current CUDA device (raises without one)
    compaction: str = "bucketed"  # "off" = masked full-batch tiers
    simulate_network: bool = False  # sleep each hop's transfer time
    overlap: str = "serial"  # "pipelined" = overlap transfers with compute
    use_kernels: bool | None = None  # None = cfg, then auto
    # One stacked exit decision per tier; the same knob selects the
    # branch-head pricing mode when ``price_heads`` adds the head term to
    # est_latency_s (priced on H100_SXM).
    heads_batched: bool = True
    price_heads: bool = False
    hint_window: int = 8
    bucket_headroom: float = 0.0
    slots: int = 8  # request-scheduler KV slots (submit/run/drain)
    context_len: int = 4096
    # The fault plane (serving.faults): a seeded LinkFaultModel arms hop
    # faults, breaker-gated retries and exit-head degradation; hop_policy
    # sets the retry, timeout and breaker knobs.
    fault_model: Any = None
    hop_policy: Any = None
    # A DeviceMesh (and optionally an explicit ShardingPolicy): the segments
    # run sharded over it (serving.tiers, "Mesh-sharded tier segments").
    # Which tier is priced as sharded is each TierSpec's ``devices`` /
    # ``ici_bps``, carried into the segments and the estimate.
    mesh: Any = None
    sharding: Any = None

    def __post_init__(self):
        self.tiers = tuple(self.tiers)
        self.cuts = self._checked(self.cuts)
        self.executor = TierExecutor(
            self.cfg, self.params, self._segments(self.cuts),
            compaction=self.compaction, use_kernels=self.use_kernels,
            batched_heads=self.heads_batched, hint_window=self.hint_window,
            bucket_headroom=self.bucket_headroom, device=self.device,
            simulate_network=self.simulate_network, overlap=self.overlap,
            fault_model=self.fault_model, hop_policy=self.hop_policy,
            mesh=self.mesh, sharding=self.sharding,
        )
        self.device = self.executor.device
        self.params = self.executor.params

    @classmethod
    def from_plan(
        cls,
        cfg: ModelConfig,
        params: Any,
        plan: MultiTierPlan,
        tiers: Sequence[TierSpec],
        cost: tuple[np.ndarray, np.ndarray] | None = None,
        **kwargs,
    ) -> "MultiTierServer":
        return cls(cfg, params, tiers, plan.cut_after, cost, **kwargs)

    def _checked(self, cuts: Sequence[int]) -> tuple[int, ...]:
        cuts = tuple(int(c) for c in cuts)
        if len(cuts) != len(self.tiers) - 1:
            raise ValueError(
                f"{len(self.tiers)} tiers need {len(self.tiers) - 1} cuts, "
                f"got {cuts}"
            )
        return cuts

    def _segments(self, cuts: tuple[int, ...]):
        return segments_for_cuts(self.cfg, cuts,
                                 names=tuple(t.name for t in self.tiers),
                                 uplinks=tuple(t.uplink_bps for t in self.tiers),
                                 devices=tuple(t.devices for t in self.tiers))

    def install_cuts(self, cuts: Sequence[int]) -> None:
        """Move the hop points at run time."""
        cuts = self._checked(cuts)
        if cuts != self.cuts:
            self.executor.install(self._segments(cuts))
            self.cuts = cuts

    # ------------------------------------------------------------------
    def step(self, tok: torch.Tensor, pos, caches: dict, *, active=None
             ) -> tuple[MultiTierStepReport, dict]:
        res, caches = self.executor.step(tok, pos, caches, active=active)
        rep = MultiTierStepReport(
            tokens=res.tokens,
            exit_tier=res.exit_tier,
            exited=res.exited,
            shipped_per_hop=res.shipped_per_hop,
            bytes_per_hop=res.bytes_per_hop,
            transfer_s_per_hop=tuple(
                transfer_seconds(nb, self.tiers[j].uplink_bps)
                for j, nb in enumerate(res.bytes_per_hop)
            ),
            est_latency_s=self._estimate(res),
            compaction=res.compaction,
            branch_take=res.branch_take,
            branch_probe_mask=res.branch_probe_mask,
            sim_transfer_s=res.sim_transfer_s,
            overflow_retries=self.executor.overflow_retries,
            pipeline_fallbacks=self.executor.pipeline_fallbacks,
            live=res.live,
            tier_result=res,
            degraded=res.degraded,
            failed=res.failed,
            fault_events=res.fault_events,
            degraded_hop=res.degraded_hop,
        )
        return rep, caches

    def _estimate(self, res: TierStepResult) -> float | None:
        """Lattice cost model (core.multitier) at the installed cuts with
        the *measured* per-branch exit fractions substituted for p.  When
        the runtime compacts, the estimate uses the bucketed cost so it is
        honest about padding waste; when it pipelines, the overlap cost so
        it reports the steady-state bottleneck stage.  The step's live
        width feeds the occupancy term under continuous batching."""
        if self.cost is None:
            return None
        t_c, alpha = self.cost
        p = np.zeros(len(t_c))
        batch = res.tokens.shape[0]
        live = res.live or batch
        for layer, prob in measured_exit_probs(res).items():
            p[layer] = prob
        bucketed = self.compaction == "bucketed"
        head_cost = (
            branch_head_cost(self.cfg, batch, heads_batched=self.heads_batched,
                             hardware=H100_SXM)
            if self.price_heads else None
        )
        return expected_time_multitier(
            t_c, alpha, p, list(self.tiers), self.cuts,
            batch=batch if bucketed else None,
            overlap=self.overlap == "pipelined",
            occupancy=live / batch if bucketed else None,
            head_cost=head_cost,
            branch_layers=self.cfg.branch_layers,
        )
