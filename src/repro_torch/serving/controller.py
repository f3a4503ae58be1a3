"""Repartition controller: live exit statistics -> solver -> hot swap —
counterpart of ``repro.serving.controller`` (the paper's Sec. IV-C loop).

Exit probabilities are an input-data property, so the deployment
estimates them online and re-runs the partition optimizer whenever they
(or the network) drift:

    ExitStats.conditional_probs() -> Partitioner / solve_multitier
        -> PartitionedServer.set_split / MultiTierServer.install_cuts

Triggers:

  * **explicit** — ``update(stats)`` re-solves unconditionally;
  * **drift** — ``observe(report)`` (a ``RequestScheduler.on_step``
    callback, or called per step) accumulates per-branch arrivals and
    exits over live rows; every ``every_n_steps`` steps it re-solves when
    the KL divergence between the measured and the installed exit
    distributions exceeds ``kl_threshold`` (``None`` = on every check);
  * **network** — ``update_network(profile)`` / ``update_tiers(specs)``
    re-solve with the last measured probabilities when the link changes.

A swap goes through ``TierExecutor.install``, which reuses the cached
segment function (and on the card its captured graphs) of every segment
whose key is unchanged.  With ``batch`` set and a compacting server, K=2
and K>=3 solves price the bucketed lattice cost (``core.multitier``);
``occupancy`` (or the decaying estimate ``observe`` keeps from the live
width) prices the steady-state live batch.  ``explore_every_n`` schedules
probe steps (every branch head evaluated, report-only) so branches the
plan discards keep measured probabilities; ``probe_sample_frac`` samples
them on part of the batch, and ``observe`` counts a probed branch's
arrivals over the covered rows only.

Not ported yet (see ROADMAP.md): hop health — the fault plane's per-hop
EWMAs, ``hop_health`` / ``apply_hop_health`` and the re-solve on a
breaker change (``_ingest_faults``, ``fault_resolves``) — waits for the
fault plane; the pipeline-bottleneck re-solve of an
``overlap="pipelined"`` server waits for pipelined overlap.  The link
reaches the port's 2-tier server through its cost profile
(``update_network`` replaces it); ``PartitionedServer.network`` and the
segment uplinks come with link simulation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.multitier import TierSpec, solve_multitier
from repro_torch.core.partitioner import Partitioner
from repro_torch.core.types import CostProfile, NetworkProfile
from repro_torch.serving.engine import ExitStats
from repro_torch.serving.multitier import MultiTierServer
from repro_torch.serving.partitioned import PartitionedServer

__all__ = ["RepartitionController", "exit_distribution", "exit_drift_kl"]


def exit_distribution(p_k: np.ndarray) -> np.ndarray:
    """Conditional per-branch exit probs -> categorical distribution over
    (exit at branch 1, ..., exit at branch K, reach the main head)."""
    p_k = np.asarray(p_k, float)
    out = np.empty(len(p_k) + 1)
    alive = 1.0
    for j, p in enumerate(p_k):
        out[j] = alive * p
        alive *= 1.0 - p
    out[-1] = alive
    return out


def exit_drift_kl(
    measured_p: np.ndarray, installed_p: np.ndarray, eps: float = 1e-6
) -> float:
    """KL(measured || installed) between the two exit distributions."""
    m = exit_distribution(measured_p) + eps
    q = exit_distribution(installed_p) + eps
    m /= m.sum()
    q /= q.sum()
    return float(np.sum(m * np.log(m / q)))


@dataclasses.dataclass
class RepartitionController:
    """Feeds measured ``p_k`` back through the solver and installs the
    result on a 2-tier or K-tier server."""

    server: PartitionedServer | MultiTierServer
    profile: CostProfile
    tiers: list[TierSpec] | None = None  # default: a MultiTierServer's own
    kl_threshold: float | None = None  # drift gate for observe()-driven solves
    every_n_steps: int = 0  # drift-check cadence (0 = explicit only)
    batch: int | None = None  # bucketed solves (K=2 and K>=3)
    window_steps: int = 256  # drift-window decay horizon
    explore_every_n: int = 0  # probe-step cadence (0 = no exploration)
    probe_sample_frac: float = 1.0  # rows a probe step samples
    occupancy: float | None = None  # None = track the observed live width

    def __post_init__(self):
        if isinstance(self.server, MultiTierServer) and self.tiers is None:
            self.tiers = list(self.server.tiers)
        if not 0.0 < self.probe_sample_frac <= 1.0:
            raise ValueError(
                f"probe_sample_frac must be in (0, 1]: {self.probe_sample_frac}")
        k = len(self.server.cfg.branch_layers)
        # Per-branch (arrivals, exits) over the current window.  A branch
        # the installed plan never evaluates accrues no arrivals, and its
        # probability carries over from the installed estimate.
        self._arrivals = np.zeros(k, np.float64)
        self._exits = np.zeros(k, np.float64)
        self._steps_observed = 0
        self._window_age = 0
        self._installed_p: np.ndarray | None = None
        self._occ_est: float | None = None

    # ------------------------------------------------------------ solving
    def _solve_occupancy(self) -> float | None:
        """The live fraction batched solves price: the explicit
        ``occupancy``, else the observed estimate, else None (nominal)."""
        occ = self.occupancy if self.occupancy is not None else self._occ_est
        if occ is None:
            return None
        return float(min(max(occ, 1e-6), 1.0))

    def solve(self, p_k: np.ndarray) -> tuple[int, ...]:
        """Optimal cut vector for the profile with exit probs ``p_k``: the
        lattice for K>=3, the bucketed lattice for a compacting 2-tier
        server when ``batch`` is set, else the paper's Dijkstra."""
        prof = Partitioner(self.profile).with_exit_probs(p_k).profile
        occ = self._solve_occupancy()
        if isinstance(self.server, MultiTierServer):
            plan = solve_multitier(
                prof.t_c, prof.alpha, prof.branch_exit_probs(), self.tiers,
                batch=self.batch,
                occupancy=occ if self.batch is not None else None,
            )
            return plan.cut_after
        if self.batch is not None and self.server.compaction == "bucketed":
            # Route through the lattice cost so the installed cut optimizes
            # the padding-honest objective the server's est_latency_s
            # reports (branch-head compute aside, as in the paper's Eq. 5).
            tiers = [TierSpec("edge", prof.gamma, prof.network.bandwidth_bps),
                     TierSpec("cloud", 1.0)]
            plan = solve_multitier(
                prof.t_c, prof.alpha, prof.branch_exit_probs(), tiers,
                batch=self.batch, occupancy=occ,
            )
            return plan.cut_after
        return (Partitioner(prof).solve().split_layer,)

    def _install(self, p_k: np.ndarray) -> tuple[int, ...]:
        cuts = self.solve(p_k)
        self._installed_p = np.asarray(p_k, float)
        # Drift is judged against the traffic seen under the new plan.
        self._arrivals[:] = 0
        self._exits[:] = 0
        self._window_age = 0
        if isinstance(self.server, MultiTierServer):
            self.server.install_cuts(cuts)
            return self.server.cuts
        self.server.set_split(cuts[0])
        return (self.server.split_layer,)

    def update(self, stats: ExitStats) -> tuple[int, ...]:
        """Re-solve from live stats and hot-swap the split if it moved.
        Returns the installed cut vector."""
        return self._install(stats.conditional_probs())

    # ----------------------------------------------------- drift detection
    def observe(self, report) -> tuple[int, ...] | None:
        """Accumulate one step's exit outcome (any report carrying
        ``branch_take`` and ``tokens``); every ``every_n_steps`` observed
        steps, re-solve if the measured distribution drifted past
        ``kl_threshold``.  Returns the new cuts when a swap happened.

        Dead slots (``active``) never count as arrivals, and the live
        width feeds the occupancy estimate.  A sampled probe's branch
        counts arrivals over its covered rows (``branch_probe_mask``)
        only."""
        batch = report.tokens.shape[0]
        active = getattr(report, "active", None)
        alive = (np.ones((batch,), bool) if active is None
                 else np.asarray(active, bool).copy())
        probe_cover = getattr(report, "branch_probe_mask", {}) or {}
        for j, layer in enumerate(self.server.cfg.branch_layers):
            take = report.branch_take.get(layer)
            if take is None:
                continue  # not evaluated under this plan (nor probed)
            cover = probe_cover.get(layer)
            counted = alive if cover is None else (alive & cover)
            self._arrivals[j] += float(counted.sum())
            # A probed earlier branch's would-exit rows have left `alive`,
            # but a later kept branch's take was computed under plan
            # semantics: count its exits among the rows still alive.
            self._exits[j] += float((take & counted).sum())
            alive &= ~take
        live = getattr(report, "live", None)
        if live:
            occ = live / batch
            self._occ_est = (occ if self._occ_est is None
                             else 0.9 * self._occ_est + 0.1 * occ)
        self._steps_observed += 1
        self._window_age += 1
        if self.explore_every_n and self._steps_observed % self.explore_every_n == 0:
            self.server.executor.probe_next = True
            self.server.executor.probe_sample_frac = self.probe_sample_frac
        if self._window_age >= self.window_steps:
            # Halve the window so the measurement tracks regime changes.
            self._arrivals *= 0.5
            self._exits *= 0.5
            self._window_age = 0
        if self.every_n_steps and self._steps_observed % self.every_n_steps == 0:
            return self.maybe_update()
        return None

    def measured_probs(self) -> np.ndarray:
        """Conditional p_k per branch from the observed window; a branch
        with no observed arrivals keeps the installed estimate."""
        out = []
        for j in range(len(self._arrivals)):
            if self._arrivals[j] > 0:
                out.append(self._exits[j] / self._arrivals[j])
            elif self._installed_p is not None:
                out.append(float(self._installed_p[j]))
            else:
                out.append(0.0)
        return np.asarray(out)

    def drift_kl(self) -> float:
        """KL between measured and installed exit distributions (+inf
        before the first install through this controller)."""
        if self._installed_p is None:
            return float("inf")
        return exit_drift_kl(self.measured_probs(), self._installed_p)

    def maybe_update(self, force: bool = False) -> tuple[int, ...] | None:
        """Re-solve from the observed counts if drift warrants it."""
        if self._arrivals.sum() == 0:
            return None  # nothing observed under this plan yet
        if not (force or self.kl_threshold is None
                or self.drift_kl() > self.kl_threshold):
            return None
        return self._install(self.measured_probs())

    # ------------------------------------------------------ network drift
    def update_network(self, network: NetworkProfile) -> tuple[int, ...]:
        """The 2-tier link changed: re-solve with the last measured (or
        installed) exit probs against the new bandwidth."""
        if not isinstance(self.server, PartitionedServer):
            raise TypeError("update_network is 2-tier; use update_tiers for K>=3")
        self.profile = dataclasses.replace(self.profile, network=network)
        if self.server.cost_profile is not None:
            self.server.cost_profile = self.profile
        cuts = self._install(self._best_p())
        # A topology change restarts the executor's plan (as the reference's
        # segment refresh does), reusing every cached segment function.
        self.server.executor.install(self.server._segments(self.server.split_layer))
        return cuts

    def update_tiers(self, tiers: list[TierSpec]) -> tuple[int, ...]:
        """K>=3 tier topology / uplinks changed: re-solve and hot-swap."""
        if not isinstance(self.server, MultiTierServer):
            raise TypeError("update_tiers is K>=3; use update_network for 2-tier")
        self.tiers = list(tiers)
        self.server.tiers = tuple(tiers)
        cuts = self._install(self._best_p())
        self.server.executor.install(self.server._segments(self.server.cuts))
        return cuts

    def _best_p(self) -> np.ndarray:
        """Most recent exit-prob estimate: measured > installed > zeros."""
        if self._arrivals.sum() > 0:
            return self.measured_probs()
        if self._installed_p is not None:
            return self._installed_p
        return np.zeros(len(self.server.cfg.branch_layers))
