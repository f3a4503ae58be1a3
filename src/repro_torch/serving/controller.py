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
arrivals over the covered rows only.  A server running
``overlap="pipelined"`` is re-solved against the pipeline's bottleneck
stage (``overlap=True`` in ``core.multitier``): the best cut can move when
transfers overlap compute.

Hop health (the fault plane): ``observe`` folds each step's
``fault_events`` and ``degraded_hop`` into per-hop EWMAs — availability
(the success fraction of *attempted* hops) and the simulated transfer
seconds of successful shipments — and on a breaker opening or closing
re-solves at once with each hop's ``TierSpec.availability`` from the EWMA
(0 for an open breaker, which the solver prices as an unusable link), so
the cut moves off the sick hop (``fault_resolves`` counts these).  A hop
the breaker skipped is not an observation, and a failed half-open probe
moves availability only, never the transfer estimate.
``fault_resolve=False`` keeps the ingestion and leaves the re-solve to
:meth:`RepartitionController.apply_hop_health`.
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
    hop_alpha: float = 0.3  # EWMA weight of a hop-health observation
    fault_resolve: bool = True  # re-solve on a breaker state change

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
        # Per-hop health by hop index (a tier boundary, stable across
        # repartitions): availability EWMA over attempted hops, transfer
        # seconds EWMA over successful non-empty shipments, open breakers.
        self._hop_avail: dict[int, float] = {}
        self._hop_xfer: dict[int, float] = {}
        self._hop_open: set[int] = set()
        self.fault_resolves = 0

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
        lattice for K>=3; for a 2-tier server the lattice when it
        pipelines, compacts (with ``batch`` set) or its uplink's health is
        below 1, else the paper's Dijkstra.  A pipelined server is solved
        against the bottleneck stage."""
        prof = Partitioner(self.profile).with_exit_probs(p_k).profile
        occ = self._solve_occupancy()
        overlap = self.server.overlap == "pipelined"
        if isinstance(self.server, MultiTierServer):
            plan = solve_multitier(
                prof.t_c, prof.alpha, prof.branch_exit_probs(), self.tiers,
                batch=self.batch, overlap=overlap,
                occupancy=occ if self.batch is not None else None,
            )
            return plan.cut_after
        bucketed = self.batch is not None and self.server.compaction == "bucketed"
        avail = 0.0 if 0 in self._hop_open else self._hop_avail.get(0, 1.0)
        if overlap or bucketed or avail < 1.0:
            # Route through the lattice cost so the installed cut optimizes
            # the objective the server's est_latency_s reports (bottleneck
            # stage under overlap, padding-honest under compaction;
            # branch-head compute aside, as in the paper's Eq. 5); the
            # edge's uplink carries its availability (0 = breaker open,
            # an unusable link: the cut moves to all-edge).
            # A mesh-sharded server's shard widths and interconnect carry
            # into the specs, so a re-solve prices the sharded cloud tier.
            dev = getattr(self.server, "tier_devices", None) or (1, 1)
            ici = getattr(self.server, "ici_bps", 0.0)
            tiers = [TierSpec("edge", prof.gamma, prof.network.bandwidth_bps,
                              devices=dev[0], ici_bps=ici, availability=avail),
                     TierSpec("cloud", 1.0, devices=dev[1], ici_bps=ici)]
            plan = solve_multitier(
                prof.t_c, prof.alpha, prof.branch_exit_probs(), tiers,
                batch=self.batch if bucketed else None, overlap=overlap,
                occupancy=occ if bucketed else None,
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
        fault_cuts = self._ingest_faults(report)
        if fault_cuts is not None:
            # A breaker change re-solved (and reset the drift window): it
            # takes the place of this step's drift check.
            return fault_cuts
        if self.every_n_steps and self._steps_observed % self.every_n_steps == 0:
            return self.maybe_update()
        return None

    # -------------------------------------------------------- hop health
    def _ingest_faults(self, report) -> tuple[int, ...] | None:
        """Fold one step's fault-plane outputs into the per-hop EWMAs and
        re-solve on a breaker state change.  Only attempted hops are
        observations: a breaker-skipped hop and the hops past the broken
        one are not.  Transfer seconds come from successful non-empty
        shipments only."""
        events = getattr(report, "fault_events", None) or ()
        broken = getattr(report, "degraded_hop", None)
        if not events and broken is None:
            return None
        skipped = {e.hop for e in events if e.kind == "breaker_skip"}
        failed_hops = {e.hop for e in events if e.kind == "exhausted"}
        nb = getattr(report, "bytes_per_hop", ()) or ()
        sim = getattr(report, "sim_transfer_s", ()) or ()
        a = self.hop_alpha
        for j in range(len(nb)):
            if j in skipped or (broken is not None and j > broken):
                continue  # not attempted: no observation
            ok = j not in failed_hops
            self._hop_avail[j] = (1.0 - a) * self._hop_avail.get(j, 1.0) + a * ok
            if ok and float(nb[j]) > 0 and j < len(sim) and sim[j] > 0:
                prev = self._hop_xfer.get(j)
                self._hop_xfer[j] = (float(sim[j]) if prev is None
                                     else (1.0 - a) * prev + a * float(sim[j]))
        resolve = False
        for e in events:
            if e.kind == "breaker_open" and e.hop not in self._hop_open:
                self._hop_open.add(e.hop)
                resolve = True
            elif e.kind == "breaker_closed" and e.hop in self._hop_open:
                self._hop_open.discard(e.hop)
                # The link recovered: price it healthy, not at the EWMA
                # tail of the outage.
                self._hop_avail[e.hop] = 1.0
                resolve = True
        if resolve and self.fault_resolve:
            return self.apply_hop_health()
        return None

    def hop_health(self) -> dict[int, dict[str, float | bool | None]]:
        """Per hop: availability EWMA, transfer-seconds EWMA (None before a
        successful shipment), and whether its breaker is open."""
        hops = set(self._hop_avail) | set(self._hop_xfer) | self._hop_open
        return {j: {"availability": self._hop_avail.get(j, 1.0),
                    "transfer_s": self._hop_xfer.get(j),
                    "open": j in self._hop_open}
                for j in sorted(hops)}

    def apply_hop_health(self) -> tuple[int, ...]:
        """Re-solve with each hop's availability from the health EWMAs (0
        for an open breaker) and install the result.  K>=3 goes through
        :meth:`update_tiers` (the drift window resets); a 2-tier server's
        availability reaches the solve through the lattice route of
        :meth:`solve`.  Once the cut leaves a sick hop its breaker is never
        probed again: recovery needs an explicit ``update_tiers``."""
        self.fault_resolves += 1
        if isinstance(self.server, MultiTierServer):
            last = len(self.tiers) - 1
            return self.update_tiers([
                dataclasses.replace(t, availability=(
                    0.0 if j in self._hop_open
                    else self._hop_avail.get(j, t.availability)))
                if j < last else t
                for j, t in enumerate(self.tiers)])
        return self._install(self._best_p())

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
        self.server.network = network
        if self.server.cost_profile is not None:
            self.server.cost_profile = self.profile
        cuts = self._install(self._best_p())
        # Refresh the segments even when the cut did not move: the new
        # uplink must reach the executor's link accounting (every cached
        # segment function is reused).
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
