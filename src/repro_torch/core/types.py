"""Core datatypes for BranchyNet partitioning (Pacheco & Couto, ISCC 2020)
— counterpart of ``repro.core.types``, numpy only.

The control plane works on a *cost profile* of a chain DNN:

  * ``N`` main-branch layers ``v_1 .. v_N`` (vertex ``v_0`` is the virtual
    *input*; index 0 in the arrays below is the raw input sample).
  * side branches ``b_k`` attached after main layers (``branch_after[j]`` is
    the 1-based index of the main layer whose output feeds branch ``j``).
  * per-layer cloud compute times ``t_c`` and output sizes ``alpha`` (bytes);
    edge times are ``t_e = gamma * t_c`` exactly as in the paper (Sec. VI).
  * per-branch conditional exit probabilities ``p`` (paper Sec. IV-C).

All arrays are plain numpy on the control plane; the vectorized solver
(:mod:`repro_torch.core.shortest_path`) mirrors them in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "NetworkProfile",
    "UPLINK_PRESETS",
    "BranchSpec",
    "CostProfile",
    "PartitionPlan",
]


@dataclasses.dataclass(frozen=True)
class NetworkProfile:
    """A link between the edge tier and the cloud tier."""

    name: str
    bandwidth_bps: float  # bits per second (paper uses Mbps uplink rates)
    latency_s: float = 0.0  # fixed RTT component (0 in the paper)

    def transfer_time(self, nbytes: float | np.ndarray) -> np.ndarray:
        """t_net = alpha / B (paper Sec. IV-C), plus optional fixed latency."""
        return np.asarray(nbytes) * 8.0 / self.bandwidth_bps + self.latency_s


#: Average uplink rates used in the paper's evaluation (Sec. VI, from DADS),
#: and the links between H100s (beyond-paper).
UPLINK_PRESETS = {
    "3g": NetworkProfile("3g", 1.10e6),
    "4g": NetworkProfile("4g", 5.85e6),
    "wifi": NetworkProfile("wifi", 18.80e6),
    # NVLink 4 between two H100 SXM5 GPUs of one host: 900 GB/s total, 450 GB/s
    # per direction (NVIDIA H100 Tensor Core GPU datasheet).
    "nvlink4": NetworkProfile("nvlink4", 450e9 * 8),
    # One 400 Gb/s NDR InfiniBand port between hosts (NVIDIA ConnectX-7
    # adapter datasheet).
    "ndr400": NetworkProfile("ndr400", 400e9),
}


@dataclasses.dataclass(frozen=True)
class BranchSpec:
    """Side branch ``b_k`` placed after main-branch layer ``after_layer``."""

    after_layer: int  # 1-based index into the main branch
    exit_prob: float  # conditional p_k = P[exit at b_k | reached b_k]
    compute_time_cloud: float = 0.0  # t_{b_k}^c; the paper neglects this

    def __post_init__(self):
        if not (0.0 <= self.exit_prob <= 1.0):
            raise ValueError(f"exit_prob must be in [0,1], got {self.exit_prob}")
        if self.after_layer < 1:
            raise ValueError("branches attach after main layer >= 1")


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """Everything the partitioner needs to know about one (model, HW, net).

    ``t_c[i]`` / ``alpha[i]`` are indexed by main-branch layer ``i`` in
    ``1..N`` with slot 0 describing the raw input: ``alpha[0]`` is the raw
    sample size (upload cost of cloud-only processing) and ``t_c[0] == 0``.
    """

    t_c: np.ndarray  # (N+1,) cloud per-layer time, [0] == 0
    alpha: np.ndarray  # (N+1,) output bytes per layer, [0] == raw input bytes
    branches: tuple[BranchSpec, ...]
    gamma: float  # t_e = gamma * t_c (paper Sec. VI)
    network: NetworkProfile
    # Paper-faithful mode ignores side-branch compute time (Eq. 5). Setting
    # this True adds t_b^{e} = gamma * compute_time_cloud at each edge branch.
    include_branch_compute: bool = False
    layer_names: tuple[str, ...] | None = None  # (N+1,), [0] == "input"

    def __post_init__(self):
        t_c = np.asarray(self.t_c, dtype=np.float64)
        alpha = np.asarray(self.alpha, dtype=np.float64)
        object.__setattr__(self, "t_c", t_c)
        object.__setattr__(self, "alpha", alpha)
        if t_c.shape != alpha.shape or t_c.ndim != 1:
            raise ValueError("t_c and alpha must be 1-D with equal length")
        if t_c[0] != 0.0:
            raise ValueError("t_c[0] is the virtual input layer and must be 0")
        if self.gamma < 1.0:
            raise ValueError("gamma >= 1 (edge is never faster than cloud)")
        n = self.num_layers
        seen = set()
        for b in self.branches:
            if b.after_layer >= n:  # a branch after v_N would be the output
                raise ValueError(f"branch after_layer {b.after_layer} >= N={n}")
            if b.after_layer in seen:
                raise ValueError("at most one branch per main layer")
            seen.add(b.after_layer)
        object.__setattr__(
            self, "branches", tuple(sorted(self.branches, key=lambda b: b.after_layer))
        )

    @property
    def num_layers(self) -> int:
        return int(self.t_c.shape[0]) - 1

    @property
    def t_e(self) -> np.ndarray:
        return self.t_c * self.gamma

    @property
    def t_net(self) -> np.ndarray:
        """t_i^net = alpha_i / B for every potential cut point (incl. input)."""
        return self.network.transfer_time(self.alpha)

    def branch_exit_probs(self) -> np.ndarray:
        """Per-main-layer conditional exit prob (0 where no branch)."""
        p = np.zeros(self.num_layers + 1)
        for b in self.branches:
            p[b.after_layer] = b.exit_prob
        return p

    def survival_after(self) -> np.ndarray:
        """``surv[i]`` = P[sample not yet exited after processing v_i and its
        branch] = prod_{b_k: after_layer <= i} (1 - p_k).  ``surv[0] == 1``."""
        p = self.branch_exit_probs()
        return np.cumprod(1.0 - p)

    def p_Y(self) -> np.ndarray:
        """Paper Eq. 4: unconditional exit prob per branch, aligned with
        ``self.branches`` ordering."""
        out = []
        alive = 1.0
        for b in self.branches:
            out.append(alive * b.exit_prob)
            alive *= 1.0 - b.exit_prob
        return np.asarray(out)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Result of the optimization: process v_1..v_s on the edge, ship
    alpha_s bytes, process v_{s+1}..v_N in the cloud.  s == 0 is cloud-only,
    s == N is edge-only (paper Fig. 2)."""

    split_layer: int
    expected_time_s: float
    edge_layers: tuple[int, ...]
    cloud_layers: tuple[int, ...]
    edge_branches: tuple[int, ...]  # after_layer of branches evaluated on edge
    transfer_bytes: float
    method: str = "dijkstra"

    @property
    def is_cloud_only(self) -> bool:
        return self.split_layer == 0

    @property
    def is_edge_only(self) -> bool:
        return len(self.cloud_layers) == 0

    def describe(self, names: Sequence[str] | None = None) -> str:
        def nm(i: int) -> str:
            return names[i] if names else f"v{i}"

        if self.is_cloud_only:
            where = "cloud-only"
        elif self.is_edge_only:
            where = "edge-only"
        else:
            where = f"split after {nm(self.split_layer)}"
        return (
            f"PartitionPlan[{where}] E[T]={self.expected_time_s * 1e3:.3f} ms, "
            f"tx={self.transfer_bytes / 1024:.1f} KiB, "
            f"edge={len(self.edge_layers)}L+{len(self.edge_branches)}b, "
            f"cloud={len(self.cloud_layers)}L"
        )
