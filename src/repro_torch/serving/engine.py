"""Batched serving engine with BranchyNet early exits — counterpart of
``repro.serving.engine``.

The engine runs the K=1 configuration of the tier runtime: one
:class:`~repro_torch.serving.tiers.TierExecutor` segment spanning the whole
trunk, every side branch evaluated in place (one stacked exit decision per
step, the Hopper ``entropy_exit_argmax_heads`` kernel on the card).  It
tracks positions and records per-branch exit statistics — the live
measurement that calibrates the partitioner's ``p_k`` (paper Sec. IV-C:
"the probability that a sample is classified at the side branch" is an
input-data property, so a serving system must estimate it online).

Exit masking runs on the device inside the step; the decode loop makes one
host sync per decoded token.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibration import CalibrationResult, calibrate_exit_probs
from repro_torch.models.model import init_caches, prefill
from repro_torch.serving.scheduler import ServesRequests
from repro_torch.serving.tiers import TierExecutor, TierStepResult, segments_for_cuts

__all__ = ["ServingEngine", "ExitStats"]


@dataclasses.dataclass
class ExitStats:
    """Counts of first-exit events per branch across decoded tokens."""

    branch_layers: tuple[int, ...]
    counts: np.ndarray  # (K+1,): per branch + the main head
    entropies: list[np.ndarray]  # per step: (K, B) normalized entropies

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def exit_fractions(self) -> np.ndarray:
        return self.counts / max(self.total, 1)

    def conditional_probs(self) -> np.ndarray:
        """Sequential conditional p_k (what CostProfile consumes)."""
        alive = float(self.total)
        out = []
        for c in self.counts[:-1]:
            out.append(float(c) / alive if alive > 0 else 0.0)
            alive -= float(c)
        return np.asarray(out)

    def calibrate(self, threshold: float) -> CalibrationResult:
        ents = np.concatenate(self.entropies, axis=1)  # (K, steps*B)
        return calibrate_exit_probs(ents, threshold)


@dataclasses.dataclass
class ServingEngine(ServesRequests):
    cfg: ModelConfig
    params: Any
    context_len: int = 4096
    device: Any = None  # None = the current CUDA device (raises without one)
    use_kernels: bool | None = None  # None = cfg, then auto
    heads_batched: bool = True  # one stacked exit decision per step
    slots: int = 8  # request-scheduler KV slots (submit/run/drain)

    def __post_init__(self):
        self._exec = TierExecutor(
            self.cfg, self.params, segments_for_cuts(self.cfg, ()),
            use_kernels=self.use_kernels, batched_heads=self.heads_batched,
            device=self.device,
        )
        self.device = self._exec.device
        self.params = self._exec.params

    @property
    def executor(self) -> TierExecutor:
        return self._exec

    def step(self, tok: torch.Tensor, pos, caches: dict, *, active=None
             ) -> tuple[TierStepResult, dict]:
        """One decode step (the K=1 tier configuration); ``pos`` may be
        per-sequence and ``active`` masks dead request slots — the entry
        points the request scheduler drives."""
        return self._exec.step(tok, pos, caches, active=active)

    def start(self, inputs: dict) -> dict:
        """Prefill a batch of prompts (``inputs["tokens"]``, (B, S));
        returns mutable serve state."""
        tokens = self._exec._upload(inputs["tokens"], torch.int64)
        batch, prompt_len = tokens.shape
        caches = init_caches(self.cfg, batch, self.context_len,
                             device=self.device)
        logits, caches = prefill(self.params, tokens, self.cfg, caches,
                                 use_kernels=self._exec.use_kernels)
        return {
            "caches": caches,
            "pos": prompt_len,
            "last_logits": logits[:, 0],
            "batch": batch,
        }

    def decode(self, state: dict, steps: int) -> tuple[np.ndarray, ExitStats]:
        """Decode ``steps`` greedy tokens; returns (tokens (B, steps), exit
        stats).

        A sequence "exits" at the first branch whose normalized entropy
        clears cfg.exit_threshold; its emitted token comes from that branch
        head (BranchyNet inference, paper Sec. III).  ``state["last_logits"]``
        is the last step's own tensor (under CUDA graphs the executor hands
        out a copy of the graph's output).
        """
        cfg = self.cfg
        k = len(cfg.branch_layers)
        batch = state["batch"]
        counts = np.zeros(k + 1, dtype=np.int64)
        ents_log: list[np.ndarray] = []
        toks_out = []

        tok = state["last_logits"].argmax(-1).to(torch.int32)[:, None]
        caches = state["caches"]
        pos = state["pos"]
        for _ in range(steps):
            res, caches = self._exec.step(tok, pos, caches)
            pos += 1
            for j, layer in enumerate(cfg.branch_layers):
                counts[j] += int(res.branch_take[layer].sum())
            counts[k] += int((~res.exited).sum())
            ents_log.append(
                np.stack([res.branch_entropy[l] for l in cfg.branch_layers])
                if k else np.zeros((0, batch))
            )
            toks_out.append(res.tokens)
            tok = res.tokens_dev[:, None]

        state["caches"] = caches
        state["pos"] = pos
        state["last_logits"] = res.last_logits
        return np.stack(toks_out, axis=1), ExitStats(
            cfg.branch_layers, counts, ents_log
        )

    @property
    def host_syncs(self) -> int:
        """Device->host syncs performed by decode steps so far."""
        return self._exec.host_syncs
