"""Synthetic data pipeline — counterpart of ``repro.data.pipeline``.

Deterministic, infinite, steppable token streams for training and serving,
plus the distortion transform of the calibration experiment (the paper
blurs images to move branch entropy; on a language model the analog is
Gaussian noise on the embeddings, Fig. 6).

:func:`make_batch` is the reference's numpy code, verbatim: a batch from
either package is bitwise the other's.  :func:`distort_embeddings` draws
from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["SyntheticLM", "make_batch", "distort_embeddings", "DistortionLevel",
           "DISTORTIONS"]


@dataclasses.dataclass(frozen=True)
class DistortionLevel:
    """Analog of the paper's Gaussian-blur severities (Sec. VI, Fig. 6)."""

    name: str
    noise_std: float


DISTORTIONS = {
    "low": DistortionLevel("low", 0.1),
    "mid": DistortionLevel("mid", 0.5),
    "high": DistortionLevel("high", 2.0),
}


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0) -> dict:
    """One batch of the shape ``forward_train`` expects, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    if cfg.frontend == "vision":
        text = seq - cfg.num_patches
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, text), dtype=np.int32)
        out["patch_embeds"] = rng.normal(0, 1, (batch, cfg.num_patches, cfg.d_model)).astype(
            np.float32
        )
        out["labels"] = out["tokens"]
    elif cfg.frontend == "audio":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
        out["frame_embeds"] = rng.normal(
            0, 1, (batch, cfg.encoder_seq_len, cfg.d_model)
        ).astype(np.float32)
        out["labels"] = out["tokens"]
    else:
        # Markov-ish synthetic text: mixture of a few token patterns so the
        # loss actually decreases during the example training runs.
        base = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
        period = max(2, cfg.vocab_size // 97)
        pattern = (np.arange(seq)[None, :] * 7 + rng.integers(0, period, (batch, 1))) % min(
            97, cfg.vocab_size
        )
        use_pat = rng.random((batch, seq)) < 0.7
        out["tokens"] = np.where(use_pat, pattern, base).astype(np.int32)
        out["labels"] = out["tokens"]
    return out


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield make_batch(self.cfg, self.batch, self.seq, self.seed + i)
            i += 1


def distort_embeddings(generator: torch.Generator, embeds: torch.Tensor,
                       level: DistortionLevel) -> torch.Tensor:
    """The paper's image-quality knob, applied to the embedding stub:
    heavier noise -> flatter branch posteriors -> lower exit probability.
    ``generator`` lives on ``embeds``' device."""
    noise = torch.randn(embeds.shape, generator=generator, dtype=torch.float32,
                        device=embeds.device) * level.noise_std
    return embeds + noise.to(embeds.dtype)
