"""Input specs for every (arch x input shape) — counterpart of
``repro.launch.specs``.

A spec is a tensor on the ``meta`` device: its shape and dtype, no memory
behind it (the reference's ``jax.ShapeDtypeStruct``).  ``long_500k`` swaps
in the sub-quadratic config variant (a sliding window for the attention
trunks; an SSM's state is O(1) natively); Whisper skips it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import InputShape, ModelConfig

__all__ = [
    "LONG_CONTEXT_WINDOW",
    "shape_supported",
    "config_for_shape",
    "train_batch_specs",
    "prefill_input_specs",
    "decode_input_specs",
    "cache_specs",
    "param_specs",
]

LONG_CONTEXT_WINDOW = 8192


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported?, reason-if-not)."""
    if shape.name == "long_500k" and cfg.arch_type == "audio":
        return False, (
            "enc-dec ASR decoder has a hard cross-attention context (1500 "
            "frames); no sub-quadratic self-attention story at 524k tokens "
            "(DESIGN.md Sec. 4 skip)"
        )
    return True, ""


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Long-context decode uses the sliding-window variant for attention
    archs; everything else runs the published config unchanged."""
    if shape.name == "long_500k" and cfg.arch_type != "ssm":
        if cfg.sliding_window == 0:
            cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _token_batch(cfg: ModelConfig, batch: int, seq: int) -> dict:
    out = {}
    if cfg.frontend == "vision":
        text = seq - cfg.num_patches
        assert text > 0, "seq_len must exceed the visual prefix"
        out["tokens"] = _spec((batch, text), torch.int32)
        out["patch_embeds"] = _spec((batch, cfg.num_patches, cfg.d_model), torch.float32)
    elif cfg.frontend == "audio":
        out["tokens"] = _spec((batch, seq), torch.int32)
        out["frame_embeds"] = _spec((batch, cfg.encoder_seq_len, cfg.d_model),
                                    torch.float32)
    else:
        out["tokens"] = _spec((batch, seq), torch.int32)
    return out


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    batch = _token_batch(cfg, shape.global_batch, shape.seq_len)
    batch["labels"] = _spec(batch["tokens"].shape, torch.int32)
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    return _token_batch(cfg, shape.global_batch, shape.seq_len)


def decode_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Specs of (token, pos) of one decode step; the caches come from
    :func:`cache_specs`."""
    return {
        "token": _spec((shape.global_batch, 1), torch.int32),
        "pos": _spec((), torch.int32),
    }


def cache_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The cache tree at the shape's batch and length, on ``meta``."""
    from repro_torch.sharding.policy import cache_shapes

    return cache_shapes(cfg, shape.global_batch, shape.seq_len)


def param_specs(cfg: ModelConfig) -> dict:
    """The param tree, on ``meta``."""
    from repro_torch.sharding.policy import param_shapes

    return param_shapes(cfg)
