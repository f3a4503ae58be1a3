"""Mamba2-130M [arXiv:2405.21060] — attention-free SSM (SSD)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_num_heads=24,  # expand*d / head_dim = 1536 / 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    tie_embeddings=True,
    branch_layers=(6, 12, 18),
    grad_accum=2,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=128,
        ssm_state_dim=16,
        ssm_num_heads=4,
        ssm_head_dim=64,
        ssm_chunk=16,
        vocab_size=512,
        branch_layers=(1,),
        remat=False,
    )
