"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 trunk + shared attention block."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,  # shared attention block
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,  # shared block MLP
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_num_heads=64,  # 2*2048 / 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    attn_every=6,  # shared block after layers 6,12,...,36
    branch_layers=(9, 19, 29),
    grad_accum=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        ssm_state_dim=16,
        ssm_num_heads=4,
        ssm_chunk=16,
        vocab_size=512,
        attn_every=1,
        branch_layers=(1,),
        remat=False,
    )
