"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts, top-8, GQA kv=4."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,  # all layers MoE
    vocab_size=151936,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    branch_layers=(12, 24, 36),
    fsdp=True,
    grad_accum=8,
    decode_qhd_shard=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        moe_d_ff=128,
        branch_layers=(1,),
        fsdp=False,
        remat=False,
    )
