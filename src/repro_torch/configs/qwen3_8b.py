"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk_norm."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    branch_layers=(9, 18, 27),
    grad_accum=16,
    decode_qhd_shard=True,  # a sharding knob: the port reads none
    param_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        branch_layers=(1,),
        remat=False,
    )
