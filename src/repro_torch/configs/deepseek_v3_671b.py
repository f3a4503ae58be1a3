"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA + 1 shared / 256 routed top-8
MoE + MTP.  First 3 layers dense (d_ff 18432), remaining 58 MoE with
per-expert hidden 2048."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA ignores kv heads; kept for bookkeeping
    head_dim=128,
    d_ff=18432,  # dense first-k layers
    vocab_size=129280,
    use_mla=True,
    mla_kv_rank=512,
    mla_q_rank=1536,
    mla_rope_dim=64,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=3,
    use_mtp=True,
    branch_layers=(15, 30, 45),
    # Sharding knobs, carried as data: the port has no mesh yet.
    fsdp=True,
    fsdp_axes=("pod", "data"),
    optimizer="adafactor",
    grad_accum=16,
    param_dtype="bfloat16",
    accum_dtype="bfloat16",
    moe_fsdp_dim="ff",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        mla_kv_rank=64,
        mla_q_rank=96,
        mla_rope_dim=16,
        num_experts=4,
        experts_per_token=2,
        num_shared_experts=1,
        moe_d_ff=128,
        first_k_dense=1,
        branch_layers=(1,),
        fsdp=False,
        grad_accum=1,
        remat=False,
    )
