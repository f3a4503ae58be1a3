"""InternVL2-76B [arXiv:2404.16821] — InternViT (stubbed) + InternLM2-76B
language decoder.  input_specs provides pre-projected patch embeddings."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    num_patches=1024,
    branch_layers=(20, 40, 60),
    fsdp=True,
    fsdp_axes=("pod", "data"),
    optimizer="adafactor",
    grad_accum=8,
    seq_shard_activations=True,
    param_dtype="bfloat16",
    accum_dtype="bfloat16",
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
        d_ff=512,
        vocab_size=512,
        num_patches=8,
        branch_layers=(1,),
        fsdp=False,
        grad_accum=1,
        remat=False,
    )
