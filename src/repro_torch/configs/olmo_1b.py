"""OLMo-1B [arXiv:2402.00838] — dense with non-parametric LayerNorm."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    source="arXiv:2402.00838",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric_ln",
    tie_embeddings=True,
    branch_layers=(4, 8, 12),
    grad_accum=2,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        branch_layers=(1,),
        remat=False,
    )
