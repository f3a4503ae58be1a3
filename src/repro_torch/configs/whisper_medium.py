"""Whisper-medium [arXiv:2212.04356] — encoder-decoder; the conv/mel
frontend is a stub (prompts carry post-conv frame embeddings), as in the
reference.  Norms are RMSNorm in place of Whisper's LayerNorm, as in the
reference."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=24,  # decoder
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    mlp_type="gelu",
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    frontend="audio",
    branch_layers=(6, 12, 18),
    grad_accum=8,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        num_encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        encoder_seq_len=32,
        branch_layers=(1,),
        remat=False,
    )
