"""Model/run configuration system of the PyTorch port.

The port keeps its own copy of the reference package's configuration
dataclass (``repro.configs.base``): the fields are identical, so a config
built by either package converts to the other with
``ModelConfig(**dataclasses.asdict(cfg))``.  Every architecture of the
reference is registered (``ARCH_IDS``); each has a module in this package
exporting ``CONFIG`` (the published configuration, cited) and
``smoke_config()`` (a reduced variant for CPU tests).

``use_kernels`` in the port reads: None = hand-written Hopper kernels on a
CUDA device (raising on one that is not sm_90), plain PyTorch versions on
the CPU; True = kernels or raise; False = plain versions everywhere.
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = [
    "ModelConfig",
    "ARCH_IDS",
    "get_config",
    "get_smoke_config",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # citation (arXiv id / model card)
    # --- trunk --------------------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    vocab_size: int = 0
    mlp_type: str = "swiglu"  # swiglu | gelu
    # --- attention ----------------------------------------------------------
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False  # Qwen3
    sliding_window: int = 0  # 0 = full attention; >0 = window size
    # MLA (DeepSeek-V3): latent KV compression + decoupled RoPE dims.
    use_mla: bool = False
    mla_kv_rank: int = 512
    mla_q_rank: int = 1536
    mla_rope_dim: int = 64
    # --- normalization ------------------------------------------------------
    norm_type: str = "rmsnorm"  # rmsnorm | nonparametric_ln (OLMo)
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    first_k_dense: int = 0  # DeepSeek-V3: first layers stay dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3
    use_mtp: bool = False  # DeepSeek-V3 multi-token prediction head
    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_num_groups: int = 1
    # --- hybrid (Zamba2) ------------------------------------------------------
    attn_every: int = 0  # shared attention block every k trunk layers
    # --- encoder-decoder (Whisper) --------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # Whisper: 30 s audio -> 1500 frames post-conv
    # --- modality frontend (stubbed per spec) ---------------------------------
    frontend: str = "none"  # none | audio | vision
    num_patches: int = 0  # VLM: visual tokens prepended to the text sequence
    # --- BranchyNet (the paper's technique) -----------------------------------
    branch_layers: tuple[int, ...] = ()  # 1-based trunk indices carrying exits
    branch_loss_weight: float = 0.3  # joint-training weight per branch
    exit_threshold: float = 0.5  # normalized-entropy exit threshold
    # --- serving --------------------------------------------------------------
    # Decode hot path: dispatch to the hand-written Hopper kernels
    # (flash_decode, ssd_update, ssd_scan, fused entropy-exit+argmax)?  None = auto: kernels on
    # a CUDA device, plain PyTorch versions on CPU tensors; asking for the
    # kernels anywhere but a CUDA sm_90 device raises.  Serving
    # constructors can override.
    use_kernels: bool | None = None
    # --- numerics / training ---------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # bfloat16 for the >100B configs (16 GB/chip)
    accum_dtype: str = "float32"  # grad-accumulation buffer dtype
    tie_embeddings: bool = False
    grad_accum: int = 1
    optimizer: str = "adamw"  # adamw | adafactor
    remat: bool = True
    # Shard the seq dim of remat-saved residual carries over "model"
    # (Megatron-style sequence parallelism for activation memory).
    seq_shard_activations: bool = False
    # --- sharding knobs: kept so the fields match the reference's; the port
    # --- has no mesh yet and reads none of them ------------------------------
    fsdp: bool = False
    fsdp_axes: tuple[str, ...] = ("data",)
    expert_parallel: bool = False
    decode_qhd_shard: bool = False
    moe_fsdp_dim: str = "d"  # "d" | "ff"

    # ------------------------------------------------------------------ helpers
    @property
    def padded_vocab_size(self) -> int:
        """Embedding/unembedding table rows: a vocabulary that divides
        neither 256 nor 16 is padded up to a multiple of 256 (the
        reference's sharding rule).  Pad logits are masked to -1e30."""
        if self.vocab_size % 256 == 0 or self.vocab_size % 16 == 0:
            return self.vocab_size
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model


ARCH_IDS: tuple[str, ...] = ("phi3_mini_3_8b", "mamba2_130m", "zamba2_1_2b",
                             "qwen3_8b", "olmo_1b", "phi3_medium_14b",
                             "internvl2_76b", "qwen3_moe_30b_a3b",
                             "deepseek_v3_671b", "whisper_medium")

_ALIAS = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen3-8b": "qwen3_8b",
    "olmo-1b": "olmo_1b",
    "phi3-medium-14b": "phi3_medium_14b",
    "internvl2-76b": "internvl2_76b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "whisper-medium": "whisper_medium",
}


def _module(arch: str):
    arch = _ALIAS.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"the port does not run {arch!r} yet; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
