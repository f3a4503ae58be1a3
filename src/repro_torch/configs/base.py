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
from typing import Iterable

__all__ = [
    "ModelConfig",
    "InputShape",
    "INPUT_SHAPES",
    "ARCH_IDS",
    "all_configs",
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

    def attn_matmul_params(self) -> int:
        """Matmul parameters of one attention block (GQA or MLA) — the
        single source for num_params/active_params and the serving
        benchmarks' per-row decode FLOPs (2 FLOPs per MAC)."""
        d = self.d_model
        if self.arch_type not in ("dense", "moe", "vlm", "audio", "hybrid"):
            return 0
        if self.use_mla:
            return (
                d * self.mla_q_rank
                + self.mla_q_rank * self.num_heads * self.head_dim
                + d * (self.mla_kv_rank + self.mla_rope_dim)
                + self.mla_kv_rank * self.num_heads * (self.head_dim + self.head_dim)
                + self.num_heads * self.head_dim * d
            )
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def dense_mlp_matmul_params(self) -> int:
        """Matmul parameters of one dense MLP block."""
        return (3 if self.mlp_type == "swiglu" else 2) * self.d_model * self.d_ff

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + trunk), for roofline's
        MODEL_FLOPS = 6*N*D and memory budgeting."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        attn = self.attn_matmul_params()
        if self.arch_type == "moe":
            shared = 3 * d * self.moe_d_ff * self.num_shared_experts
            routed = 3 * d * self.moe_d_ff * self.num_experts
            router = d * self.num_experts
            dense_mlp = 3 * d * ff if ff else 0
            n_moe = self.num_layers - self.first_k_dense
            per_layer_moe = attn + shared + routed + router
            per_layer_dense = attn + dense_mlp
            trunk = n_moe * per_layer_moe + self.first_k_dense * per_layer_dense
        elif self.arch_type == "ssm":
            inner = self.ssm_inner
            g = self.ssm_num_groups
            per_layer = (
                d * (2 * inner + 2 * g * self.ssm_state_dim + self.ssm_num_heads)
                + inner * d
            )
            trunk = self.num_layers * per_layer
        elif self.arch_type == "hybrid":
            inner = self.ssm_inner
            g = self.ssm_num_groups
            mamba = (
                d * (2 * inner + 2 * g * self.ssm_state_dim + self.ssm_num_heads)
                + inner * d
            )
            shared_attn = attn + 3 * d * ff  # one shared block, counted once
            trunk = self.num_layers * mamba + shared_attn
        else:
            mlp = self.dense_mlp_matmul_params()
            trunk = self.num_layers * (attn + mlp)
            if self.is_encoder_decoder:
                # encoder layers + decoder cross-attention
                trunk += self.num_encoder_layers * (attn + mlp) + self.num_layers * attn
        return emb + trunk

    def active_params(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.arch_type != "moe":
            return self.num_params()
        d = self.d_model
        attn = self.attn_matmul_params()
        active_mlp = 3 * d * self.moe_d_ff * (
            self.experts_per_token + self.num_shared_experts
        )
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + self.num_layers * (attn + active_mlp + d * self.num_experts)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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


def all_configs() -> Iterable[ModelConfig]:
    for a in ARCH_IDS:
        yield get_config(a)
