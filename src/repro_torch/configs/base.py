"""ModelConfig — one dataclass covering all 10 assigned architecture families.

Every assigned architecture is expressed as a frozen :class:`ModelConfig`;
``src/repro_torch/configs/<arch>.py`` holds the exact published numbers, and each
provides ``smoke()`` — the same family at toy scale for CPU tests.

Families:
  dense     — granite-3-2b, minitron-8b (plain GQA decoder)
  localglobal — gemma3-12b/27b (5:1 sliding-window:global attention)
  hybrid    — zamba2-7b (Mamba2 backbone + periodically-applied shared
              attention block)
  rwkv      — rwkv6-1.6b (attn-free, data-dependent decay)
  encdec    — whisper-medium (audio frontend stubbed to frame embeddings)
  moe       — deepseek-v3-671b (MLA + 1 shared/256 routed top-8 + MTP),
              arctic-480b (dense-residual + 128 routed top-2)
  vlm       — llama-3.2-vision-90b (cross-attention image layers; patch
              embeddings stubbed)
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "localglobal", "hybrid", "rwkv", "encdec", "moe",
                 "vlm"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        """Per-token decode cache: compressed kv latent + shared rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 -> d_model // n_heads

    # -- attention pattern ----------------------------------------------------
    sliding_window: int = 0              # gemma3 local window (0 = none)
    global_every: int = 0                # gemma3: 1 global per this many layers
    rope_theta: float = 1e4

    # -- MoE --------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                    # expert hidden (d_ff = dense hidden)
    n_shared_experts: int = 0            # deepseek shared expert(s)
    dense_residual: bool = False         # arctic: dense FFN in parallel w/ MoE
    first_dense_layers: int = 0          # deepseek: leading dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # -- MLA / MTP ----------------------------------------------------------------
    mla: MLAConfig | None = None
    mtp_depth: int = 0                   # deepseek multi-token-prediction heads

    # -- SSM hybrid (zamba2) -----------------------------------------------------
    ssm_state: int = 0                   # Mamba2 state dim per head
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0                  # shared attn applied after every k SSM layers
    ssm_head_dim: int = 64
    mamba_ngroups: int = 1               # B / C groups, each read by H / groups heads
    # the published Zamba2 block, named after its config.json's keys; the
    # defaults keep the block above (one shared block after every
    # attn_every layers, over h alone, with its own residuals)
    hybrid_layer_ids: tuple[int, ...] = ()   # a block runs before these layers
    num_mem_blocks: int = 1              # shared blocks, used in turn
    adapter_rank: int = 0                # each application's LoRA on the MLP

    # -- RWKV ---------------------------------------------------------------------
    rwkv_head_dim: int = 64

    # -- encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0
    n_frames: int = 1500                 # stubbed audio frame embeddings

    # -- VLM (llama-3.2-vision) ----------------------------------------------------
    cross_every: int = 0                 # 1 cross-attn layer per this many self layers
    n_patches: int = 1601                # stubbed image patch embeddings (1 tile)

    # -- numerics / misc -------------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    def __post_init__(self) -> None:
        # a configuration file's JSON list, kept hashable
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))

    # ------------------------------------------------------------ derived
    @property
    def published_zamba2(self) -> bool:
        """The hybrid family's published block (``hybrid_layer_ids`` set)."""
        return bool(self.hybrid_layer_ids)

    @property
    def applications(self) -> tuple[int, ...]:
        """The layers a shared block runs before: ``hybrid_layer_ids``
        below ``n_layers`` (a configuration cut in depth keeps the
        applications among its layers)."""
        return tuple(i for i in self.hybrid_layer_ids if i < self.n_layers)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / linear-attn / local-attn hybrid)."""
        return self.family in ("rwkv", "hybrid", "localglobal")

    def validate(self) -> None:
        assert self.d_model > 0 and self.n_layers > 0 and self.vocab > 0
        if self.family not in ("rwkv",):
            assert self.n_heads > 0
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, \
                "q heads must be a multiple of kv heads (GQA)"
        if self.is_moe:
            assert 0 < self.experts_per_token <= self.n_experts
            assert self.moe_d_ff > 0
        if self.family == "localglobal":
            assert self.sliding_window > 0 and self.global_every > 0
        if self.family == "hybrid":
            assert self.ssm_state > 0
            d_in = self.ssm_expand * self.d_model
            assert d_in // self.ssm_head_dim % self.mamba_ngroups == 0, \
                "mamba heads must be a multiple of mamba_ngroups"
            ids = self.hybrid_layer_ids
            if not ids:
                assert self.attn_every > 0
                assert (self.num_mem_blocks, self.adapter_rank) == (1, 0), \
                    "the published block's options need hybrid_layer_ids"
            else:
                assert list(ids) == sorted(set(ids)) and 0 <= ids[0]
                assert self.num_mem_blocks > 0 and self.adapter_rank > 0
        if self.family == "encdec":
            assert self.encoder_layers > 0
        if self.family == "vlm":
            assert self.cross_every > 0


# ---------------------------------------------------------------- input shapes
@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) cell and which step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, InputShape] = {s.name: s for s in
                                 (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig) -> list[InputShape]:
    """The assigned shape set, with the documented skips applied.

    ``long_500k`` runs only for sub-quadratic families (SSM / linear-attn /
    local-attn hybrid) — the pure full-attention archs skip it, as recorded in
    DESIGN.md §Arch-applicability.
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return out
