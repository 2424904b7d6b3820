"""Config system: architectures × input shapes.

Each assigned architecture gets one file in this package defining
``config() -> ModelConfig`` with the exact published hyper-parameters
(sources in each file's docstring). Reduced configs for CPU smoke tests
come from :func:`ModelConfig.reduced`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.stream import pad_vocab


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                   # dense-MLP width (0 = no MLP sublayer)
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    mlp_gated: bool = True      # SwiGLU vs. 2-matrix GELU
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_impl: str = "ep"        # ep (all_to_all) | tp (replicated experts) | dense
    capacity_factor: float = 1.25
    # -- SSM (Mamba2 / SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # -- hybrid / attention variants -------------------------------------------
    swa_window: int = 0         # 0 = full attention
    # -- modality frontend (stubbed: precomputed embeddings) -------------------
    frontend: str = "none"      # none | vlm | audio
    # -- numerics & perf knobs --------------------------------------------------
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    attn_impl: str = "chunked"  # full | chunked (XLA online-softmax) | kernel
    attn_chunk: int = 1024
    remat: str = "full"         # full | dots | none
    fsdp: bool = True
    sp: bool = True             # Megatron-SP: residual seq dim over model
    scan_unroll: int = 1        # layer-scan unroll (cost-probe/fusion knob)
    ce_chunk: int = 0           # >0: chunk unembed+CE over seq (memory knob)
    ssd_bf16: bool = False      # bf16 SSD intra-chunk einsums (memory knob)
    attn_flat_heads: bool = False  # repeat KV → flat-head einsums (TP knob)
    zero2: bool = False         # fsdp=False + optimizer states data-sharded
    opt_state_dtype: str = "float32"  # adam m/v dtype (bf16 = memory knob)
    embed_gather_local: bool = False  # shard embed table on d, not vocab
    grad_accum: int = 1         # microbatch accumulation (memory knob)
    optimizer: str = "adamw"    # adamw | adafactor
    dispatch_microbatch: int = 1  # MoE dispatch split (memory knob, §Perf)

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"bad family {self.family}")
        if self.family == "moe" and not (self.n_experts and self.top_k):
            raise ValueError("moe needs n_experts/top_k")
        if self.family in ("ssm", "hybrid") and not self.ssm_state:
            raise ValueError("ssm/hybrid needs ssm_state")

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:      # channels through the causal conv
        return self.d_inner + 2 * self.ssm_state

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid/SWA — not pure full attention)."""
        return self.family in ("ssm", "hybrid") or self.swa_window > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Total parameter count (embedding included, no padding)."""
        d, l = self.d_model, self.n_layers
        n = 0
        if self.has_attention:
            q = self.n_heads * self.head_dim
            kv = self.n_kv_heads * self.head_dim
            n += l * (d * (q + 2 * kv) + q * d)
        if self.has_ssm:
            din = self.d_inner
            # in_proj → [z, x, B, C, dt]; out_proj
            n += l * (d * (2 * din + 2 * self.ssm_state + self.ssm_heads)
                      + din * d + self.conv_dim * self.conv_width + din)
        if self.d_ff:
            mats = 3 if self.mlp_gated else 2
            n += l * mats * d * self.d_ff
        if self.n_experts:
            mats = 3 if self.mlp_gated else 2
            n += l * (d * self.n_experts
                      + self.n_experts * mats * d * self.d_ff_expert)
        n += self.vocab * d * (1 if self.tie_embeddings else 2)
        n += l * 2 * d + d  # norms
        return n

    def n_active_params(self) -> int:
        """Active per token (MoE: selected experts only) — for 6·N·D."""
        if not self.n_experts:
            return self.n_params()
        mats = 3 if self.mlp_gated else 2
        inactive = (self.n_layers * (self.n_experts - self.top_k)
                    * mats * self.d_model * self.d_ff_expert)
        return self.n_params() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=max(1, min(self.n_heads, 4)),
            n_kv_heads=(0 if not self.n_heads else
                        max(1, min(self.n_kv_heads, 2))),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=64 if self.d_ff_expert else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            swa_window=min(self.swa_window, 32) if self.swa_window else 0,
            attn_chunk=32,
            param_dtype="float32",
            act_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch × shape) a valid dry-run cell? (DESIGN.md §8 skip policy)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense-KV decode is the "
                       "quadratic case long_500k excludes (DESIGN.md §8)")
    return True, ""
