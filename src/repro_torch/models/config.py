"""Model + run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes are ``ShapeConfig``s.  Configs are pure data — the
model code in this package interprets them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """HOBFLOPS weight quantization (the paper's technique as a feature).

    format: any name accepted by ``repro_torch.core.fpformat.parse_format``.
    layout: "native" (int8/int16 codes) or "bitplane" (paper's layout,
            exactly nbits bits per weight in HBM).
    targets: which weight families are stored quantized.
    """
    format: str = "hobflops9"
    layout: str = "bitplane"
    targets: tuple[str, ...] = ("mlp", "attn")
    rounding: str = "rne"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    # --- attention flavor ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # --- MLP flavor ---
    mlp_act: str = "silu"       # silu -> SwiGLU, gelu -> GeGLU
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_layer_period: int = 1   # layer i is MoE iff i % period == offset
    moe_layer_offset: int = 0
    moe_capacity_factor: float = 1.25
    # --- hybrid (Jamba): attention layer placement among SSM layers ---
    attn_layer_period: int = 0  # 0 -> all layers are attention
    attn_layer_offset: int = 0
    # --- SSM (Mamba-1/2 via SSD; mamba1 == headdim 1) ---
    ssm_state: int = 0          # N (d_state); 0 -> no ssm layers
    ssm_headdim: int = 64       # P; 1 reproduces Mamba-1 semantics
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- encoder-decoder ---
    enc_layers: int = 0
    # --- modality frontend stubs ---
    frontend: str = "none"      # none | vit_stub | audio_stub
    num_prefix: int = 0         # patches/frames supplied by the stub
    frontend_dim: int = 0       # embedding dim delivered by the stub
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- technique ---
    quant: Optional[QuantConfig] = None
    # --- activation sharding hints (set by the launcher; None in tests).
    # PartitionSpec args as nested tuples, applied with
    # with_sharding_constraint under the active mesh. ---
    act_pspec: Optional[tuple] = None   # residual stream [B, S, d]
    moe_pspec: Optional[tuple] = None   # MoE dispatch buffer [E, C, d]

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 1

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 512 so the vocab axis shards
        over any mesh axis used here (16/32); labels are always < vocab."""
        return -(-self.vocab // 512) * 512

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    def is_attn_layer(self, i: int) -> bool:
        if self.family in ("dense", "moe", "vlm", "encdec"):
            return True
        if self.family == "ssm":
            return False
        return (i % self.attn_layer_period) == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe_experts == 0:
            return False
        return (i % self.moe_layer_period) == self.moe_layer_offset

    def layer_kinds(self) -> list[tuple[bool, bool]]:
        """Per layer (is_attention, is_moe)."""
        return [(self.is_attn_layer(i), self.is_moe_layer(i))
                for i in range(self.n_layers)]

    def scan_period(self) -> int:
        """Smallest layer-period such that the stack is a repetition of
        one period (used to scan over homogeneous super-layers)."""
        kinds = self.layer_kinds()
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p:
                continue
            if all(kinds[i] == kinds[i % p] for i in range(self.n_layers)):
                return p
        return self.n_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skip).  long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch: 512k dense-attention "
                       "decode is out of scope (DESIGN.md §6)")
    return True, ""
