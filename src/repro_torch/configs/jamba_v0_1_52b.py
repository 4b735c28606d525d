"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 on every other layer, Mamba:attention
1:7 interleave (one attention layer per 8-layer block), Mamba-1-style
SSM (d_state=16, headdim=1 reproduces per-channel dt).
[arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    d_head=128,
    moe_experts=16,
    moe_top_k=2,
    moe_layer_period=2,
    moe_layer_offset=1,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state=16,
    ssm_headdim=1,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
)
