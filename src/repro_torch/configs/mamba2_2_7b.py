"""mamba2-2.7b [ssm] — 64L d_model=2560 attention-free, d_ff=0,
vocab=50280, SSD with d_state=128, headdim=64, expand=2 (d_inner=5120,
80 heads).  [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    d_head=1,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
