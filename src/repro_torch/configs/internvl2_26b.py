"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553; InternViT frontend is a STUB: the batch supplies
precomputed patch embeddings [B, 512, 3200] which the model projects and
prepends to the token sequence.  [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    d_head=128,
    frontend="vit_stub",
    num_prefix=512,
    frontend_dim=3200,
)
