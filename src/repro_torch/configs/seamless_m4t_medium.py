"""seamless-m4t-medium [audio] — enc-dec, 12L decoder + 12L encoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  The speech frontend
(w2v-BERT feature extractor) is a STUB: the batch supplies
precomputed frame embeddings [B, S, 1024] as encoder input.
[arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    enc_layers=12,
    frontend="audio_stub",
    frontend_dim=1024,
)
