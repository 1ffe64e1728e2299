"""Whisper-small — enc-dec; conv/mel frontend stubbed to frame embeddings
[arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", arch="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64, rope_theta=1e4,
    enc_layers=12, enc_seq=1500, d_source=768,
)
