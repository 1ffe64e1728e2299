"""MiniCPM-2B — llama-like arch; WSD schedule lives in repro.optim
[arXiv:2404.06395]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", arch="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, head_dim=64, rope_theta=1e4,
    tie_embeddings=True,
)
