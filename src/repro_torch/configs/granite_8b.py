"""Granite-8B-Code — llama-arch, code model [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", arch="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, head_dim=128, rope_theta=1e4,
)
