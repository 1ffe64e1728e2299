"""Hymba-1.5B — parallel attention + Mamba heads per block
[arXiv:2411.13676].

Deviation (DESIGN.md): sliding-window attention (2048) on ALL layers; the
paper keeps 3 layers global.  The Mamba branch supplies global context, and
a uniform window keeps the ring-buffer decode cache homogeneous under scan.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", arch="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64, rope_theta=1e4,
    ssm_state=16, d_inner=3200, window=2048,
)
