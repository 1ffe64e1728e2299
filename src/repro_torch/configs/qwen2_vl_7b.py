"""Qwen2-VL-7B language backbone — M-RoPE, dynamic resolution [arXiv:2409.12191].

Vision encoder (ViT + merger) is stubbed: input_specs() supplies precomputed
patch embeddings of shape (B, n_patches, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", arch="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    n_patches=256,
)
