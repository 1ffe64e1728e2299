"""Qwen1.5/2-MoE-A2.7B — 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", arch="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128, rope_theta=1e6,
    n_experts=60, n_shared_experts=4, moe_top_k=4, d_expert=1408,
)
