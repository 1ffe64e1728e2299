"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128, rope_theta=5e5,
    n_experts=16, n_shared_experts=0, moe_top_k=4, d_expert=10752,
)
