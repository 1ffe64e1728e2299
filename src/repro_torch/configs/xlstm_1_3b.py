"""xLSTM-1.3B — mLSTM blocks with an sLSTM every 8th block (≈7:1 ratio)
[arXiv:2405.04517].  d_ff=0: feed-forward capacity lives inside the xLSTM
blocks (mLSTM pre-up-projection ×2, sLSTM post-FF ×8/3)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", arch="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=512,
    slstm_every=8,
)
