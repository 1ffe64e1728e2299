"""Model configuration shared by every assigned architecture (a copy of
the JAX package's ``ModelConfig``, so the port imports nothing of it)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0            # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- M-RoPE (Qwen2-VL) ---
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0            # per-expert FFN width (0 => d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_groups: int = 1          # token-dispatch groups (= data shards at scale)

    # --- SSM / hybrid ---
    ssm_state: int = 0           # mamba state size N
    d_inner: int = 0             # mamba inner width (0 => 2*d_model)
    slstm_every: int = 0         # xLSTM: every k-th block is sLSTM (0 = none)

    # --- encoder-decoder (audio) ---
    enc_layers: int = 0
    enc_seq: int = 0             # encoder source length (precomputed frames)
    d_source: int = 0            # frontend embedding dim (stub input)

    # --- VLM ---
    n_patches: int = 0           # patch embeddings per image (stub input)

    # --- attention variant ---
    window: int = 0              # 0 = full causal; >0 = sliding window

    # runtime knobs (not architecture)
    remat: bool = False          # activation checkpoint each block
    use_flash_kernel: bool = False
    #: mesh axes carrying the batch dim of activations; when set (under
    #: pjit with a mesh context) block-boundary activations are pinned to
    #: P(act_batch_axes, None, ...) so sharding propagation can't flip to
    #: replicated-batch layouts
    act_batch_axes: Tuple[str, ...] = ()
    #: sequence parallelism for recurrent (mLSTM) prefill: split the
    #: sequence into this many segments, run them in parallel over
    #: ``act_seq_axis``, and stitch with an associative state scan
    seq_segments: int = 0
    act_seq_axis: str = ""
    #: tensor-parallel mesh axis name (for keeping contracted-dim outputs
    #: sharded instead of all-reduced to full, e.g. MoE down-projection)
    act_model_axis: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def d_exp(self) -> int:
        return self.d_expert or self.d_ff

    @property
    def d_in(self) -> int:
        return self.d_inner or 2 * self.d_model

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512, **kw) -> "ModelConfig":
        """Smoke-test variant of the same family (CPU-friendly)."""
        scale = d_model / self.d_model
        n_heads = max(2, min(self.n_heads, 4))
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        updates = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=max(64, int(self.d_ff * scale) // 16 * 16) if self.d_ff else 0,
            vocab=vocab,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 64),
            n_patches=min(self.n_patches, 16),
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            d_expert=max(32, int(self.d_exp * scale) // 8 * 8) if self.n_experts else 0,
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            d_inner=2 * d_model if self.d_inner else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            window=min(self.window, 64) if self.window else 0,
            mrope_sections=tuple(
                s * (d_model // n_heads) // self.hd for s in self.mrope_sections),
        )
        updates.update(kw)
        return replace(self, **updates)

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D roofline math)."""
        D, L, V = self.d_model, self.n_layers, self.vocab
        attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        if self.arch == "ssm":
            # mLSTM block: qkv projections + gates + out + ff
            blk = 4 * D * self.hd * self.n_heads + 2 * D
        else:
            blk = attn
        if self.n_experts:
            moe = self.n_experts * 3 * D * self.d_exp + D * self.n_experts
            moe += self.n_shared_experts * 3 * D * self.d_exp
            blk += moe
        elif self.d_ff:
            blk += 3 * D * self.d_ff
        if self.arch in ("hybrid",):
            d_in = self.d_in
            blk += 2 * D * d_in + d_in * (2 * self.ssm_state + 2) + d_in * D
        total = L * blk + V * D * (1 if self.tie_embeddings else 2) + D
        if self.enc_layers:
            total += self.enc_layers * (attn + 3 * D * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-to experts count)."""
        if not self.n_experts:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        full = self.param_count()
        all_expert = L * self.n_experts * 3 * D * self.d_exp
        active_expert = L * self.moe_top_k * 3 * D * self.d_exp
        return int(full - all_expert + active_expert)
