"""Pipeline shards of a model: layer planning, parameter split, and the
module one shard applies.

Only the local pieces are ported so far: the RPC services, the shard
server and the shard-aware client stay with the JAX package until a later
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import decoder
from ..models.common import rms_norm
from ..models.config import ModelConfig
from ..tree import leaves


def plan_shards(cfg: ModelConfig, n_shards: int) -> List[Tuple[int, int]]:
    """Split layers into contiguous ranges, as even as possible."""
    L = cfg.n_layers
    base, rem = divmod(L, n_shards)
    plan = []
    lo = 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        plan.append((lo, hi))
        lo = hi
    return plan


def _slice_layers(tree: Any, lo: int, hi: int) -> Any:
    """Layers ``lo:hi`` of a layer-stacked tree (views), or of a per-layer
    list (the xLSTM stack)."""
    if isinstance(tree, dict):
        return {k: _slice_layers(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def split_params(cfg: ModelConfig, params: Any,
                 plan: List[Tuple[int, int]]) -> List[Dict[str, Any]]:
    """Per-shard param subsets (first gets embed, last gets norm+head).
    Layer slices are views of the stacked tensors, or sublists of the
    per-layer list."""
    decoder.require_ported(cfg)
    shards = []
    for i, (lo, hi) in enumerate(plan):
        sub: Dict[str, Any] = {"blocks": _slice_layers(params["blocks"], lo, hi)}
        if i == 0:
            sub["embed"] = params["embed"]
        if i == len(plan) - 1:
            sub["final_norm"] = params["final_norm"]
            if "lm_head" in params:
                sub["lm_head"] = params["lm_head"]
            elif cfg.tie_embeddings:
                sub["embed_out"] = params["embed"]
        shards.append(sub)
    return shards


class ShardModule:
    """Applies one shard's layer range, with per-session decode caches."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 layer_range: Tuple[int, int], is_first: bool, is_last: bool):
        decoder.require_ported(cfg)
        self.cfg = cfg
        self.params = params
        self.lo, self.hi = layer_range
        self.is_first = is_first
        self.is_last = is_last

    @property
    def n_layers(self) -> int:
        return self.hi - self.lo

    @property
    def device(self) -> torch.device:
        return params_device(self.params)

    def _layer_params(self, j: int) -> Any:
        return decoder.layer_params(self.params["blocks"], j)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.params["embed"][tokens.long()]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.params["final_norm"], self.cfg.norm_eps)
        w = self.params.get("lm_head")
        if w is None:
            w = self.params["embed_out"].T
        return x @ w

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """A decode cache for this shard's layers only."""
        layer_cfg = dataclasses.replace(self.cfg, n_layers=self.n_layers)
        return decoder.init_cache(layer_cfg, batch, max_len, device=self.device)

    def apply(self, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[Dict[str, Any]],
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        if cache is not None:
            return decoder.apply_layers_cached(
                self.params["blocks"], self.cfg, x, positions, cache,
                layer_offset=self.lo)
        for j in range(self.n_layers):
            x, _, _ = decoder.run_block(self.cfg, self._layer_params(j), x,
                                        positions, layer_idx=self.lo + j)
        return x, None

    def flops(self, tokens: int) -> float:
        """The JAX package's cost model, kept as a parity target: 12 d^2
        per layer and token whatever the arch (an undercount for ssm)."""
        per_layer = 12 * self.cfg.d_model ** 2
        return 2.0 * tokens * per_layer * self.n_layers

    def weight_bytes(self) -> int:
        """Bytes the accelerator streams to apply this shard once — what
        the bandwidth term of the decode cost model charges per pass."""
        return sum(t.numel() * t.element_size() for t in leaves(self.params))


def params_device(params: Dict[str, Any]) -> torch.device:
    """The device every tensor of ``params`` lives on (raises if mixed)."""
    devices = {t.device for t in leaves(params)}
    if len(devices) != 1:
        raise ValueError(f"parameters span devices {sorted(map(str, devices))}")
    return devices.pop()
