"""Decoder-only model, dense architecture.

Parameters are a dict of tensors in the JAX package's tree layout, with
per-layer weights stacked on a leading layer axis, so the weight bridge
(:mod:`repro_torch.params`) is a copy.  Three entry points:

  * ``forward``      — full-sequence logits (teacher forcing)
  * ``prefill``      — full sequence, filling a decode cache
  * ``decode_step``  — one token against the cache

Other architectures (moe, ssm, hybrid, vlm, audio) are later slices of
the port and raise ``NotImplementedError``.  KV caches are updated in
place (see :mod:`.common`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..core.device import resolve_device
from .common import (Params, dense_init, init_attention, init_mlp, rms_norm,
                     run_attention, run_mlp)
from .config import ModelConfig


def require_dense(cfg: ModelConfig) -> None:
    if cfg.arch != "dense":
        raise NotImplementedError(
            f"arch {cfg.arch!r} ({cfg.name}) is not ported yet; the port "
            "serves the dense decoder")


def layer_params(tree: Any, j: int) -> Any:
    """Layer ``j``'s slice (views) of a layer-stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, j) for k, v in tree.items()}
    return tree[j]


# ======================================================================
# init
# ======================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights with the JAX package's scales (embed 0.02, else
    ``1/sqrt(fan_in)``).  The draws come from ``generator``, which must
    live on ``device``; they differ from JAX's draws."""
    require_dense(cfg)
    dev = resolve_device(device)
    L, D = cfg.n_layers, cfg.d_model
    params: Params = {
        "embed": dense_init(generator, (cfg.vocab, D), dev, dtype, scale=0.02),
        "final_norm": torch.ones((D,), device=dev, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (D, cfg.vocab), dev, dtype)
    params["blocks"] = {
        "ln1": torch.ones((L, D), device=dev, dtype=dtype),
        "attn": init_attention(cfg, generator, dev, dtype, L),
        "ln2": torch.ones((L, D), device=dev, dtype=dtype),
        "mlp": init_mlp(generator, D, cfg.d_ff, dev, dtype, L),
    }
    return params


# ======================================================================
# block application
# ======================================================================

def run_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_len: Optional[int] = None,
              layer_idx: int = 0,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """One transformer block.  Returns (x, new_cache, aux_loss)."""
    require_dense(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    kv = (cache["k"], cache["v"]) if cache is not None else None
    attn_out, new_kv = run_attention(p["attn"], cfg, h, positions, kv, cache_len)
    x = x + attn_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + run_mlp(p["mlp"], h)
    new_cache = None
    if cache is not None:
        new_cache = {"k": new_kv[0], "v": new_kv[1]}
    return x, new_cache, aux


def _embed(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (B,S))."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None].expand(B, S)
    return x, positions


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits (B,S,V), aux_loss)."""
    require_dense(cfg)
    x, positions = _embed(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(cfg.n_layers):
        x, _, a = run_block(cfg, layer_params(params["blocks"], j), x,
                            positions, layer_idx=j)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params), aux


# ======================================================================
# decode path
# ======================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Dense cache: per-layer k/v stacked as (L, B, T, Hk, hd) and a host
    ``int`` length."""
    require_dense(cfg)
    dev = resolve_device(device)
    L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kv_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (L, batch, kv_len, Hk, hd)
    return {"len": 0,
            "layers": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def apply_layers_cached(blocks: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache: Dict[str, Any],
                        layer_offset: int = 0,
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run every layer of ``blocks`` against ``cache`` (whose tensors are
    written in place).  Returns (x, cache with the advanced length)."""
    cache_len = cache["len"]
    layers = cache["layers"]
    n_layers = layers["k"].shape[0]
    for j in range(n_layers):
        lc = {"k": layers["k"][j], "v": layers["v"][j]}
        x, _, _ = run_block(cfg, layer_params(blocks, j), x, positions, lc,
                            cache_len, layer_idx=layer_offset + j)
    return x, {"len": cache_len + x.shape[1], "layers": layers}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt through the model, filling the cache.
    Returns (last-position logits (B,V), cache)."""
    require_dense(cfg)
    x, positions = _embed(cfg, params, batch)
    x, cache = apply_layers_cached(params["blocks"], cfg, x, positions, cache)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return (x @ _head(params))[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (B,) int -> (logits (B,V), cache)."""
    require_dense(cfg)
    B = token.shape[0]
    x = params["embed"][token.long()[:, None]]
    positions = torch.full((B, 1), cache["len"], dtype=torch.int32,
                           device=x.device)
    x, cache = apply_layers_cached(params["blocks"], cfg, x, positions, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _head(params))[:, 0], cache
