"""Decoder-only model: the dense, MoE, xLSTM (ssm), hybrid and vlm
architectures.

Parameters are a dict of tensors in the JAX package's tree layout, so the
weight bridge (:mod:`repro_torch.params`) is a copy: dense and MoE blocks
are stacked on a leading layer axis, and the heterogeneous xLSTM stack is
a list of per-layer dicts, each holding an ``mlstm`` and an ``slstm``
tree (layer ``l`` runs its sLSTM when ``l % slstm_every == slstm_every -
1``, on the global layer index).  Three entry points:

  * ``forward``      — full-sequence logits (teacher forcing), and
    ``loss_fn`` / ``cross_entropy`` on them for training
  * ``prefill``      — full sequence, filling a decode cache
  * ``decode_step``  — one token against the cache

An MoE block replaces the MLP with :func:`.moe.run_moe`, without token
drops when it runs against a cache (prefill and decode), and its
load-balance loss is summed over the layers.  A hybrid block (hymba) runs
attention and :func:`.ssm.run_mamba` on the same normed input and adds
their mean, ``0.5 * (attn + ssm)``, before the MLP; its cache holds the
Mamba state ``h`` (L,B,d_in,N) and ``conv`` (L,B,CONV_K-1,d_in) beside
k/v, which are a ring buffer of ``cfg.window`` tokens once the cache is
that long.  A vlm block is a dense one under M-RoPE: ``batch["vision_embeds"]``
(B, n_patches, D), the stubbed vision frontend, is prepended to the token
embeddings, ``batch["positions3"]`` (3, B, S) gives the (t, h, w)
positions (``arange`` on all three streams when absent), ``forward``
drops the patch rows from the logits, and a decode step's position is
the cache length on all three streams, as in JAX (Qwen2-VL would continue
from ``max(positions3) + 1``; a hazard of the reference, kept).  The
encoder-decoder (audio) arch is :mod:`.encdec`; here it raises
``NotImplementedError``.  KV caches are updated in place
(see :mod:`.common`), and so is the Mamba state of a layer-stacked cache;
an xLSTM cache is, as in JAX, a list of per-layer state dicts that each
call replaces.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from .common import (Params, dense_init, init_attention, init_mlp, rms_norm,
                     run_attention, run_mlp)
from .config import ModelConfig
from .moe import init_moe, run_moe, switch_aux
from .ssm import (CONV_K, init_mamba, init_mlstm, init_slstm, run_mamba,
                  run_mlstm, run_slstm)

#: architectures this module implements so far
PORTED_ARCHS = ("dense", "moe", "ssm", "hybrid", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.arch not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {cfg.arch!r} ({cfg.name}) is not a decoder arch of this "
            f"module, which serves {PORTED_ARCHS}")


def layer_params(tree: Any, j: int) -> Any:
    """Layer ``j``'s slice (views) of a layer-stacked parameter tree, or
    entry ``j`` of a per-layer list."""
    if isinstance(tree, dict):
        return {k: layer_params(v, j) for k, v in tree.items()}
    return tree[j]


def unbind_layers(tree: Any) -> List[Any]:
    """Every layer's slice of a layer-stacked parameter tree, from one
    ``torch.unbind`` per leaf.  Under autograd its backward is one stack,
    so the gradients come out stacked; slicing ``tree[j]`` per layer would
    instead add each slice's gradient into a zero tensor the size of the
    whole leaf, once per layer."""
    if isinstance(tree, dict):
        per_key = {k: unbind_layers(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[j] for k, v in per_key.items()} for j in range(n)]
    return list(torch.unbind(tree, 0))


# ======================================================================
# init
# ======================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights with the JAX package's scales (embed 0.02, else
    ``1/sqrt(fan_in)``).  The draws come from ``generator``, which must
    live on ``device``; they differ from JAX's draws."""
    require_ported(cfg)
    dev = resolve_device(device)
    L, D = cfg.n_layers, cfg.d_model
    params: Params = {
        "embed": dense_init(generator, (cfg.vocab, D), dev, dtype, scale=0.02),
        "final_norm": torch.ones((D,), device=dev, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (D, cfg.vocab), dev, dtype)
    if cfg.arch == "ssm":
        params["blocks"] = [_init_ssm_block(cfg, generator, dev, dtype)
                            for _ in range(L)]
        return params
    params["blocks"] = {
        "ln1": torch.ones((L, D), device=dev, dtype=dtype),
        "attn": init_attention(cfg, generator, dev, dtype, L),
        "ln2": torch.ones((L, D), device=dev, dtype=dtype),
    }
    if cfg.arch == "moe":
        params["blocks"]["moe"] = init_moe(cfg, generator, dev, dtype, L)
    else:
        params["blocks"]["mlp"] = init_mlp(generator, D, cfg.d_ff, dev,
                                           dtype, L)
    if cfg.arch == "hybrid":
        params["blocks"]["mamba"] = init_mamba(cfg, generator, dev, dtype, L)
    return params


def _init_ssm_block(cfg: ModelConfig, generator: torch.Generator,
                    device: torch.device, dtype: torch.dtype) -> Params:
    p: Params = {"ln1": torch.ones((cfg.d_model,), device=device, dtype=dtype),
                 "mlstm": init_mlstm(cfg, generator, device, dtype)}
    if cfg.slstm_every:
        p["slstm"] = init_slstm(cfg, generator, device, dtype)
    return p


def _is_slstm(cfg: ModelConfig, layer: int) -> bool:
    return bool(cfg.slstm_every) and (
        layer % cfg.slstm_every == cfg.slstm_every - 1)


# ======================================================================
# block application
# ======================================================================

_MLSTM_KEYS = ("C", "n", "m")
_SLSTM_KEYS = ("sc", "sn", "sh", "sm")


def _run_ssm_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]], layer_idx: int,
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """An xLSTM block: rms_norm, the sLSTM or the mLSTM, residual.  With a
    cache, returns a new per-layer dict holding the new state."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if _is_slstm(cfg, layer_idx):
        keys, fn, sub = _SLSTM_KEYS, run_slstm, p["slstm"]
    else:
        keys, fn, sub = _MLSTM_KEYS, run_mlstm, p["mlstm"]
    st = tuple(cache[key] for key in keys) if cache is not None else None
    out, new_st = fn(sub, cfg, h, st)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache.update(zip(keys, new_st))
    return x + out, new_cache


def run_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_len: Optional[int] = None,
              layer_idx: int = 0,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """One block.  Returns (x, new_cache, aux_loss)."""
    require_ported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.arch == "ssm":
        x, new_cache = _run_ssm_block(cfg, p, x, cache, layer_idx)
        return x, new_cache, aux
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    kv = (cache["k"], cache["v"]) if cache is not None else None
    attn_out, new_kv = run_attention(p["attn"], cfg, h, positions, kv, cache_len)
    if cfg.arch == "hybrid":
        mstate = (cache["h"], cache["conv"]) if cache is not None else None
        ssm_out, new_mstate = run_mamba(p["mamba"], cfg, h, mstate)
        attn_out = 0.5 * (attn_out + ssm_out)
    x = x + attn_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.arch == "moe":
        ffn_out, probs, experts = run_moe(p["moe"], cfg, h,
                                          no_drop=cache is not None)
        aux = switch_aux(cfg, probs, experts)
    else:
        ffn_out = run_mlp(p["mlp"], h)
    x = x + ffn_out
    new_cache = None
    if cache is not None:
        new_cache = {"k": new_kv[0], "v": new_kv[1]}
        if cfg.arch == "hybrid":
            new_cache["h"], new_cache["conv"] = new_mstate
    return x, new_cache, aux


def _embed(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (B,S), or (3,B,S) under M-RoPE).
    A vlm batch's ``vision_embeds`` come first in x."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    if cfg.arch == "vlm" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None].expand(B, S)
    if cfg.mrope:
        given = batch.get("positions3")
        positions = (positions[None].expand(3, B, S) if given is None
                     else given)
    return x, positions


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits (B,S,V), aux_loss).  With
    ``cfg.remat`` each dense, MoE, hybrid or vlm block is recomputed in
    the backward instead of keeping its activations, as JAX's
    ``jax.checkpoint``."""
    require_ported(cfg)
    x, positions = _embed(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.arch == "ssm":
        blocks, remat = params["blocks"], False
    else:
        blocks, remat = unbind_layers(params["blocks"]), cfg.remat
    for j, bp in enumerate(blocks):
        if remat:
            x, _, a = checkpoint(run_block, cfg, bp, x, positions, None, None,
                                 j, use_reentrant=False)
        else:
            x, _, a = run_block(cfg, bp, x, positions, layer_idx=j)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _head(params)
    if cfg.arch == "vlm" and "vision_embeds" in batch:
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    return logits, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross entropy over the labels >= 0 (the others are
    ignored), and the number of those labels (at least 1).  The label
    logit is gathered and the normalizer is a logsumexp: no one-hot and no
    full log-softmax.  float32 (float64 for float64 logits)."""
    valid = labels >= 0
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])
    ll = label_logit[..., 0] - lse
    n_valid = torch.clamp_min(valid.sum(), 1)
    return -torch.sum(ll * valid) / n_valid, n_valid


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (ce + aux, {"ce", "aux", "n_tokens"})."""
    logits, aux = forward(params, cfg, batch)
    ce, n_valid = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux, "n_tokens": n_valid}


# ======================================================================
# decode path
# ======================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Dense cache: per-layer k/v stacked as (L, B, T, Hk, hd) and a host
    ``int`` length, with T = ``max_len``, or ``min(max_len, cfg.window)``
    under a sliding window (a ring buffer when T == window).  Hybrid
    cache: also the Mamba state h (L, B, d_in, N) in float32 (float64
    for a float64 ``dtype``) and conv (L, B, CONV_K-1, d_in), all zero.
    xLSTM cache: a list of per-layer dicts, each with the
    mLSTM state C (B,H,hd,hd), n (B,H,hd), m (B,H) = 0 and the sLSTM
    state sc, sn = 1e-6, sh, sm (B,H,d/H), in every layer and in float32
    whatever ``dtype``, as in JAX (``max_len`` sizes nothing)."""
    require_ported(cfg)
    dev = resolve_device(device)
    if cfg.arch == "ssm":
        return {"len": 0, "layers": [_ssm_layer_cache(cfg, batch, dev)
                                     for _ in range(cfg.n_layers)]}
    L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kv_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (L, batch, kv_len, Hk, hd)
    layers = {"k": torch.zeros(shape, dtype=dtype, device=dev),
              "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.arch == "hybrid":
        layers["h"] = torch.zeros(
            (L, batch, cfg.d_in, cfg.ssm_state), device=dev,
            dtype=torch.promote_types(dtype, torch.float32))
        layers["conv"] = torch.zeros((L, batch, CONV_K - 1, cfg.d_in),
                                     dtype=dtype, device=dev)
    return {"len": 0, "layers": layers}


def _ssm_layer_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    hd_m = 2 * cfg.d_model // H
    hd_s = cfg.d_model // H

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros((batch, H) + shape, dtype=torch.float32,
                           device=device)

    return {"C": zeros(hd_m, hd_m), "n": zeros(hd_m), "m": zeros(),
            "sc": zeros(hd_s), "sn": zeros(hd_s) + 1e-6, "sh": zeros(hd_s),
            "sm": zeros(hd_s)}


def apply_layers_cached(blocks: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache: Dict[str, Any],
                        layer_offset: int = 0,
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run every layer of ``blocks`` against ``cache`` (whose tensors are
    written in place; an xLSTM cache's layer list is replaced).  Returns
    (x, cache with the advanced length)."""
    cache_len = cache["len"]
    layers = cache["layers"]
    if cfg.arch == "ssm":
        new_layers = []
        for j, (bp, lc) in enumerate(zip(blocks, layers)):
            x, nc, _ = run_block(cfg, bp, x, positions, lc, cache_len,
                                 layer_idx=layer_offset + j)
            new_layers.append(nc)
        return x, {"len": cache_len + x.shape[1], "layers": new_layers}
    n_layers = layers["k"].shape[0]
    for j in range(n_layers):
        lc = {key: t[j] for key, t in layers.items()}
        x, nc, _ = run_block(cfg, layer_params(blocks, j), x, positions, lc,
                             cache_len, layer_idx=layer_offset + j)
        if cfg.arch == "hybrid":          # k/v were written in place
            layers["h"][j].copy_(nc["h"])
            layers["conv"][j].copy_(nc["conv"])
    return x, {"len": cache_len + x.shape[1], "layers": layers}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt through the model, filling the cache.
    Returns (last-position logits (B,V), cache)."""
    require_ported(cfg)
    x, positions = _embed(cfg, params, batch)
    x, cache = apply_layers_cached(params["blocks"], cfg, x, positions, cache)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return (x @ _head(params))[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (B,) int -> (logits (B,V), cache)."""
    require_ported(cfg)
    B = token.shape[0]
    x = params["embed"][token.long()[:, None]]
    positions = torch.full((B, 1), cache["len"], dtype=torch.int32,
                           device=x.device)
    if cfg.mrope:
        positions = positions[None].expand(3, B, 1)
    x, cache = apply_layers_cached(params["blocks"], cfg, x, positions, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _head(params))[:, 0], cache
