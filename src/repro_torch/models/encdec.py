"""Encoder–decoder transformer (Whisper-style audio backbone).

The mel-spectrogram + conv frontend is stubbed, as in the JAX package:
``batch["frames"]`` holds precomputed frame embeddings (B, enc_seq,
d_source), and a linear projection stands in for the conv stack.  The
bidirectional encoder, the causal decoder with cross-attention and the
KV-cached decode are implemented in full.

As in JAX, the decoder takes rotary positions (not Whisper's learned
absolute embeddings), so its self-attention shares
:func:`.common.run_attention` with the decoder-only archs: a prompt of
``FLASH_MIN_SEQ`` tokens or more goes through the flash kernel.  The
encoder adds sinusoidal positions and turns RoPE off by passing position
0 everywhere (cos 1, sin 0: an exact identity); its additive zero mask
makes it bidirectional ``attention_scores``, no kernel.  Cross-attention
is ``attention_scores`` without a mask.

Parameters keep the JAX tree: ``enc_proj`` (d_source, D), ``enc_blocks``
and ``dec_blocks`` stacked on a leading layer axis (``ln1``, ``attn``,
``ln2``, ``mlp``; the decoder's also ``lnx`` and ``xattn``), ``enc_norm``,
``embed``, ``final_norm`` and ``lm_head``, in the ``(in, out)`` layout, so
:mod:`repro_torch.params` crosses a JAX whisper tree unchanged.  The
cache holds per-layer self-attention ``k``/``v`` (L, B, T, Hk, hd) and
the cross ``xk``/``xv`` (L, B, enc_seq, Hk, hd): :func:`prefill` runs
the encoder once and writes every layer's cross K/V, and
:func:`decode_step` only reads them.  Caches are updated in place, and
``len`` is a host ``int``, as in :mod:`.decoder`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..core.device import resolve_device
from .common import (Params, attention_scores, dense_init, init_attention,
                     init_mlp, rms_norm, run_attention, run_mlp)
from .config import ModelConfig
from .decoder import cross_entropy, layer_params, unbind_layers


def _sinusoidal(n: int, d: int, device: torch.device) -> torch.Tensor:
    """(n, d) fp32: sin over the first d/2 columns, cos over the rest."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def init_cross_attention(cfg: ModelConfig, generator: torch.Generator,
                         device: torch.device, dtype: torch.dtype,
                         n_layers: int) -> Params:
    """Cross-attention weights stacked on a leading layer axis (no
    ``qk_norm``, as in JAX)."""
    L, D = n_layers, cfg.d_model
    return {
        "wq": dense_init(generator, (L, D, cfg.q_dim), device, dtype, fan_in=D),
        "wk": dense_init(generator, (L, D, cfg.kv_dim), device, dtype, fan_in=D),
        "wv": dense_init(generator, (L, D, cfg.kv_dim), device, dtype, fan_in=D),
        "wo": dense_init(generator, (L, cfg.q_dim, D), device, dtype,
                         fan_in=cfg.q_dim),
    }


def cross_kv(p: Params, cfg: ModelConfig, enc_out: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross K/V of the encoder output: (B, T, Hk, hd) each."""
    B, T, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    return k, v


def run_cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    rep = H // Hk
    kk = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vv = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    out = attention_scores(q, kk, vv, None)
    return out.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------- init

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights with the JAX package's scales (embed 0.02, else
    ``1/sqrt(fan_in)``), drawn from ``generator``, which must live on
    ``device``; they differ from JAX's draws."""
    dev = resolve_device(device)
    D, Le, Ld = cfg.d_model, cfg.enc_layers, cfg.n_layers

    def ones(L: int) -> torch.Tensor:
        return torch.ones((L, D), device=dev, dtype=dtype)

    return {
        "enc_proj": dense_init(generator, (cfg.d_source, D), dev, dtype),
        "enc_blocks": {
            "ln1": ones(Le),
            "attn": init_attention(cfg, generator, dev, dtype, Le),
            "ln2": ones(Le),
            "mlp": init_mlp(generator, D, cfg.d_ff, dev, dtype, Le),
        },
        "enc_norm": torch.ones((D,), device=dev, dtype=dtype),
        "embed": dense_init(generator, (cfg.vocab, D), dev, dtype, scale=0.02),
        "dec_blocks": {
            "ln1": ones(Ld),
            "attn": init_attention(cfg, generator, dev, dtype, Ld),
            "lnx": ones(Ld),
            "xattn": init_cross_attention(cfg, generator, dev, dtype, Ld),
            "ln2": ones(Ld),
            "mlp": init_mlp(generator, D, cfg.d_ff, dev, dtype, Ld),
        },
        "final_norm": torch.ones((D,), device=dev, dtype=dtype),
        "lm_head": dense_init(generator, (D, cfg.vocab), dev, dtype),
    }


# ------------------------------------------------------------------- encoder

def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_seq, d_source) stub embeddings -> (B, enc_seq, D)."""
    w = params["enc_proj"]
    x = frames.to(w.dtype) @ w
    B, T, _ = x.shape
    x = x + _sinusoidal(T, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    mask = torch.zeros((1, 1, T, T), dtype=torch.float32, device=x.device)
    for bp in unbind_layers(params["enc_blocks"]):
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        out, _ = run_attention(bp["attn"], cfg, h, positions, mask=mask)
        x = x + out
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + run_mlp(bp["mlp"], h)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ------------------------------------------------------------------- decoder

def run_dec_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                  positions: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_len: Optional[int] = None,
                  enc_out: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One decoder block: causal self-attention, cross-attention (over the
    cache's ``xk``/``xv``, or ``enc_out``'s without a cache), MLP.  With a
    cache, k/v are written in place at ``cache_len``; returns (x, the
    layer's cache)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    kv = (cache["k"], cache["v"]) if cache is not None else None
    out, _ = run_attention(bp["attn"], cfg, h, positions, kv, cache_len)
    x = x + out
    h = rms_norm(x, bp["lnx"], cfg.norm_eps)
    if cache is not None:
        ck, cv = cache["xk"], cache["xv"]
    else:
        ck, cv = cross_kv(bp["xattn"], cfg, enc_out)
    x = x + run_cross_attention(bp["xattn"], cfg, h, ck, cv)
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + run_mlp(bp["mlp"], h), cache


def _dec_layers_cached(params: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: Dict[str, Any],
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    layers = cache["layers"]
    for j in range(layers["k"].shape[0]):
        lc = {key: t[j] for key, t in layers.items()}
        x, _ = run_dec_block(cfg, layer_params(params["dec_blocks"], j), x,
                             positions, lc, cache["len"])
    return x, {"len": cache["len"] + x.shape[1], "layers": layers}


def _positions(B: int, S: int, base: int,
               device: torch.device) -> torch.Tensor:
    pos = torch.arange(base, base + S, dtype=torch.int32, device=device)
    return pos[None].expand(B, S)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, S, V) of ``batch["tokens"]`` given
    ``batch["frames"]``, and a zero aux loss."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = _positions(B, S, 0, x.device)
    for bp in unbind_layers(params["dec_blocks"]):
        x, _ = run_dec_block(cfg, bp, x, positions, enc_out=enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (ce + aux, {"ce", "aux", "n_tokens"})."""
    logits, aux = forward(params, cfg, batch)
    ce, n_valid = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux, "n_tokens": n_valid}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Zero k/v (L, B, max_len, Hk, hd), zero cross xk/xv (L, B, enc_seq,
    Hk, hd), and a host ``int`` length."""
    dev = resolve_device(device)
    L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def zeros(T: int) -> torch.Tensor:
        return torch.zeros((L, batch, T, Hk, hd), dtype=dtype, device=dev)

    return {"len": 0, "layers": {"k": zeros(max_len), "v": zeros(max_len),
                                 "xk": zeros(cfg.enc_seq),
                                 "xv": zeros(cfg.enc_seq)}}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode ``batch["frames"]`` once, write every layer's cross K/V into
    the cache, then run the prompt ``batch["tokens"]`` through the decoder.
    Returns (last-position logits (B,V), cache)."""
    enc_out = encode(params, cfg, batch["frames"])
    layers = cache["layers"]
    for j in range(layers["xk"].shape[0]):
        xk, xv = cross_kv(layer_params(params["dec_blocks"], j)["xattn"], cfg,
                          enc_out)
        layers["xk"][j].copy_(xk)
        layers["xv"][j].copy_(xv)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    # from position 0 whatever the cache holds, as JAX's prefill
    x, cache = _dec_layers_cached(params, cfg, x,
                                  _positions(B, S, 0, x.device), cache)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step against the cache (the encoder does not run):
    token (B,) int -> (logits (B,V), cache)."""
    B = token.shape[0]
    x = params["embed"][token.long()[:, None]]
    x, cache = _dec_layers_cached(params, cfg, x,
                                  _positions(B, 1, cache["len"], x.device),
                                  cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0], cache
