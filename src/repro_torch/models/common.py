"""Shared layers: norms, rotary embeddings (incl. M-RoPE), attention, MLP.

Plain functions over explicit parameter dicts of tensors, keeping the JAX
package's ``(in, out)`` weight layout (``x @ W``) and its numerics: fp32
upcast in the norm and in RoPE, RoPE on the two halves of the head dim,
the additive ``-1e9`` mask, and streaming (flash) attention from
``FLASH_MIN_SEQ`` tokens on, through the port's kernel dispatcher (and,
under autograd, through the flash backward).  float64 inputs stay float64
throughout, so a float64 run is a reference for the float32 one.

A cache of exactly ``cfg.window`` tokens under a sliding window is a ring
buffer, as in JAX: position ``p`` lives in slot ``p % window``, a block
of ``S >= window`` tokens keeps its last ``window``, and the mask reads
each slot's position from :func:`_ring_pos`.  JAX's masks are kept as they
are, the reference's hazard included: a block of ``window <= S <
FLASH_MIN_SEQ`` tokens attends over the ring alone, so each of its
queries but the last sees only the keys still in the ring, and a query
older than all of them averages the ring (its every score is ``-1e9``).

Difference from the JAX package: a KV cache passed to
:func:`run_attention` is updated in place (JAX returns a new array), which
saves a copy of the cache per step; ``cache_len`` is a host ``int``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig

Params = Dict[str, Any]

#: below this sequence length, plain S² attention is cheaper than streaming
FLASH_MIN_SEQ = 2048


# ----------------------------------------------------------------- init utils

def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               device: torch.device, dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal draws scaled by ``scale``, or ``1/sqrt(fan_in)`` where
    ``fan_in`` defaults to ``shape[0]`` as in the JAX package (pass it for a
    layer-stacked shape)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return out.mul_(scale)


# ----------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """In float32 (float64 inputs stay float64), cast back to x's type."""
    dtype = x.dtype
    up = torch.promote_types(dtype, torch.float32)
    x = x.to(up)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.to(up)).to(dtype)


# ------------------------------------------------------------------------ RoPE

def rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  The angles are fp32, as in
    JAX; the rotation runs in float32 (float64 for float64 x)."""
    hd = x.shape[-1]
    up = torch.promote_types(x.dtype, torch.float32)
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = (positions[..., None].float() * freqs).to(up)   # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(up), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head dim's frequency pairs split
    into (t, h, w) sections, each rotated by its own position stream.

    x: (B, S, H, hd); positions3: (3, B, S) int — temporal, height, width.
    ``sections`` counts frequency pairs per stream (sum == hd // 2; as
    JAX's ``total_repeat_length``, a shorter sum repeats the last stream
    and a longer one is cut).  The angles are fp32, as in
    :func:`apply_rope`, which this equals when the three streams are
    equal."""
    hd = x.shape[-1]
    up = torch.promote_types(x.dtype, torch.float32)
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ids = [i for i, n in enumerate(sections) for _ in range(n)]
    ids = (ids + ids[-1:] * hd)[:hd // 2]
    sec_ids = torch.tensor(ids, device=x.device)             # (hd/2,)
    pos = positions3.float()[sec_ids]                        # (hd/2,B,S)
    angles = (torch.movedim(pos, 0, -1) * freqs).to(up)      # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(up), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- attention

def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   device: torch.device, dtype: torch.dtype,
                   n_layers: int) -> Params:
    """Attention weights stacked on a leading layer axis."""
    L, D = n_layers, cfg.d_model
    p: Params = {
        "wq": dense_init(generator, (L, D, cfg.q_dim), device, dtype, fan_in=D),
        "wk": dense_init(generator, (L, D, cfg.kv_dim), device, dtype, fan_in=D),
        "wv": dense_init(generator, (L, D, cfg.kv_dim), device, dtype, fan_in=D),
        "wo": dense_init(generator, (L, cfg.q_dim, D), device, dtype,
                         fan_in=cfg.q_dim),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, cfg.hd), device=device, dtype=dtype)
        p["k_norm"] = torch.ones((L, cfg.hd), device=device, dtype=dtype)
    return p


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Reference attention: q (B,S,H,hd), k/v (B,T,H,hd), mask additive,
    broadcastable to (B,H,S,T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    up = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bshd,bthd->bhst", q.to(up), k.to(up)) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.to(up))
    return out.to(q.dtype)


def causal_mask(s: int, t: int, window: int = 0, offset: int = 0,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Additive mask (1,1,S,T).  ``offset`` = number of cached tokens before
    the current block (query i attends keys <= offset+i).  ``window`` > 0
    limits attention to the trailing ``window`` keys."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    ok = kj <= qi
    if window > 0:
        ok &= kj > (qi - window)
    return torch.where(ok, 0.0, -1e9).float()[None, None]


def run_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  cache_len: Optional[int] = None,
                  mask: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA attention.  Without a cache: causal self-attention over x.
    With a cache (k, v of shape (B,T,Hk,hd)): write at ``cache_len`` (in
    place) and attend over the cache (decode / incremental prefill).

    positions: (B,S), or (3,B,S) when ``cfg.mrope``.  The rotation is
    applied before either branch, so M-RoPE takes the flash kernel as
    plain RoPE does; JAX's no-cache branch sends M-RoPE under
    ``use_flash_kernel`` below ``FLASH_MIN_SEQ`` to the masked
    ``attention_scores``, the same causal function.
    """
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hk, hd)
    v = (x @ p["wv"]).reshape(B, S, Hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache                                  # (B,T,Hk,hd)
        T = ck.shape[1]
        dev = x.device
        if cfg.window > 0 and T == cfg.window:
            # ring buffer: the scatter wraps; a block longer than the ring
            # keeps its last T tokens
            n = min(S, T)
            idx = (cache_len + S - n + torch.arange(n, device=dev)) % T
            ck[:, idx] = k[:, S - n:]
            cv[:, idx] = v[:, S - n:]
            kpos = _ring_pos(torch.arange(T, device=dev), cache_len + S, T)
        else:
            if cache_len + S > T:
                raise ValueError(
                    f"cache of {T} cannot take {cache_len}+{S} tokens")
            ck[:, cache_len:cache_len + S] = k
            cv[:, cache_len:cache_len + S] = v
            kpos = torch.arange(T, device=dev)
        new_cache = (ck, cv)
        if S > 1 and S >= FLASH_MIN_SEQ:
            # initial prefill: stream the NEW block's k/v flash-style
            # instead of materializing S x T scores.  That attends over the
            # block alone, from position 0, so it is right only for an
            # empty cache (the JAX package takes it for any cache_len)
            if cache_len > 0:
                raise ValueError(
                    f"a prefill of {S} >= {FLASH_MIN_SEQ} tokens takes the "
                    f"flash branch, which needs an empty cache; this cache "
                    f"holds {cache_len} tokens")
            kk = _repeat_kv(k, H // Hk)
            vv = _repeat_kv(v, H // Hk)
            out = ops.flash_attention(q, kk, vv, causal=True, window=cfg.window)
        else:
            qpos = cache_len + torch.arange(S, device=dev)
            ok = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
            if cfg.window > 0:
                ok &= kpos[None, :] > (qpos[:, None] - cfg.window)
            amask = torch.where(ok, 0.0, -1e9).float()[None, None]
            kk = _repeat_kv(ck, H // Hk)
            vv = _repeat_kv(cv, H // Hk)
            out = attention_scores(q, kk, vv, amask)
    else:
        kk = _repeat_kv(k, H // Hk)
        vv = _repeat_kv(v, H // Hk)
        if mask is None and (cfg.use_flash_kernel or S >= FLASH_MIN_SEQ):
            out = ops.flash_attention(q, kk, vv, causal=True, window=cfg.window)
        else:
            if mask is None:
                mask = causal_mask(S, S, cfg.window, device=x.device)
            out = attention_scores(q, kk, vv, mask)
    y = out.reshape(B, S, H * hd) @ p["wo"]
    return y, new_cache


def _ring_pos(slot: torch.Tensor, length: int, T: int) -> torch.Tensor:
    """Absolute position stored in ring slot ``slot`` when ``length``
    tokens have been written into a ring of size T (negative: never
    written)."""
    # the last written slot is (length-1) % T, holding position length-1
    last_slot = (length - 1) % T
    delta = (last_slot - slot) % T
    return (length - 1) - delta


# ------------------------------------------------------------------------- MLP

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             device: torch.device, dtype: torch.dtype,
             n_layers: int) -> Params:
    """SwiGLU weights stacked on a leading layer axis."""
    L = n_layers
    return {
        "w_gate": dense_init(generator, (L, d_model, d_ff), device, dtype,
                             fan_in=d_model),
        "w_up": dense_init(generator, (L, d_model, d_ff), device, dtype,
                           fan_in=d_model),
        "w_down": dense_init(generator, (L, d_ff, d_model), device, dtype,
                             fan_in=d_ff),
    }


def run_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
