"""Public kernel entry points: the device of the inputs picks the path.

A CUDA tensor launches the hand-written kernel, and a failed build or
launch raises; a CPU tensor takes the plain PyTorch version.  There is no
fallback from one to the other.

Each CUDA wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` sets them to 0, so a caller can
show which kernels a run went through.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import flash_attention as _flash
from . import moe_gating as _gating
from . import paged_attention as _paged


def _route(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) (kv already head-repeated) -> (B, S, H, hd)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    fn = _flash.flash_attention_cuda if _route(q) else _flash.flash_attention_plain
    return fn(qt, kt, vt, causal=causal, window=window).transpose(1, 2)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None,
                           ) -> torch.Tensor:
    """Single-query decode attention over a paged KV pool.

    q (M,H,hd); pools (P,page,Hk,hd) fp32 or int8 (+ (P,Hk) scales);
    block_tables (M,NP) int32; lengths (M,) cached tokens; k/v_new
    (M,Hk,hd) the current token (attended at position ``lengths``).
    """
    fn = (_paged.paged_attention_cuda if _route(q)
          else _paged.paged_attention_plain)
    return fn(q, k_pool, v_pool, block_tables, lengths, k_new, v_new,
              k_scales, v_scales)


def moe_gating(logits: torch.Tensor, k: int,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T,k), experts (T,k) int32, probs (T,E))."""
    fn = _gating.moe_gating_cuda if _route(logits) else _gating.moe_gating_plain
    return fn(logits, k)


def launch_counts() -> Dict[str, int]:
    return {"paged_decode_attention": _paged.launches,
            "flash_attention": _flash.launches,
            "moe_gating": _gating.launches}


def reset_launch_counts() -> None:
    _paged.launches = 0
    _flash.launches = 0
    _gating.launches = 0
