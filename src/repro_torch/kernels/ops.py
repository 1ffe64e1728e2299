"""Public kernel entry points: the device of the inputs picks the path.

A CUDA tensor launches the hand-written kernel, and a failed build or
launch raises; a CPU tensor takes the plain PyTorch version.  There is no
fallback from one to the other.

Under autograd (grad enabled and an input that requires grad),
:func:`flash_attention` goes through ``models.chunked.FlashAttention``,
whose backward is the flash backward kernel, and :func:`router_gating`
through ``models.moe.RouterGating``, whose backward is the gating backward
kernel (each its plain version on the CPU).  The other entries have no
backward yet: they raise there, on both devices, rather than hand back a
tensor that cuts the graph.

Each CUDA wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` sets them to 0, so a caller can
show which kernels a run went through.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import flash_attention as _flash
from . import mlstm_scan as _mlstm
from . import moe_gating as _gating
from . import paged_attention as _paged


def _route(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def _under_grad(*ts: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _refuse_grad(name: str, *ts: Optional[torch.Tensor]) -> None:
    if _under_grad(*ts):
        raise RuntimeError(
            f"{name} has no backward yet: call it under torch.no_grad() or "
            "with inputs that do not require grad")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) (kv already head-repeated) -> (B, S, H, hd)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _under_grad(q, k, v):
        from ..models.chunked import FlashAttention
        return FlashAttention.apply(qt, kt, vt, causal, window).transpose(1, 2)
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
    _refuse_grad("paged_decode_attention", q, k_pool, v_pool, k_new, v_new,
                 k_scales, v_scales)
    fn = (_paged.paged_attention_cuda if _route(q)
          else _paged.paged_attention_plain)
    return fn(q, k_pool, v_pool, block_tables, lengths, k_new, v_new,
              k_scales, v_scales)


def moe_gating(logits: torch.Tensor, k: int,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T,k), experts (T,k) int32, probs (T,E))."""
    _refuse_grad("moe_gating", logits)
    fn = _gating.moe_gating_cuda if _route(logits) else _gating.moe_gating_plain
    return fn(logits, k)


def router_gating(x: torch.Tensor, router: torch.Tensor, k: int,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, D) @ router (D, E), then the gating: (weights (T,k), experts
    (T,k) int32, probs (T,E)).  Counts under ``moe_gating``; its backward
    under ``moe_gating_bwd``."""
    if _under_grad(x, router):
        from ..models.moe import RouterGating
        return RouterGating.apply(x, router, k)
    fn = (_gating.router_gating_cuda if _route(x)
          else _gating.router_gating_plain)
    return fn(x, router, k)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, C0: torch.Tensor,
               n0: torch.Tensor, m0: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunkwise mLSTM over q, k (pre-scaled by 1/sqrt(hd)), v (B,H,S,hd)
    and log gates (B,H,S) from the state C0 (B,H,hd,hd), n0 (B,H,hd),
    m0 (B,H).  Returns (h (B,H,S,hd), C_T, n_T, m_T)."""
    _refuse_grad("mlstm_scan", q, k, v, log_i, log_f, C0, n0, m0)
    fn = _mlstm.mlstm_scan_cuda if _route(q) else _mlstm.mlstm_scan_plain
    return fn(q, k, v, log_i, log_f, C0, n0, m0)


def launch_counts() -> Dict[str, int]:
    return {"paged_decode_attention": _paged.launches,
            "flash_attention": _flash.launches,
            "flash_attention_bwd": _flash.bwd_launches,
            "moe_gating": _gating.launches,
            "moe_gating_bwd": _gating.bwd_launches,
            "mlstm_scan": _mlstm.launches}


def reset_launch_counts() -> None:
    _paged.launches = 0
    _flash.launches = 0
    _flash.bwd_launches = 0
    _gating.launches = 0
    _gating.bwd_launches = 0
    _mlstm.launches = 0
