"""Differentiable flash attention: the port's twin of the JAX package's
``chunked.flash_attention_jnp`` and its custom VJP.

:class:`FlashAttention` is a ``torch.autograd.Function`` over ``(B, H, S,
hd)`` tensors (k/v already head-repeated).  Its forward runs the flash
forward with the row logsumexps and saves (q, k, v, out, lse); its
backward recomputes the block probabilities from them instead of keeping
the S x S matrix.  On the card both directions are the hand-written CUDA
kernels (``flash_attention_cuda(..., return_lse=True)`` and
``flash_attention_bwd_cuda``); on the CPU they are the plain versions.
Both devices go through this one ``Function``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import flash_attention as _flash
from ..kernels.ops import _route


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, window)``: q (B,H,Sq,hd),
    k/v (B,H,Sk,hd) -> (B,H,Sq,hd).  Causal query i sits at position
    Sk - Sq + i."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True, window: int = 0) -> torch.Tensor:
        fwd = (_flash.flash_attention_cuda if _route(q)
               else _flash.flash_attention_plain)
        out, lse = fwd(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            Optional[bool], Optional[int]]:
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (_flash.flash_attention_bwd_cuda if _route(q)
               else _flash.flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None
