"""Paged single-query decode attention: plain PyTorch version + CUDA kernel.

The continuous-batching engine keeps every slot's KV cache in a shared
page pool ``(P, page, Hk, hd)``; each slot owns a block table of page ids.
One decode step is single-query attention per slot over its pages, with
the current token's k/v (not yet in the pool) attended at position
``length``.  Pool positions ``>= length`` are masked.  Pools are fp32, or
int8 with per-(page, kv-head) fp32 dequant scales ``(P, Hk)``.

* :func:`paged_attention_plain` mirrors the JAX package's
  ``paged_attention_jnp`` op for op (gather, scatter the new token at
  ``length``, additive ``-1e9`` mask, fp32 softmax).  It runs on the CPU
  and is what the CUDA kernel is held against on the card.
* :func:`paged_attention_cuda` launches ``csrc/paged_attention.cu``, the
  hand-written replacement of the TPU kernel ``_paged_kernel``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

#: launches of the CUDA kernel since the last reset (see ``ops``)
launches = 0

_SIGNATURES = {
    "repro_paged_decode_attention": (ctypes.c_int, [
        ctypes.c_int,                                   # kv is int8
        *[ctypes.c_void_p] * 10,                        # pointers
        *[ctypes.c_int] * 6,                            # M Hk rep hd NP page
        ctypes.c_float,                                 # softmax scale
        ctypes.c_void_p,                                # stream
    ]),
}
_SUPPORTED_HD = (64, 128)
_SUPPORTED_REP = (1, 2, 4, 8, 16)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None,
                          ) -> torch.Tensor:
    """Gather-based paged decode attention.

    q (M, H, hd); k/v_pool (P, page, Hk, hd) fp32, or int8 with
    k/v_scales (P, Hk); block_tables (M, NP) int32; lengths (M,) int32
    cached tokens per slot; k/v_new (M, Hk, hd).  Returns (M, H, hd).

    The engine allocates the page for the current token before the call,
    so ``length < NP * page`` always holds; it is checked here rather than
    emulating ``dynamic_update_slice``'s clamp.
    """
    M, H, hd = q.shape
    P, page, Hk, _ = k_pool.shape
    NP = block_tables.shape[1]
    T = NP * page
    if M and int(lengths.max()) >= T:
        raise ValueError(f"a slot's length reaches past its {NP} pages")
    bt = block_tables.long()
    kg = k_pool[bt]                                    # (M, NP, page, Hk, hd)
    vg = v_pool[bt]
    if k_scales is not None:
        kg = kg.float() * k_scales[bt][:, :, None, :, None]
        vg = vg.float() * v_scales[bt][:, :, None, :, None]
    kg = kg.reshape(M, T, Hk, hd).float()
    vg = vg.reshape(M, T, Hk, hd).float()
    rows = torch.arange(M, device=q.device)
    ln = lengths.long()
    # place the current token at its true cache index (gathered copies,
    # the pool itself is untouched)
    kg[rows, ln] = k_new.float()
    vg[rows, ln] = v_new.float()
    kpos = torch.arange(T, device=q.device)
    amask = torch.where(kpos[None] <= ln[:, None], 0.0, -1e9).float()
    rep = H // Hk
    kk = kg.repeat_interleave(rep, dim=2)              # (M, T, H, hd)
    vv = vg.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("mhd,mthd->mht", q.float(), kk) * scale
    logits = logits + amask[:, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("mht,mthd->mhd", probs, vv)
    return out.to(q.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor,
                         k_scales: Optional[torch.Tensor] = None,
                         v_scales: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """Same contract as :func:`paged_attention_plain`, on the card.

    Reads only each slot's first ``ceil(length / page)`` pages, so padded
    block-table entries are never touched; a length past the table is
    clamped to it inside the kernel.
    """
    global launches
    M, H, hd = q.shape
    P, page, Hk, hd_p = k_pool.shape
    NP = block_tables.shape[1]
    quant = k_pool.dtype == torch.int8
    tensors = [q, k_pool, v_pool, block_tables, lengths, k_new, v_new]
    if quant:
        _require(k_scales is not None and v_scales is not None,
                 "int8 pools need k/v scales")
        tensors += [k_scales, v_scales]
    for t in tensors:
        _require(t.is_cuda and t.device == q.device, "all tensors on one card")
        _require(t.is_contiguous(), "tensors must be contiguous")
    _require(q.dtype == k_new.dtype == v_new.dtype == torch.float32,
             "q and k/v_new must be float32")
    _require(k_pool.dtype == v_pool.dtype
             and k_pool.dtype in (torch.float32, torch.int8),
             "pools must be float32 or int8")
    _require(v_pool.shape == k_pool.shape and hd_p == hd, "pool shapes")
    _require(H % Hk == 0 and H // Hk in _SUPPORTED_REP,
             f"H/Hk must be one of {_SUPPORTED_REP}")
    _require(hd in _SUPPORTED_HD, f"head dim must be one of {_SUPPORTED_HD}")
    _require(block_tables.dtype == lengths.dtype == torch.int32,
             "block tables and lengths must be int32")
    _require(tuple(block_tables.shape) == (M, NP)
             and tuple(lengths.shape) == (M,), "block table / lengths shape")
    _require(tuple(k_new.shape) == tuple(v_new.shape) == (M, Hk, hd),
             "k/v_new shape")
    if quant:
        _require(k_scales.dtype == v_scales.dtype == torch.float32
                 and tuple(k_scales.shape) == tuple(v_scales.shape) == (P, Hk),
                 "scales must be float32 (P, Hk)")
    out = torch.empty_like(q)
    if M == 0:
        return out
    lib = build.load("paged_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_paged_decode_attention(
        int(quant), q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), out.data_ptr(), M, Hk, H // Hk, hd, NP, page,
        1.0 / math.sqrt(hd), stream)
    build.check(rc, "paged_decode_attention")
    launches += 1
    return out
