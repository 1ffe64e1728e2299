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
  hand-written replacement of the TPU kernel ``_paged_kernel``, in two
  passes: a split pass over pieces of each slot's pages
  (:func:`split_pages` plans them from the shapes alone) writes partial
  softmax states, and a merge pass folds in the current token and the
  partials in split order.  :func:`paged_split_plain` and
  :func:`paged_merge_plain` are those two passes in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

#: launches of the CUDA kernel since the last reset (see ``ops``)
launches = 0

_SIGNATURES = {
    "repro_paged_decode_attention": (ctypes.c_int, [
        ctypes.c_int,                                   # kv is int8
        *[ctypes.c_void_p] * 11,                        # pointers, scratch
        *[ctypes.c_int] * 7,                            # M Hk rep hd NP page pps
        ctypes.c_float,                                 # softmax scale
        ctypes.c_void_p,                                # stream
    ]),
    "repro_paged_split_config": (ctypes.c_int, [
        *[ctypes.c_int] * 3,                            # kv is int8, hd, rep
        *[ctypes.POINTER(ctypes.c_int)] * 2,            # smem bytes, blocks/SM
    ]),
}
_SUPPORTED_HD = (64, 128)
_SUPPORTED_REP = (1, 2, 4, 8, 16)

#: H100 SXM streaming multiprocessors
SMS = 132
#: blocks the split plan aims for when every slot is full: several per SM,
#: since short slots leave most of them empty
TARGET_BLOCKS = 16 * SMS
#: a split covers at least this many cache rows (four 32-row tiles)
MIN_SPLIT_ROWS = 128


def split_pages(NP: int, page: int, M: int, Hk: int) -> int:
    """Pages per split of the kernel's split pass, from the shapes alone.

    The smallest width of at least ``MIN_SPLIT_ROWS`` rows for which
    ``M * Hk * ceil(NP / width)`` blocks stay within ``TARGET_BLOCKS``, and
    never more than ``NP``.  It reads no lengths: the engine calls the
    kernel once per layer of every decode step, and a length read from the
    card would stall the host on each call.
    """
    want = -(-NP * M * Hk // TARGET_BLOCKS)
    return max(1, min(NP, max(-(-MIN_SPLIT_ROWS // page), want)))


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
    so ``length < T = NP * page`` holds there.  A length at or past ``T``
    follows the reference, whose ``dynamic_update_slice`` clamps the
    current token's write to row ``T - 1``: cached rows ``0..T-2`` and the
    current token, as at ``length = T - 1``.
    """
    M, H, hd = q.shape
    P, page, Hk, _ = k_pool.shape
    NP = block_tables.shape[1]
    T = NP * page
    bt = block_tables.long()
    kg = k_pool[bt]                                    # (M, NP, page, Hk, hd)
    vg = v_pool[bt]
    if k_scales is not None:
        kg = kg.float() * k_scales[bt][:, :, None, :, None]
        vg = vg.float() * v_scales[bt][:, :, None, :, None]
    kg = kg.reshape(M, T, Hk, hd).float()
    vg = vg.reshape(M, T, Hk, hd).float()
    rows = torch.arange(M, device=q.device)
    ln = _clamped(lengths, T)
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


def _clamped(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """Lengths as the reference reads them: at most ``T - 1``."""
    return lengths.long().clamp(max=T - 1)


def _dequant(pool: torch.Tensor, scales: Optional[torch.Tensor],
             bt: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The slots' pages (M, NP * page, Hk, hd) in ``dtype``."""
    M, NP = bt.shape
    g = pool[bt].to(dtype)                             # (M, NP, page, Hk, hd)
    if scales is not None:
        g = g * scales[bt].to(dtype)[:, :, None, :, None]
    return g.reshape(M, NP * pool.shape[1], *pool.shape[2:])


def paged_split_plain(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor, pages_per_split: int,
                      k_scales: Optional[torch.Tensor] = None,
                      v_scales: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's split pass: online-softmax partials over each split of
    ``pages_per_split`` pages of each slot's cache (the current token is
    not in it), in q's dtype.

    Returns (m, l, acc): m and l (M, Hk, S, rep), acc (M, Hk, S, rep, hd),
    S = ceil(NP / pages_per_split).  A split with no cached row is empty:
    m = -inf, l = 0, acc = 0.  A length at or past ``NP * page`` reads as
    ``NP * page - 1``, as in :func:`paged_attention_plain`.
    """
    M, H, hd = q.shape
    page, Hk = k_pool.shape[1], k_pool.shape[2]
    NP = block_tables.shape[1]
    W = pages_per_split * page
    S = -(-NP // pages_per_split)
    bt = block_tables.long()
    pad = (0, 0, 0, 0, 0, S * W - NP * page)
    kg = F.pad(_dequant(k_pool, k_scales, bt, q.dtype), pad)
    vg = F.pad(_dequant(v_pool, v_scales, bt, q.dtype), pad)
    kg = kg.reshape(M, S, W, Hk, hd)
    vg = vg.reshape(M, S, W, Hk, hd)
    qr = q.reshape(M, Hk, H // Hk, hd)
    s = torch.einsum("mkrd,mswkd->mksrw", qr, kg) / math.sqrt(hd)
    pos = torch.arange(S * W, device=q.device).reshape(S, W)
    live = pos[None] < _clamped(lengths, NP * page)[:, None, None]  # (M, S, W)
    s = s.masked_fill(~live[:, None, :, None, :], -math.inf)
    m = s.amax(-1)
    p = torch.exp(s - m.masked_fill(m == -math.inf, 0.0)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("mksrw,mswkd->mksrd", p, vg)
    return m, l, acc


def paged_merge_plain(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      acc: torch.Tensor) -> torch.Tensor:
    """The kernel's merge pass: the current token, then the partials of
    :func:`paged_split_plain`, into the attention output (M, H, hd).  An
    empty partial (m = -inf, l = 0) adds nothing."""
    M, H, hd = q.shape
    Hk = k_new.shape[1]
    qr = q.reshape(M, Hk, H // Hk, hd)
    s = torch.einsum("mkrd,mkd->mkr", qr, k_new.to(q.dtype)) / math.sqrt(hd)
    mx = torch.maximum(s, m.amax(2))                   # (M, Hk, rep)
    empty = l == 0
    w = torch.exp(m - mx[:, :, None]).masked_fill(empty, 0.0)
    w0 = torch.exp(s - mx)
    den = w0 + (w * l).sum(2)
    num = (w0[..., None] * v_new.to(q.dtype)[:, :, None]
           + (w[..., None] * acc.masked_fill(empty[..., None], 0.0)).sum(2))
    return (num / den[..., None]).reshape(M, H, hd)


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
    block-table entries are never touched; a length at or past the table
    is read as ``NP * page - 1`` inside the kernel, as the plain version
    reads it.  Both passes count as one launch.
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
    pps = split_pages(NP, page, M, Hk)
    S = -(-NP // pps)
    _require(NP > 0 and M <= 65535 and S <= 65535, "grid shape")
    scratch = torch.empty(M * H * S * (hd + 2), dtype=torch.float32,
                          device=q.device)
    lib = build.load("paged_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_paged_decode_attention(
        int(quant), q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), out.data_ptr(), scratch.data_ptr(), M, Hk, H // Hk,
        hd, NP, page, pps, 1.0 / math.sqrt(hd), stream)
    build.check(rc, "paged_decode_attention")
    launches += 1
    return out


def split_config(kv_int8: bool, hd: int, rep: int) -> Dict[str, int]:
    """The split pass's dynamic shared memory and resident blocks per SM
    for one instantiation, as the card reports them."""
    lib = build.load("paged_attention", _SIGNATURES)
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    build.check(lib.repro_paged_split_config(int(kv_int8), hd, rep,
                                             ctypes.byref(smem),
                                             ctypes.byref(blocks)),
                "paged_split_config")
    return {"dynamic_smem_bytes": smem.value, "blocks_per_sm": blocks.value}
