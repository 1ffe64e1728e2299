"""Flash (streaming-softmax) attention: plain PyTorch + CUDA kernels, forward
and backward.

Contract of the JAX package's ``flash_attention_bhsd``: q, k, v are
``(B, H, S, hd)`` with k/v already head-repeated; causal attention puts
query ``i`` at absolute position ``Sk - Sq + i`` (key ``j`` at ``j``),
``window > 0`` keeps only the trailing ``window`` keys, and
``causal=False`` attends everywhere.  fp32 or bf16 in, fp32 running
statistics, output in q's dtype.  Any ``S`` is accepted: ragged edges are
masked, there is no block-multiple requirement.

* :func:`flash_attention_plain` is the forward of the JAX package's
  ``chunked.flash_attention_jnp`` (key blocks of ~1024 with an online
  softmax and an additive ``-1e30`` mask), in this layout; with
  ``return_lse`` it also returns the row logsumexps, as ``_flash_fwd_impl``.
* :func:`flash_attention_bwd_plain` is that function's custom VJP
  (``chunked._flash_bwd``): dq, dk, dv recomputed from the saved lse.
* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu``, the
  hand-written replacement of the TPU kernel ``_flash_kernel``, and
  :func:`flash_attention_bwd_cuda` launches ``csrc/flash_attention_bwd.cu``
  (no TPU twin: the JAX gradient is jnp), fp32 only.

The plain versions compute in float32, or in float64 for float64 inputs.
Causal rows must each see at least one key, so ``causal`` with
``Sq > Sk`` is refused by all four.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import build

#: launches of the forward and backward CUDA kernels since the last reset
#: (see ``ops``)
launches = 0
bwd_launches = 0

NEG_INF = -1e30
#: key block of the plain version (the JAX streaming form's default)
K_BLOCK = 1024

_SIGNATURES = {
    "repro_flash_attention_fwd": (ctypes.c_int, [
        ctypes.c_int,                                   # inputs are bf16
        *[ctypes.c_void_p] * 5,                         # q k v out lse
        *[ctypes.c_int] * 5,                            # B H Sq Sk hd
        *[ctypes.c_longlong] * 12,                      # (b, h, s) strides
        ctypes.c_int, ctypes.c_int,                     # causal, window
        ctypes.c_float,                                 # softmax scale
        ctypes.c_void_p,                                # stream
    ]),
}
_BWD_SIGNATURES = {
    "repro_flash_attention_bwd": (ctypes.c_int, [
        *[ctypes.c_void_p] * 10,            # q k v out dout lse D dq dk dv
        *[ctypes.c_int] * 5,                # B H Sq Sk hd
        ctypes.POINTER(ctypes.c_longlong),  # 8 x (b, h, s) strides
        ctypes.c_int, ctypes.c_int,         # causal, window
        ctypes.c_float,                     # softmax scale
        ctypes.c_void_p,                    # stream
    ]),
}
_SUPPORTED_HD = (64, 128)


def _check_causal(causal: bool, Sq: int, Sk: int) -> None:
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with Sq={Sq} > Sk={Sk} leaves "
                         "rows with no visible key")


def _key_blocks(Sk: int) -> int:
    """The JAX version's key blocking: Sk // K_BLOCK equal blocks (the last
    one shorter when Sk does not divide).  Returns the block length."""
    nkb = max(Sk // K_BLOCK, 1)
    return -(-Sk // nkb)


def _block_mask(qpos: torch.Tensor, k0: int, n: int, window: int,
                dtype: torch.dtype) -> torch.Tensor:
    """(Sq, n) additive mask of keys k0 .. k0 + n for causal (+ window)."""
    kpos = k0 + torch.arange(n, device=qpos.device)
    ok = kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > (qpos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """q (B,H,Sq,hd); k, v (B,H,Sk,hd).  Returns (B,H,Sq,hd) in q's dtype,
    and with ``return_lse`` also the row logsumexps (B,H,Sq)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    _check_causal(causal, Sq, Sk)
    up = torch.promote_types(q.dtype, torch.float32)
    q_offset = Sk - Sq if causal else 0
    scale = 1.0 / math.sqrt(hd)
    kb = _key_blocks(Sk)
    dev = q.device
    qf = q.to(up) * scale
    qpos = q_offset + torch.arange(Sq, device=dev)
    acc = torch.zeros(B, H, Sq, hd, dtype=up, device=dev)
    m = torch.full((B, H, Sq), NEG_INF, dtype=up, device=dev)
    l = torch.zeros(B, H, Sq, dtype=up, device=dev)
    for k0 in range(0, Sk, kb):
        kblk = k[:, :, k0:k0 + kb].to(up)
        vblk = v[:, :, k0:k0 + kb].to(up)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk)
        if causal:
            s = s + _block_mask(qpos, k0, kblk.shape[2], window, up)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l_safe)
    return out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's VJP from its residuals: q, out, dout (B,H,Sq,hd); k, v
    (B,H,Sk,hd); lse (B,H,Sq).  Returns (dq, dk, dv) in the inputs' dtypes.
    Key blocks as the forward's; per block P = exp(S - lse), dV = P^T dO,
    dP = dO V^T, dS = P (dP - D) with D = sum(dO * out), dQ += dS K scale,
    dK = dS^T (q scale)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    _check_causal(causal, Sq, Sk)
    up = torch.promote_types(q.dtype, torch.float32)
    q_offset = Sk - Sq if causal else 0
    scale = 1.0 / math.sqrt(hd)
    kb = _key_blocks(Sk)
    qf = q.to(up) * scale
    do = dout.to(up)
    lse = lse.to(up)
    Dv = torch.sum(do * out.to(up), dim=-1)                     # (B,H,Sq)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros(B, H, Sq, hd, dtype=up, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, Sk, kb):
        kblk = k[:, :, k0:k0 + kb].to(up)
        vblk = v[:, :, k0:k0 + kb].to(up)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk)
        if causal:
            s = s + _block_mask(qpos, k0, kblk.shape[2], window, up)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, do))
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vblk)
        ds = p * (dp - Dv[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kblk) * scale
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf))  # qf has scale
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Rows start on 16 bytes: the data pointer and every (b, h, s) stride
    of a dim longer than 1 (in elements, fp32) a multiple of 4."""
    return t.data_ptr() % 16 == 0 and all(
        s % 4 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """Same contract as :func:`flash_attention_plain`, on the card.

    Strided views are taken as they are (the last dim must be dense), so
    a ``(B, S, H, hd)`` tensor transposed to ``(B, H, S, hd)`` costs no
    copy; the output has q's memory layout, and lse is fp32 (B, H, Sq).
    """
    global launches
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    _check_causal(causal, Sq, Sk)
    for t in (q, k, v):
        _require(t.is_cuda and t.device == q.device, "all tensors on one card")
        _require(t.stride(-1) == 1, "the head dim must be dense")
        _require(t.dtype == q.dtype, "q, k, v must share a dtype")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             "inputs must be float32 or bfloat16")
    _require(tuple(k.shape) == tuple(v.shape) == (B, H, Sk, hd),
             "k/v shape must be (B, H, Sk, hd) matching q")
    _require(hd in _SUPPORTED_HD, f"head dim must be one of {_SUPPORTED_HD}")
    # the kernel moves 4 elements per access
    vec = 4 * q.element_size()
    for t in (q, k, v):
        _require(t.data_ptr() % vec == 0
                 and all(s % 4 == 0 for s in t.stride()[:3]),
                 "rows must be 4-element aligned")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() > 0:
        lib = build.load("flash_attention", _SIGNATURES)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        rc = lib.repro_flash_attention_fwd(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, B, H, Sq, Sk, hd,
            *strides, int(causal), int(window), 1.0 / math.sqrt(hd), stream)
        build.check(rc, "flash_attention")
        launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as :func:`flash_attention_bwd_plain`, on the card, fp32
    only.  Strided views are taken as they are (the last dim must be
    dense; a ``dout`` whose last dim is not is copied once, and so is any
    of q, k, v, dout whose rows are not 16-byte aligned, since the kernel
    stages rows by 16-byte copies); dq, dk, dv have q's, k's and v's
    memory layouts."""
    global bwd_launches
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    _check_causal(causal, Sq, Sk)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    for t in (q, k, v, out, dout, lse):
        _require(t.is_cuda and t.device == q.device, "all tensors on one card")
        _require(t.dtype == torch.float32,
                 "the backward kernel takes float32 only")
    for t in (q, k, v, out, dout):
        _require(t.stride(-1) == 1, "the head dim must be dense")
    _require(tuple(k.shape) == tuple(v.shape) == (B, H, Sk, hd),
             "k/v shape must be (B, H, Sk, hd) matching q")
    _require(tuple(out.shape) == tuple(dout.shape) == (B, H, Sq, hd),
             "out/dout shape must be q's")
    _require(tuple(lse.shape) == (B, H, Sq) and lse.is_contiguous(),
             "lse must be a dense (B, H, Sq) tensor")
    _require(hd in _SUPPORTED_HD, f"head dim must be one of {_SUPPORTED_HD}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v, dout = (t if _rows_aligned(t) else t.clone()
                     for t in (q, k, v, dout))
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]])
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, Sq, Sk, hd, strides, int(causal),
        int(window), 1.0 / math.sqrt(hd), stream)
    build.check(rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
