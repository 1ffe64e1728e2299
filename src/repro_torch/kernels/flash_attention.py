"""Flash (streaming-softmax) attention forward: plain PyTorch + CUDA kernel.

Contract of the JAX package's ``flash_attention_bhsd``: q, k, v are
``(B, H, S, hd)`` with k/v already head-repeated; causal attention puts
query ``i`` at absolute position ``Sk - Sq + i`` (key ``j`` at ``j``),
``window > 0`` keeps only the trailing ``window`` keys, and
``causal=False`` attends everywhere.  fp32 or bf16 in, fp32 running
statistics, output in q's dtype.  Any ``S`` is accepted: ragged edges are
masked, there is no block-multiple requirement.

* :func:`flash_attention_plain` is the forward of the JAX package's
  ``chunked.flash_attention_jnp`` (key blocks of ~1024 with an online
  softmax and an additive ``-1e30`` mask), in this layout.
* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu``, the
  hand-written replacement of the TPU kernel ``_flash_kernel``.

Causal rows must each see at least one key, so ``causal`` with
``Sq > Sk`` is refused by both.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

#: launches of the CUDA kernel since the last reset (see ``ops``)
launches = 0

NEG_INF = -1e30
#: key block of the plain version (the JAX streaming form's default)
K_BLOCK = 1024

_SIGNATURES = {
    "repro_flash_attention_fwd": (ctypes.c_int, [
        ctypes.c_int,                                   # inputs are bf16
        *[ctypes.c_void_p] * 4,                         # q k v out
        *[ctypes.c_int] * 5,                            # B H Sq Sk hd
        *[ctypes.c_longlong] * 12,                      # (b, h, s) strides
        ctypes.c_int, ctypes.c_int,                     # causal, window
        ctypes.c_float,                                 # softmax scale
        ctypes.c_void_p,                                # stream
    ]),
}
_SUPPORTED_HD = (64, 128)


def _check_causal(causal: bool, Sq: int, Sk: int) -> None:
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with Sq={Sq} > Sk={Sk} leaves "
                         "rows with no visible key")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """q (B,H,Sq,hd); k, v (B,H,Sk,hd).  Returns (B,H,Sq,hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    _check_causal(causal, Sq, Sk)
    q_offset = Sk - Sq if causal else 0
    scale = 1.0 / math.sqrt(hd)
    # the JAX version's key blocking: Sk // K_BLOCK equal blocks (the
    # last one shorter when Sk does not divide)
    nkb = max(Sk // K_BLOCK, 1)
    kb = -(-Sk // nkb)
    dev = q.device
    qf = q.float() * scale
    qpos = q_offset + torch.arange(Sq, device=dev)
    acc = torch.zeros(B, H, Sq, hd, dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, Sq, dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, kb):
        kblk = k[:, :, k0:k0 + kb].float()
        vblk = v[:, :, k0:k0 + kb].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk)
        if causal:
            kpos = k0 + torch.arange(kblk.shape[2], device=dev)
            ok = kpos[None, :] <= qpos[:, None]
            if window > 0:
                ok &= kpos[None, :] > (qpos[:, None] - window)
            s = s + torch.where(ok, 0.0, NEG_INF).float()
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return (acc / l_safe[..., None]).to(q.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Same contract as :func:`flash_attention_plain`, on the card.

    Strided views are taken as they are (the last dim must be dense), so
    a ``(B, S, H, hd)`` tensor transposed to ``(B, H, S, hd)`` costs no
    copy; the output has q's memory layout.
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
    if q.numel() == 0:
        return out
    lib = build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.repro_flash_attention_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, H, Sq, Sk, hd, *strides,
        int(causal), int(window), 1.0 / math.sqrt(hd), stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out
