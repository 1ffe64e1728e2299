"""MoE router gating: plain PyTorch version + CUDA kernel.

Softmax over the E experts of each token row, a K-step argmax-and-mask
top-k over the *probabilities* (ties go to the lowest expert index), and
the selected weights renormalised by ``max(sum, 1e-9)``:

    logits (T, E) fp32 -> weights (T, K) fp32, ids (T, K) int32,
                          probs (T, E) fp32

* :func:`moe_gating_plain` follows the TPU kernel's body
  (``_gating_kernel``) op for op: ``exp(x - max) / sum``, then K rounds of
  max, lowest index equal to it, mask it with ``NEG``, the total summed in
  selection order.  It is not ``torch.topk``, whose tie order is not
  specified.  Any T >= 0 is accepted: the JAX wrapper's ``T % 256``
  assert is not copied, since prefill sees ragged prompt lengths.
* :func:`moe_gating_cuda` launches ``csrc/moe_gating.cu``, the
  hand-written replacement of the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: launches of the CUDA kernel since the last reset (see ``ops``)
launches = 0

NEG = -1e30
#: the kernel's limits: one warp holds a row of at most 64 experts, and
#: the top-k rounds are unrolled up to 8
MAX_E = 64
MAX_K = 8

_SIGNATURES = {
    "repro_moe_gating": (ctypes.c_int, [
        *[ctypes.c_void_p] * 4,                         # logits w ids probs
        *[ctypes.c_int] * 3,                            # T E K
        ctypes.c_void_p,                                # stream
    ]),
}

Gating = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def moe_gating_plain(logits: torch.Tensor, k: int) -> Gating:
    """logits (T, E) -> (weights (T,k) fp32, ids (T,k) int32, probs (T,E))."""
    T, E = logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"moe_gating: need 1 <= k <= E, got k={k}, E={E}")
    dev = logits.device
    if T == 0:
        return (torch.zeros((0, k), device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, E), device=dev))
    x = logits.float()
    p = torch.exp(x - x.amax(dim=1, keepdim=True))
    probs = p / p.sum(dim=1, keepdim=True)
    lane = torch.arange(E, device=dev).expand(T, E)
    sel = probs
    total = torch.zeros((T, 1), device=dev)
    ws, ids = [], []
    for _ in range(k):
        cur = sel.amax(dim=1, keepdim=True)
        first = torch.where(sel >= cur, lane, E).amin(dim=1, keepdim=True)
        ws.append(cur)
        ids.append(first)
        sel = torch.where(lane == first, NEG, sel)
        total = total + cur
    w = torch.cat(ws, dim=1) / torch.clamp_min(total, 1e-9)
    return w, torch.cat(ids, dim=1).to(torch.int32), probs


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"moe_gating_cuda: {msg}")


def moe_gating_cuda(logits: torch.Tensor, k: int) -> Gating:
    """Same contract as :func:`moe_gating_plain`, on the card, for
    contiguous fp32 logits with ``E <= 64`` and ``k <= min(8, E)``."""
    global launches
    _require(logits.is_cuda, "logits must be on a card")
    _require(logits.dim() == 2, "logits must be (T, E)")
    _require(logits.dtype == torch.float32, "logits must be float32")
    _require(logits.is_contiguous(), "logits must be contiguous")
    T, E = logits.shape
    _require(1 <= E <= MAX_E, f"E must be in 1..{MAX_E}, got {E}")
    _require(1 <= k <= min(MAX_K, E), f"k must be in 1..min({MAX_K}, E), "
             f"got k={k}, E={E}")
    dev = logits.device
    w = torch.empty((T, k), device=dev)
    ids = torch.empty((T, k), dtype=torch.int32, device=dev)
    probs = torch.empty((T, E), device=dev)
    if T == 0:
        return w, ids, probs
    lib = build.load("moe_gating", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_moe_gating(logits.data_ptr(), w.data_ptr(), ids.data_ptr(),
                              probs.data_ptr(), T, E, k, stream)
    build.check(rc, "moe_gating")
    launches += 1
    return w, ids, probs
