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
* :func:`moe_gating_cuda` launches ``csrc/moe_gating.cu``'s gating
  alone, on given logits.

The main path folds the router product in: ``x (T, D) @ router (D, E)``
then the gating, ``x`` and ``router`` fp32 ->
(weights, ids, probs) as above.

* :func:`router_gating_plain` is the product with ``torch.matmul`` in
  fp64, rounded once to fp32 logits, then :func:`moe_gating_plain`.
* :func:`router_gating_cuda` launches the same source's router kernel: a
  thread-block cluster per tile of token rows, each block a slice of D
  (:func:`router_plan`), the partial logits summed in fp64 through
  distributed shared memory, rounded and gated on the chip.  It replaces
  the TPU kernel together with the product the JAX package leaves to XLA.
  Both entries count under one counter.

Why fp64 for the product: the JAX model's product is fp32, but two fp32
products of D = 2048 terms summed in different orders differ by an ulp or
two of a logit (9.5e-7 at |logit| in [4, 8)), and a gating weight moves
by up to twice a logit's move, past the 1e-6 the gating is held to.  A
float product is exact in a double, so a sum in fp64 rounded once gives
the correctly rounded fp32 logits in any order: the kernel and this plain
version agree on them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

#: launches of the CUDA kernel since the last reset (see ``ops``)
launches = 0

NEG = -1e30
#: the kernel's limits: one warp holds a row of at most 64 experts, and
#: the top-k rounds are unrolled up to 8
MAX_E = 64
MAX_K = 8

#: the router kernel's cluster sizes (blocks sharing a tile of token rows,
#: each taking a slice of the router's rows); past 8 is past the portable
#: limit
CLUSTERS = (1, 2, 4, 8, 16)
#: below ``LONG_T`` tokens (decode, short prompts) a cluster of
#: ``CLUSTER_SHORT`` blocks takes ``ROWS_SHORT`` token rows, so that 16 SMs
#: pull the router's bytes; from it on (long prompts) a cluster of
#: ``CLUSTER_LONG`` takes ``ROWS_LONG``: every tile re-reads the router
#: from L2, so fewer, taller tiles
ROWS_SHORT, ROWS_LONG, LONG_T = 8, 32, 512
CLUSTER_SHORT, CLUSTER_LONG = 16, 2

_SIGNATURES = {
    "repro_moe_gating": (ctypes.c_int, [
        *[ctypes.c_void_p] * 4,                         # logits w ids probs
        *[ctypes.c_int] * 3,                            # T E K
        ctypes.c_void_p,                                # stream
    ]),
    "repro_router_gating": (ctypes.c_int, [
        *[ctypes.c_void_p] * 5,                         # x router w ids probs
        *[ctypes.c_int] * 7,                            # T D E K C chunk rows
        ctypes.c_void_p,                                # stream
    ]),
    "repro_router_gating_empty": (ctypes.c_int, [
        *[ctypes.c_int] * 5,                            # T D C chunk rows
        ctypes.c_void_p,                                # stream
    ]),
    "repro_router_gating_smem_bytes": (ctypes.c_int, [ctypes.c_int]),
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


def router_plan(T: int, D: int, cluster: Optional[int] = None,
                ) -> Tuple[int, int, int]:
    """The router kernel's plan: (blocks per cluster, router rows per block
    (a multiple of 4), token rows per cluster).  Block r of a cluster takes
    router rows ``[r * chunk, (r + 1) * chunk)``.  ``cluster`` overrides the
    size the token count picks."""
    long = T >= LONG_T
    if cluster is None:
        cluster = CLUSTER_LONG if long else CLUSTER_SHORT
    chunk = 4 * -(-D // (4 * cluster))
    return cluster, chunk, ROWS_LONG if long else ROWS_SHORT


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """``x @ router`` summed in fp64, rounded once to fp32 (T, E)."""
    return (x.double() @ router.double()).float()


def router_gating_plain(x: torch.Tensor, router: torch.Tensor,
                        k: int) -> Gating:
    """x (T, D), router (D, E) -> :func:`moe_gating_plain` of
    :func:`router_logits`."""
    return moe_gating_plain(router_logits(x, router), k)


def _router_require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"router_gating_cuda: {msg}")


def router_gating_cuda(x: torch.Tensor, router: torch.Tensor, k: int,
                       cluster: Optional[int] = None) -> Gating:
    """Same contract as :func:`router_gating_plain`, on the card, for
    contiguous fp32 ``x`` (T, D) with ``D % 4 == 0`` and a contiguous fp32
    ``router`` (D, E), both 16-byte aligned, ``E <= 64``, ``k <= min(8,
    E)``."""
    global launches
    req = _router_require
    req(x.is_cuda and router.is_cuda and router.device == x.device,
        "x and router must be on one card")
    req(x.dim() == 2 and router.dim() == 2, "x must be (T, D), router (D, E)")
    req(x.dtype == router.dtype == torch.float32,
        "x and router must be float32")
    req(x.is_contiguous() and router.is_contiguous(),
        "x and router must be contiguous")
    T, D = x.shape
    E = router.shape[1]
    req(router.shape[0] == D, f"router has {router.shape[0]} rows, x {D}")
    req(D >= 4 and D % 4 == 0, f"D must be a multiple of 4, got {D}")
    req(x.data_ptr() % 16 == 0 and router.data_ptr() % 16 == 0,
        "x and router must be 16-byte aligned")
    req(1 <= E <= MAX_E, f"E must be in 1..{MAX_E}, got {E}")
    req(1 <= k <= min(MAX_K, E), f"k must be in 1..min({MAX_K}, E), "
        f"got k={k}, E={E}")
    req(cluster is None or cluster in CLUSTERS,
        f"cluster must be one of {CLUSTERS}")
    C, chunk, rows = router_plan(T, D, cluster)
    req(-(-T // rows) <= 65535, "too many tokens for one grid")
    dev = x.device
    w = torch.empty((T, k), device=dev)
    ids = torch.empty((T, k), dtype=torch.int32, device=dev)
    probs = torch.empty((T, E), device=dev)
    if T == 0:
        return w, ids, probs
    lib = build.load("moe_gating", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_router_gating(x.data_ptr(), router.data_ptr(), w.data_ptr(),
                                 ids.data_ptr(), probs.data_ptr(), T, D, E, k,
                                 C, chunk, rows, stream)
    build.check(rc, "router_gating")
    launches += 1
    return w, ids, probs
