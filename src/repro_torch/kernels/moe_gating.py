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

The backward of the main path (training), the VJP of ``x @ router`` then
the gating as XLA differentiates the JAX model's ``topk_gating``: with
``s = max(sum_j p[e_j], 1e-9)``, ``dp = dprobs`` plus ``dw_j / s - (sum_i
dw_i w_i) / s`` on each selected expert ``e_j`` (nothing flows through a
clamped ``s``), ``dlogits = p * (dp - sum_e p_e dp_e)``, ``dx = dlogits @
router^T`` and ``drouter = x^T @ dlogits``:

* :func:`gating_bwd_plain` and :func:`gating_bwd_cuda` (``csrc/
  moe_gating_bwd.cu``, one warp per token row) compute ``dlogits``; the
  kernel counts under its own counter, ``bwd_launches``.
* :func:`router_gating_bwd_plain` and :func:`router_gating_bwd_cuda` add
  the two products, plain ``torch.matmul`` in the working dtype (TF32 stays
  off), as the JAX package leaves the router product and its gradient to
  XLA.

The plain versions compute in the promotion of their inputs with fp32:
fp32 stays fp32, float64 stays float64 (a float64 reference run on the
CPU is float64 from end to end).

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

#: launches of the CUDA kernels since the last reset (see ``ops``): the
#: forward (router and logits-in entries) and the gating backward
launches = 0
bwd_launches = 0

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

_BWD_SIGNATURES = {
    "repro_gating_bwd": (ctypes.c_int, [
        *[ctypes.c_void_p] * 6,                 # probs w ids dw dprobs dlogits
        *[ctypes.c_int] * 3,                    # T E K
        ctypes.c_void_p,                        # stream
    ]),
    "repro_gating_bwd_empty": (ctypes.c_int, [ctypes.c_int, ctypes.c_void_p]),
}

Gating = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _work_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: the promotion of the inputs'
    dtypes with fp32."""
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def moe_gating_plain(logits: torch.Tensor, k: int) -> Gating:
    """logits (T, E) -> (weights (T,k), ids (T,k) int32, probs (T,E)), in
    fp32 (float64 for float64 logits)."""
    T, E = logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"moe_gating: need 1 <= k <= E, got k={k}, E={E}")
    dev = logits.device
    dt = _work_dtype(logits)
    if T == 0:
        return (torch.zeros((0, k), dtype=dt, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, E), dtype=dt, device=dev))
    x = logits.to(dt)
    p = torch.exp(x - x.amax(dim=1, keepdim=True))
    probs = p / p.sum(dim=1, keepdim=True)
    lane = torch.arange(E, device=dev).expand(T, E)
    sel = probs
    total = torch.zeros((T, 1), dtype=dt, device=dev)
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
    """``x @ router`` summed in fp64, rounded once to fp32 (T, E); float64
    inputs keep the float64 sum."""
    return (x.double() @ router.double()).to(_work_dtype(x, router))


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


# ---------------------------------------------------------------- backward

def gating_bwd_plain(weights: torch.Tensor, experts: torch.Tensor,
                     probs: torch.Tensor, dweights: torch.Tensor,
                     dprobs: torch.Tensor) -> torch.Tensor:
    """The gating's VJP: (weights (T,K), experts (T,K), probs (T,E)) and
    the cotangents (dweights (T,K), dprobs (T,E)) -> dlogits (T,E), in the
    promotion of the inputs with fp32.  ``s`` is the selected probabilities
    summed in selection order, as the forward sums them."""
    dt = _work_dtype(weights, probs, dweights, dprobs)
    p, w = probs.to(dt), weights.to(dt)
    dw, dp = dweights.to(dt), dprobs.to(dt)
    ids = experts.long()
    sel = p.gather(1, ids)
    total = torch.zeros_like(sel[:, :1])
    c = torch.zeros_like(total)
    for j in range(ids.shape[1]):
        total = total + sel[:, j:j + 1]
        c = c + dw[:, j:j + 1] * w[:, j:j + 1]
    s = torch.clamp_min(total, 1e-9)
    coef = torch.where(total >= 1e-9, c / s, 0)
    dp = dp.scatter_add(1, ids, dw / s - coef)
    return p * (dp - (p * dp).sum(dim=1, keepdim=True))


def router_gating_bwd_plain(x: torch.Tensor, router: torch.Tensor,
                            weights: torch.Tensor, experts: torch.Tensor,
                            probs: torch.Tensor, dweights: torch.Tensor,
                            dprobs: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The VJP of :func:`router_gating_plain` at its outputs: -> (dx (T,D),
    drouter (D,E)), in the promotion of the inputs with fp32."""
    dl = gating_bwd_plain(weights, experts, probs, dweights, dprobs)
    dt = _work_dtype(x, router, dl)
    dl = dl.to(dt)
    return dl @ router.to(dt).T, x.to(dt).T @ dl


def _bwd_require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"router_gating_bwd_cuda: {msg}")


def gating_bwd_cuda(weights: torch.Tensor, experts: torch.Tensor,
                    probs: torch.Tensor, dweights: torch.Tensor,
                    dprobs: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`gating_bwd_plain`, on the card
    (``csrc/moe_gating_bwd.cu``), for contiguous fp32 weights, probs and
    cotangents and int32 ids of one row's distinct experts, ``E <= 64``,
    ``K <= min(8, E)``.  Returns dlogits (T, E) fp32."""
    global bwd_launches
    req = _bwd_require
    ts = (weights, experts, probs, dweights, dprobs)
    req(all(t.is_cuda and t.device == probs.device for t in ts),
        "the gating and its cotangents must be on one card")
    req(all(t.dim() == 2 for t in ts), "every input must be 2-d")
    req(all(t.dtype == torch.float32 for t in (weights, probs, dweights,
                                                dprobs)),
        "weights, probs and the cotangents must be float32")
    req(experts.dtype == torch.int32, "experts must be int32")
    req(all(t.is_contiguous() for t in ts), "every input must be contiguous")
    T, E = probs.shape
    K = experts.shape[1]
    req(dprobs.shape == (T, E), f"dprobs is {tuple(dprobs.shape)}, probs "
        f"{(T, E)}")
    req(all(t.shape == (T, K) for t in (weights, experts, dweights)),
        "weights, experts and dweights must be (T, K)")
    req(1 <= E <= MAX_E, f"E must be in 1..{MAX_E}, got {E}")
    req(1 <= K <= min(MAX_K, E), f"k must be in 1..min({MAX_K}, E), got "
        f"k={K}, E={E}")
    dl = torch.empty((T, E), device=probs.device)
    if T == 0:
        return dl
    lib = build.load("moe_gating_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(probs.device).cuda_stream
    rc = lib.repro_gating_bwd(probs.data_ptr(), weights.data_ptr(),
                              experts.data_ptr(), dweights.data_ptr(),
                              dprobs.data_ptr(), dl.data_ptr(), T, E, K,
                              stream)
    build.check(rc, "moe_gating_bwd")
    bwd_launches += 1
    return dl


def router_gating_bwd_cuda(x: torch.Tensor, router: torch.Tensor,
                           weights: torch.Tensor, experts: torch.Tensor,
                           probs: torch.Tensor, dweights: torch.Tensor,
                           dprobs: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`router_gating_bwd_plain`, on the card:
    :func:`gating_bwd_cuda`, then the two products in fp32 (``x`` and
    ``router`` fp32 on the same card)."""
    _bwd_require(x.is_cuda and router.is_cuda and x.device == router.device
                 == probs.device, "x, router and the gating must be on one "
                 "card")
    _bwd_require(x.dtype == router.dtype == torch.float32,
                 "x and router must be float32")
    _bwd_require(x.dim() == 2 and router.dim() == 2
                 and x.shape == (probs.shape[0], router.shape[0])
                 and router.shape[1] == probs.shape[1],
                 "x must be (T, D) and router (D, E)")
    dl = gating_bwd_cuda(weights, experts, probs, dweights, dprobs)
    return dl @ router.T, x.T @ dl
