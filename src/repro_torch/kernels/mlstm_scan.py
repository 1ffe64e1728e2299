"""Chunkwise mLSTM scan: plain PyTorch version + CUDA kernel.

The xLSTM matrix-memory recurrence over a sequence, with log-space gates
and the ``exp(-m)`` stabiliser, carrying the state (C, n, m):

    q, k, v (B, H, S, hd), k pre-scaled by 1/sqrt(hd);
    log_i, log_f (B, H, S); C0 (B, H, hd, hd), n0 (B, H, hd), m0 (B, H)
    -> h (B, H, S, hd), C_T, n_T, m_T

Per chunk, with F the in-chunk cumulative sum of log_f: the causal decay
``logD[t, s] = F_t - F_s + i_s``, the row stabiliser
``m_t = max(max_s logD[t, s], F_t + m_prev)``, the output
``h = ((q kᵀ ⊙ exp(logD - m_t)) v + w_t q C) / max(|den|, exp(-m_t))``
with ``w_t = exp(F_t + m_prev - m_t)``, then the state moves to the
chunk's end.  ``m_t`` is the same maximum whatever the chunk width, so
every width computes the same function up to rounding.

* :func:`mlstm_scan_plain` is the JAX package's chunk body
  (``_make_chunk_fn`` and ``_chunk_state_update`` in
  ``repro/models/ssm.py``) scanned over chunks with the model's chunk
  rule: ``W = 256`` when it divides S, else one chunk of S.  It computes
  in the inputs' type when that is float64 (the exact reference the card
  is held to), else in float32.
* :func:`mlstm_scan_cuda` launches ``csrc/mlstm_scan.cu``, the
  hand-written replacement of the TPU kernel ``_mlstm_kernel``
  (``repro/kernels/mlstm_scan.py``).  Its chunk is its own (64 rows).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: launches of the CUDA kernel since the last reset (see ``ops``)
launches = 0

NEG = -1e30
#: the JAX package's chunk (``MLSTM_CHUNK``)
CHUNK = 256
#: the kernel's limits: each block owns BV value columns of C, and the
#: widest head whose (hd, BV) tile of C fits a block's shared memory
BV = 32
MAX_HD = 1024

_SIGNATURES = {
    "repro_mlstm_scan": (ctypes.c_int, [
        *[ctypes.c_void_p] * 12,                        # inputs, outputs
        *[ctypes.c_int] * 3,                            # BH S hd
        ctypes.c_void_p,                                # stream
    ]),
}

Scan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_i: torch.Tensor, log_f: torch.Tensor,
                     C0: torch.Tensor, n0: torch.Tensor,
                     m0: torch.Tensor) -> Scan:
    """See the module docstring.  Any S >= 1 and any start state."""
    S = q.shape[2]
    if S < 1:
        raise ValueError("mlstm_scan: need S >= 1")
    W = CHUNK if S % CHUNK == 0 else S          # run_mlstm's rule
    dt = torch.promote_types(q.dtype, torch.float32)
    C, n, m = C0.to(dt), n0.to(dt), m0.to(dt)
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    hs = []
    for c0 in range(0, S, W):
        qc, kc, vc = (t[:, :, c0:c0 + W].to(dt) for t in (q, k, v))
        li = log_i[:, :, c0:c0 + W].to(dt)                    # (B,H,W)
        lf = log_f[:, :, c0:c0 + W].to(dt)
        F = torch.cumsum(lf, dim=-1)
        logD = F[..., :, None] - F[..., None, :] + li[..., None, :]
        logD = torch.where(tri, logD, NEG)                    # (B,H,t,s)
        m_intra = logD.amax(dim=-1)
        b_inter = F + m[..., None]
        m_t = torch.maximum(m_intra, b_inter)
        scores = (qc @ kc.transpose(-1, -2)) * torch.exp(logD - m_t[..., None])
        num = scores @ vc
        den = scores.sum(dim=-1)
        w_int = torch.exp(b_inter - m_t)
        num = num + w_int[..., None] * (qc @ C)
        den = den + w_int * (qc @ n[..., None])[..., 0]
        norm = torch.maximum(den.abs(), torch.exp(-m_t))
        hs.append(num / norm[..., None])
        # the state at the chunk's end
        Ft = F[..., -1]
        inc = Ft[..., None] - F + li                          # F_T - F_s + i_s
        m_next = torch.maximum(m + Ft, inc.amax(dim=-1))
        wk = torch.exp(inc - m_next[..., None])
        carry = torch.exp(m + Ft - m_next)
        kw = kc * wk[..., None]
        C = carry[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = carry[..., None] * n + kw.sum(dim=-2)
        m = m_next
    return torch.cat(hs, dim=2), C, n, m


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mlstm_scan_cuda: {msg}")


def mlstm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_i: torch.Tensor, log_f: torch.Tensor,
                    C0: torch.Tensor, n0: torch.Tensor,
                    m0: torch.Tensor) -> Scan:
    """Same contract as :func:`mlstm_scan_plain`, on the card, for
    contiguous float32 tensors with ``hd`` a multiple of 32 up to 1024,
    any ``S >= 1`` and any start state."""
    global launches
    _require(q.dim() == 4, "q must be (B, H, S, hd)")
    B, H, S, hd = q.shape
    want = {"q": (q, (B, H, S, hd)), "k": (k, (B, H, S, hd)),
            "v": (v, (B, H, S, hd)), "log_i": (log_i, (B, H, S)),
            "log_f": (log_f, (B, H, S)), "C0": (C0, (B, H, hd, hd)),
            "n0": (n0, (B, H, hd)), "m0": (m0, (B, H))}
    for name, (t, shape) in want.items():
        _require(t.is_cuda and t.device == q.device,
                 f"{name} must be on q's card")
        _require(t.dtype == torch.float32, f"{name} must be float32, "
                 f"got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(tuple(t.shape) == shape,
                 f"{name} has shape {tuple(t.shape)}, want {shape}")
    _require(S >= 1, "need S >= 1")
    _require(hd % BV == 0 and BV <= hd <= MAX_HD,
             f"hd must be a multiple of {BV} in {BV}..{MAX_HD}, got {hd}")
    h = torch.empty_like(q)
    C = torch.empty_like(C0)
    n = torch.empty_like(n0)
    m = torch.empty_like(m0)
    if B * H == 0:
        return h, C, n, m
    lib = build.load("mlstm_scan", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_mlstm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
        log_f.data_ptr(), C0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
        h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
        B * H, S, hd, stream)
    build.check(rc, "mlstm_scan")
    launches += 1
    return h, C, n, m
