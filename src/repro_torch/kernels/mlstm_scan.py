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

* :func:`mlstm_chunk` is the JAX package's chunk body
  (``_make_chunk_fn`` and, for the state, ``_chunk_state_update``, here
  :func:`mlstm_chunk_state`, in ``repro/models/ssm.py``).
  :func:`mlstm_scan_plain` scans it over chunks, by default with the
  model's chunk rule (:func:`chunk_width`): ``W = 256`` when it divides
  S, else one chunk of S.  It computes in the inputs' type when that is
  float64 (the exact reference the card is held to), else in float32.
  The backward of ``models.ssm.MLSTMScan`` recomputes the same chunk
  function, chunk by chunk.
* :func:`mlstm_scan_cuda` launches ``csrc/mlstm_scan.cu``, the
  hand-written replacement of the TPU kernel ``_mlstm_kernel``
  (``repro/kernels/mlstm_scan.py``), in two passes over 64-row chunks:
  a parallel pass per chunk computes everything that does not depend on
  C, and a walk per 32 columns of C does the rest.
  :func:`mlstm_prep_plain` and :func:`mlstm_walk_plain` are the two
  passes in plain PyTorch, with what the first hands the second
  (:class:`Prep`); :func:`mlstm_prep_cuda` runs the first pass alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

#: launches of the CUDA kernel since the last reset (see ``ops``)
launches = 0

NEG = -1e30
#: the JAX package's chunk (``MLSTM_CHUNK``)
CHUNK = 256
#: the CUDA kernel's chunk (rows per chunk), the plain passes' default; on
#: the card the views of the scratch take the width the library reports
#: (``repro_mlstm_scratch_layout``)
KERNEL_CHUNK = 64
#: the kernel's limits: each walk block owns BV value columns of C, and
#: the widest head whose (hd, BV) tile of C fits a block's shared memory
BV = 32
MAX_HD = 1024

_SIGNATURES = {
    "repro_mlstm_scratch_layout": (None, [
        *[ctypes.c_int] * 3,                            # BH S hd
        ctypes.POINTER(ctypes.c_longlong),              # out[10]
    ]),
    "repro_mlstm_walk_smem_bytes": (ctypes.c_int, [ctypes.c_int]),
    "repro_mlstm_prep": (ctypes.c_int, [
        *[ctypes.c_void_p] * 7,                         # q k li lf m0 scratch m
        *[ctypes.c_int] * 3,                            # BH S hd
        ctypes.c_void_p,                                # stream
    ]),
    "repro_mlstm_scan": (ctypes.c_int, [
        *[ctypes.c_void_p] * 13,                        # inputs, scratch, outputs
        *[ctypes.c_int] * 3,                            # BH S hd
        ctypes.c_void_p,                                # stream
    ]),
}

Scan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class Prep(NamedTuple):
    """What the first pass hands the walk, for nC chunks of W rows (rows
    past S hold zeros): per chunk n's increment ``nk`` = Σ_s k_s wk_s (B,
    H, nC, hd; float64 on the card) and the causal score tile ``P = (q kᵀ)
    ⊙ exp(logD - m_t)`` (B, H, nC, W, W); per row (B, H, nC·W) ``w`` =
    w_t, ``mt`` = m_t, ``rs`` = the row sums of P, ``wk`` = the chunk-end
    weights exp(F_T - F_s + i_s - m'); per chunk (B, H, nC) ``carry`` =
    exp(m + F_T - m') and ``m`` = the m entering the chunk; and ``m_T``
    (B, H), the m after the last chunk."""
    nk: torch.Tensor
    P: torch.Tensor
    w: torch.Tensor
    mt: torch.Tensor
    rs: torch.Tensor
    wk: torch.Tensor
    carry: torch.Tensor
    m: torch.Tensor
    m_T: torch.Tensor


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def chunk_width(S: int, chunk: Optional[int] = None) -> int:
    """The chunk width of a scan over S rows: ``chunk`` when given, else
    ``run_mlstm``'s rule (``W = 256`` when it divides S, else one chunk
    of S)."""
    if S < 1:
        raise ValueError("mlstm_scan: need S >= 1")
    if chunk is None:
        return CHUNK if S % CHUNK == 0 else S
    if chunk < 1:
        raise ValueError(f"mlstm_scan: need chunk >= 1, got {chunk}")
    return chunk


def mlstm_chunk_state(k: torch.Tensor, v: torch.Tensor, log_i: torch.Tensor,
                      log_f: torch.Tensor, C: torch.Tensor, n: torch.Tensor,
                      m: torch.Tensor) -> State:
    """The state at a chunk's end from the state (C, n, m) entering it:
    k, v (B, H, Wc, hd), log gates (B, H, Wc), all in one working type.
    The JAX package's ``_chunk_state_update``."""
    F = torch.cumsum(log_f, dim=-1)
    Ft = F[..., -1]
    inc = Ft[..., None] - F + log_i                       # F_T - F_s + i_s
    m_next = torch.maximum(m + Ft, inc.amax(dim=-1))
    wk = torch.exp(inc - m_next[..., None])
    carry = torch.exp(m + Ft - m_next)
    kw = k * wk[..., None]
    C = carry[..., None, None] * C + kw.transpose(-1, -2) @ v
    n = carry[..., None] * n + kw.sum(dim=-2)
    return C, n, m_next


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_i: torch.Tensor, log_f: torch.Tensor, C: torch.Tensor,
                n: torch.Tensor, m: torch.Tensor) -> Scan:
    """One chunk of Wc rows from the state (C, n, m) entering it, all in
    one working type: (h (B, H, Wc, hd), and the state at the chunk's end
    by :func:`mlstm_chunk_state`).  The JAX package's ``_make_chunk_fn``
    body; :func:`mlstm_scan_plain` scans it, and ``models.ssm.MLSTMScan``
    recomputes it chunk by chunk in its backward."""
    Wc = q.shape[2]
    tri = torch.tril(torch.ones((Wc, Wc), dtype=torch.bool, device=q.device))
    F = torch.cumsum(log_f, dim=-1)
    logD = F[..., :, None] - F[..., None, :] + log_i[..., None, :]
    logD = torch.where(tri, logD, NEG)                        # (B,H,t,s)
    m_intra = logD.amax(dim=-1)
    b_inter = F + m[..., None]
    m_t = torch.maximum(m_intra, b_inter)
    scores = (q @ k.transpose(-1, -2)) * torch.exp(logD - m_t[..., None])
    num = scores @ v
    den = scores.sum(dim=-1)
    w_int = torch.exp(b_inter - m_t)
    num = num + w_int[..., None] * (q @ C)
    den = den + w_int * (q @ n[..., None])[..., 0]
    norm = torch.maximum(den.abs(), torch.exp(-m_t))
    return (num / norm[..., None],
            *mlstm_chunk_state(k, v, log_i, log_f, C, n, m))


def mlstm_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_i: torch.Tensor, log_f: torch.Tensor,
                     C0: torch.Tensor, n0: torch.Tensor,
                     m0: torch.Tensor, chunk: Optional[int] = None) -> Scan:
    """See the module docstring.  Any S >= 1 and any start state.
    ``chunk`` sets the chunk width (the last chunk may be shorter); by
    default ``run_mlstm``'s rule (:func:`chunk_width`)."""
    S = q.shape[2]
    W = chunk_width(S, chunk)
    dt = _work_dtype(q)
    C, n, m = C0.to(dt), n0.to(dt), m0.to(dt)
    hs = []
    for c0 in range(0, S, W):
        h, C, n, m = mlstm_chunk(*(t[:, :, c0:c0 + W].to(dt)
                                   for t in (q, k, v, log_i, log_f)), C, n, m)
        hs.append(h)
    return torch.cat(hs, dim=2), C, n, m


def mlstm_prep_plain(q: torch.Tensor, k: torch.Tensor, log_i: torch.Tensor,
                     log_f: torch.Tensor, m0: torch.Tensor,
                     chunk: int = KERNEL_CHUNK) -> Prep:
    """The kernel's first pass: everything of the scan that does not
    depend on C (see :class:`Prep`), chunk by chunk, in the working type
    of :func:`mlstm_scan_plain`."""
    B, H, S, _ = q.shape
    W = chunk
    nC = -(-S // W)
    dt = _work_dtype(q)
    pad = nC * W - S

    def rows(t: torch.Tensor) -> torch.Tensor:   # (B,H,S,...) -> padded
        t = t.to(dt)
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, pad))

    qp, kp, li, lf = rows(q), rows(k), rows(log_i), rows(log_f)
    valid = torch.arange(nC * W, device=q.device) < S
    qp, kp = (t.reshape(B, H, nC, W, -1) for t in (qp, kp))
    li, lf = (t.reshape(B, H, nC, W) for t in (li, lf))
    valid = valid.reshape(nC, W)
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    F = torch.cumsum(lf, dim=-1)                          # flat past S
    Ft = F[..., -1]                                       # F at the last row
    inc = torch.where(valid, Ft[..., None] - F + li, NEG)
    A = inc.amax(dim=-1)                                  # (B,H,nC)
    ms = [m0.to(dt)]
    for c in range(nC):                                   # the m chain
        ms.append(torch.maximum(ms[-1] + Ft[..., c], A[..., c]))
    m_all = torch.stack(ms, dim=-1)                       # (B,H,nC+1)
    m_in, m_next = m_all[..., :-1], m_all[..., 1:]
    mask = tri & valid[:, :, None] & valid[:, None, :]    # (nC,t,s)
    logD = torch.where(mask, F[..., :, None] - F[..., None, :]
                       + li[..., None, :], NEG)
    m_intra = logD.amax(dim=-1)
    b_inter = F + m_in[..., None]
    m_t = torch.where(valid, torch.maximum(m_intra, b_inter), 0.0)
    w = torch.where(valid, torch.exp(b_inter - m_t), 0.0)
    scores = qp @ kp.transpose(-1, -2)
    P = torch.where(mask, scores * torch.exp(logD - m_t[..., None]), 0.0)
    wk = torch.where(valid, torch.exp(inc - m_next[..., None]), 0.0)
    carry = torch.exp(m_in + Ft - m_next)
    nk = (kp * wk[..., None]).sum(dim=-2)                 # (B,H,nC,hd)
    flat = lambda t: t.reshape(B, H, nC * W)
    return Prep(nk, P, flat(w), flat(m_t), flat(P.sum(dim=-1)), flat(wk),
                carry, m_in, m_all[..., -1])


def mlstm_walk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     C0: torch.Tensor, n0: torch.Tensor, prep: Prep,
                     chunk: int = KERNEL_CHUNK,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's walk: per chunk, what needs C and n, from ``prep``.
    Returns (h, C_T, n_T)."""
    S = q.shape[2]
    W = chunk
    dt = _work_dtype(q)
    C, n = C0.to(dt), n0.to(dt)
    hs = []
    for c, c0 in enumerate(range(0, S, W)):
        qc, kc, vc = (t[:, :, c0:c0 + W].to(dt) for t in (q, k, v))
        Wc = qc.shape[2]
        rows = slice(c0, c0 + Wc)
        P = prep.P[:, :, c, :Wc, :Wc]
        w, mt, rs = (t[:, :, rows] for t in (prep.w, prep.mt, prep.rs))
        num = P @ vc + w[..., None] * (qc @ C)
        den = rs + w * (qc @ n[..., None])[..., 0]
        norm = torch.maximum(den.abs(), torch.exp(-mt))
        hs.append(num / norm[..., None])
        carry = prep.carry[..., c]
        kw = kc * prep.wk[:, :, rows, None]
        C = carry[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = carry[..., None] * n + prep.nk[:, :, c].to(dt)
    return torch.cat(hs, dim=2), C, n


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mlstm_scan_cuda: {msg}")


def _check(shape: Tuple[int, ...], **tensors: torch.Tensor) -> None:
    """Device, type, contiguity and shape of each named tensor against
    ``shape``'s (B, H, S, hd), and 16-byte alignment of q, k, v and C0
    (the kernels' vector loads); raises on anything the kernels do not
    take."""
    B, H, S, hd = shape
    want = {"q": (B, H, S, hd), "k": (B, H, S, hd), "v": (B, H, S, hd),
            "log_i": (B, H, S), "log_f": (B, H, S), "C0": (B, H, hd, hd),
            "n0": (B, H, hd), "m0": (B, H)}
    dev = tensors["q"].device
    for name, t in tensors.items():
        _require(t.is_cuda and t.device == dev, f"{name} must be on q's card")
        _require(t.dtype == torch.float32, f"{name} must be float32, "
                 f"got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(tuple(t.shape) == want[name],
                 f"{name} has shape {tuple(t.shape)}, want {want[name]}")
        _require(name not in ("q", "k", "v", "C0") or t.data_ptr() % 16 == 0,
                 f"{name} must be 16-byte aligned")
    _require(S >= 1, "need S >= 1")
    _require(hd % BV == 0 and BV <= hd <= MAX_HD,
             f"hd must be a multiple of {BV} in {BV}..{MAX_HD}, got {hd}")


def scratch_layout(lib: ctypes.CDLL, BH: int, S: int,
                   hd: int) -> Tuple[int, Tuple[int, ...]]:
    """The kernel's chunk width and its scratch buffer's offsets in floats
    (the arrays of :class:`Prep` from ``nk`` to ``m``, then the length), as
    the library reports them."""
    out = (ctypes.c_longlong * 10)()
    lib.repro_mlstm_scratch_layout(BH, S, hd, out)
    return out[0], tuple(out[1:])


def _scratch(lib: ctypes.CDLL, q: torch.Tensor) -> torch.Tensor:
    B, H, S, hd = q.shape
    _, offsets = scratch_layout(lib, B * H, S, hd)
    return torch.empty(offsets[-1], dtype=torch.float32, device=q.device)


def _prep_views(lib: ctypes.CDLL, buf: torch.Tensor, q: torch.Tensor,
                m_T: torch.Tensor) -> Prep:
    """The scratch buffer as a :class:`Prep`, by the library's layout."""
    B, H, S, hd = q.shape
    W, off = scratch_layout(lib, B * H, S, hd)
    nC = -(-S // W)
    nk, P, w, mt, rs, wk, carry, m = (buf[a:b] for a, b in zip(off, off[1:]))
    rows = lambda t: t.view(B, H, nC * W)
    return Prep(nk.view(torch.float64).view(B, H, nC, hd),
                P.view(B, H, nC, W, W), rows(w), rows(mt), rows(rs), rows(wk),
                carry.view(B, H, nC), m.view(B, H, nC), m_T)


def mlstm_prep_cuda(q: torch.Tensor, k: torch.Tensor, log_i: torch.Tensor,
                    log_f: torch.Tensor, m0: torch.Tensor) -> Prep:
    """The kernel's first pass alone, on the card (for its tests: it is
    not a launch of the scan).  Same inputs as :func:`mlstm_scan_cuda`."""
    _require(q.dim() == 4, "q must be (B, H, S, hd)")
    B, H, S, hd = q.shape
    _check(q.shape, q=q, k=k, log_i=log_i, log_f=log_f, m0=m0)
    lib = build.load("mlstm_scan", _SIGNATURES)
    buf = _scratch(lib, q)
    m_T = torch.empty_like(m0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_mlstm_prep(
        q.data_ptr(), k.data_ptr(), log_i.data_ptr(), log_f.data_ptr(),
        m0.data_ptr(), buf.data_ptr(), m_T.data_ptr(), B * H, S, hd, stream)
    build.check(rc, "mlstm_prep")
    return _prep_views(lib, buf, q, m_T)


def mlstm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_i: torch.Tensor, log_f: torch.Tensor,
                    C0: torch.Tensor, n0: torch.Tensor,
                    m0: torch.Tensor) -> Scan:
    """Same contract as :func:`mlstm_scan_plain`, on the card, for
    contiguous float32 tensors (q, k, v and C0 16-byte aligned) with ``hd``
    a multiple of 32 up to 1024, any ``S >= 1`` and any start state."""
    global launches
    _require(q.dim() == 4, "q must be (B, H, S, hd)")
    B, H, S, hd = q.shape
    _check(q.shape, q=q, k=k, v=v, log_i=log_i, log_f=log_f, C0=C0, n0=n0,
           m0=m0)
    h = torch.empty_like(q)
    C = torch.empty_like(C0)
    n = torch.empty_like(n0)
    m = torch.empty_like(m0)
    if B * H == 0:
        return h, C, n, m
    lib = build.load("mlstm_scan", _SIGNATURES)
    buf = _scratch(lib, q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_mlstm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
        log_f.data_ptr(), C0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
        buf.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), B * H, S, hd, stream)
    build.check(rc, "mlstm_scan")
    launches += 1
    return h, C, n, m
