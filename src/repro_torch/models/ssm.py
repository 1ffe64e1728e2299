"""Recurrent sequence layers: Mamba (hymba's parallel SSM branch), and
the mLSTM and sLSTM of xLSTM.

Plain functions over parameter dicts with the JAX package's keys, shapes,
scales and ``(in, out)`` layout, so the weight bridge is a copy.

Mamba keeps the three forms of the JAX package's ``run_mamba``: the O(1)
decode step (``S == 1`` with a state); the chunkwise prefill over chunks
of ``MAMBA_CHUNK`` tokens, carrying ``h`` from chunk to chunk, when ``S``
is a multiple of it; one chunk of ``S`` tokens otherwise.  Within a chunk
the recurrence ``h_t = dA_t h_{t-1} + dBu_t`` is a log-depth doubling
scan over the sequence axis (:func:`mamba_scan`), where JAX runs
``lax.associative_scan``: the same products, added in another order.
Under autograd each chunk runs through ``torch.utils.checkpoint``, the
twin of JAX's ``lax.scan(jax.checkpoint(chunk))``: the backward
recomputes a chunk's (B, W, d_in, N) tensors instead of keeping every
doubling pass of every chunk, and only ``h`` is kept between chunks.

The mLSTM keeps the three branches of the JAX package's ``run_mlstm``:

  * decode (``S == 1`` with a state): the O(1) recurrence;
  * no state and ``S <= 256``: the stabilised quadratic D-matrix form;
  * otherwise the chunkwise form, through
    :func:`repro_torch.kernels.ops.mlstm_scan` (the CUDA kernel on the
    card): from ``C = n = 0``, ``m = -1e30`` without a state, else from
    the state it is given (a serving cache starts at ``m = 0``, as in JAX).

Under autograd the chunkwise form goes through :class:`MLSTMScan`.  Its
forward is the same single launch of the kernel over the whole sequence
that serving makes (the plain scan on the CPU), and it keeps only its
inputs.  Its backward launches no kernel: it is the twin of XLA's VJP of
JAX's ``lax.scan(jax.checkpoint(chunk))``.  It recomputes, without grad,
the state entering each chunk, then walks the chunks in reverse,
recomputing each one under grad from its entering state
(``kernels.mlstm_scan.mlstm_chunk``, the plain scan's own chunk) and
taking its vector-Jacobian product, the state's cotangent carried back to
the chunk before.  The stabiliser m goes through ``maximum`` and ``amax``,
whose gradients split ties evenly, as JAX's do.

The sLSTM is the JAX package's sequential recurrence, one step per token.
Both compute in float32, or in float64 for float64 inputs (the CPU
reference a float32 run is held to).  The sequence-parallel mLSTM
(``cfg.seq_segments > 1``) needs a mesh and is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import mlstm_scan as _mlstm
from ..kernels import ops
from .common import dense_init, rms_norm
from .config import ModelConfig

Params = Dict[str, Any]
State = Tuple[torch.Tensor, ...]

#: Mamba's low-rank dt projection, depthwise conv taps and scan chunk
DT_RANK = 16
CONV_K = 4
MAMBA_CHUNK = 128
#: the JAX package's mLSTM chunk (``MLSTM_CHUNK``): the quadratic form
#: serves state-free sequences up to this length
MLSTM_CHUNK = 256
NEG = -1e30
GATES = ("z", "i", "f", "o")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """float32, or float64 kept as it is (the JAX package's upcasts)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# =====================================================================
# Mamba-style selective SSM (hymba's parallel SSM branch)
# =====================================================================

def init_mamba(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device, dtype: torch.dtype,
               n_layers: int) -> Params:
    """Mamba weights stacked on a leading layer axis.  ``A_log`` and
    ``D_skip`` are float32 whatever ``dtype``, as in JAX."""
    L, D, d_in, N = n_layers, cfg.d_model, cfg.d_in, cfg.ssm_state
    g, dev = generator, device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init(g, (L, D, 2 * d_in), dev, dtype, fan_in=D),
        "conv_w": dense_init(g, (L, CONV_K, d_in), dev, dtype, scale=0.5),
        "w_bc": dense_init(g, (L, d_in, 2 * N), dev, dtype, fan_in=d_in),
        "w_dt1": dense_init(g, (L, d_in, DT_RANK), dev, dtype, fan_in=d_in),
        "w_dt2": dense_init(g, (L, DT_RANK, d_in), dev, dtype,
                            fan_in=DT_RANK),
        "dt_bias": torch.zeros((L, d_in), device=dev, dtype=dtype),
        "A_log": torch.log(A).expand(L, d_in, N).contiguous(),
        "D_skip": torch.ones((L, d_in), device=dev),
        "w_out": dense_init(g, (L, d_in, D), dev, dtype, fan_in=d_in),
    }


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor,
                           tail: Optional[torch.Tensor] = None,
                           ) -> torch.Tensor:
    """u: (B,S,C), w: (K,C).  ``tail``: (B,K-1,C) of preceding context."""
    B, S, C = u.shape
    K = w.shape[0]
    if tail is None:
        tail = u.new_zeros((B, K - 1, C))
    up = torch.cat([tail.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + up[:, i:i + S, :] * w[i]
    return out


def mamba_scan(dA: torch.Tensor, dBu: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All h_t of h_t = dA_t * h_{t-1} + dBu_t along axis 1 (h_{-1} =
    ``h0``, or 0).  dA, dBu: (B, W, d_in, N).

    A doubling scan: after the pass with offset s, position t holds the
    composition of the s' <= 2s steps ending at t, (a, b) = (a_t a_{t-s},
    a_t b_{t-s} + b_t); ceil(log2 W) passes."""
    if h0 is not None:
        dBu = torch.cat([dBu[:, :1] + dA[:, :1] * h0[:, None], dBu[:, 1:]],
                        dim=1)
    a, b = dA, dBu
    W, s = a.shape[1], 1
    while s < W:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < W:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _mamba_chunk(dt: torch.Tensor, u: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of W tokens from state h0 (B,d_in,N): dt, u (B,W,d_in),
    B_, C_ (B,W,N).  Returns (the chunk's last h, y (B,W,d_in))."""
    dA = torch.exp(dt[..., None] * A)                          # (B,W,d,N)
    dBu = (dt * u)[..., None] * B_[:, :, None, :]
    h = mamba_scan(dA, dBu, h0)
    del dA, dBu
    y = torch.einsum("bsdn,bsn->bsd", h, C_)
    return h[:, -1].clone(), y        # not a view that keeps h alive


def run_mamba(p: Params, cfg: ModelConfig, x: torch.Tensor,
              state: Optional[State] = None,
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: (B,S,D).  state = (h (B,d_in,N), conv_tail (B,K-1,d_in)) for
    decode.  Returns (y (B,S,D), the new state, or None without a
    state)."""
    B, S, _ = x.shape
    d_in, N = cfg.d_in, cfg.ssm_state
    u, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    conv_tail = state[1] if state is not None else None
    u_conv = _causal_depthwise_conv(u, p["conv_w"], conv_tail)
    prev = (conv_tail.to(u.dtype) if conv_tail is not None
            else u.new_zeros((B, CONV_K - 1, d_in)))
    new_tail = torch.cat([prev, u], dim=1)[:, -(CONV_K - 1):, :]
    u = F.silu(u_conv)

    dt = _f32(F.softplus((u @ p["w_dt1"]) @ p["w_dt2"] + p["dt_bias"]))
    B_, C_ = torch.chunk(_f32(u @ p["w_bc"]), 2, dim=-1)      # (B,S,N)
    A = -torch.exp(p["A_log"])                                # (d_in,N)
    uf = _f32(u)
    h0 = state[0] if state is not None else None

    if S == 1 and state is not None:
        dA = torch.exp(dt[:, 0, :, None] * A)                 # O(1) decode
        dBu = (dt[:, 0] * uf[:, 0])[..., None] * B_[:, 0, None, :]
        h_last = dA * h0.to(dA.dtype) + dBu
        y = torch.einsum("bdn,bn->bd", h_last, C_[:, 0])[:, None]
    else:
        # chunkwise: (dA, dBu) and h live one chunk at a time; under grad
        # each chunk is recomputed in the backward (JAX's jax.checkpoint),
        # so only h crosses between chunks
        W = MAMBA_CHUNK if S % MAMBA_CHUNK == 0 else S
        h_last = (h0.to(dt.dtype) if h0 is not None
                  else dt.new_zeros((B, d_in, N)))
        remat = torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, uf, B_, C_, A, h_last))
        ys = []
        for c0 in range(0, S, W):
            sl = slice(c0, c0 + W)
            args = (dt[:, sl], uf[:, sl], B_[:, sl], C_[:, sl], A, h_last)
            h_last, yc = (checkpoint(_mamba_chunk, *args, use_reentrant=False)
                          if remat else _mamba_chunk(*args))
            ys.append(yc)
        y = torch.cat(ys, dim=1)
    y = y + p["D_skip"] * uf
    y = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    new_state = (h_last, new_tail) if state is not None else None
    return y, new_state


# =====================================================================
# mLSTM
# =====================================================================

def init_mlstm(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device, dtype: torch.dtype) -> Params:
    D = cfg.d_model
    d_in = 2 * D                      # xLSTM pre-up-projection factor 2
    H = cfg.n_heads
    g, dev = generator, device
    return {
        "w_up": dense_init(g, (D, 2 * d_in), dev, dtype),       # x and gate
        "wq": dense_init(g, (d_in, d_in), dev, dtype),
        "wk": dense_init(g, (d_in, d_in), dev, dtype),
        "wv": dense_init(g, (d_in, d_in), dev, dtype),
        "w_i": dense_init(g, (d_in, H), dev, torch.float32, scale=0.02),
        "b_i": torch.zeros((H,), device=dev),
        "w_f": dense_init(g, (d_in, H), dev, torch.float32, scale=0.02),
        "b_f": torch.full((H,), 3.0, device=dev),   # forget-gate bias init
        "norm": torch.ones((d_in,), device=dev, dtype=dtype),
        "w_down": dense_init(g, (d_in, D), dev, dtype),
    }


class MLSTMScan(torch.autograd.Function):
    """``MLSTMScan.apply(q, k, v, log_i, log_f, C0, n0, m0)``: the values
    of ``ops.mlstm_scan`` without grad, bit for bit, differentiable in
    all eight inputs (see the module docstring).  Saves only its inputs."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_i: torch.Tensor, log_f: torch.Tensor, C0: torch.Tensor,
                n0: torch.Tensor, m0: torch.Tensor) -> _mlstm.Scan:
        fwd = (_mlstm.mlstm_scan_cuda if ops._route(q)
               else _mlstm.mlstm_scan_plain)
        ctx.save_for_backward(q, k, v, log_i, log_f, C0, n0, m0)
        ctx.set_materialize_grads(False)
        return fwd(q, k, v, log_i, log_f, C0, n0, m0)

    @staticmethod
    def backward(ctx, dh: Optional[torch.Tensor],
                 *dstate: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        saved = ctx.saved_tensors
        xs, start = saved[:5], saved[5:]
        S = xs[0].shape[2]
        W = _mlstm.chunk_width(S)
        dt = _mlstm._work_dtype(xs[0])
        chunks = [slice(c0, c0 + W) for c0 in range(0, S, W)]
        # the state entering each chunk, by the plain scan's state update
        states = [tuple(s.to(dt) for s in start)]
        for sl in chunks[:-1]:
            states.append(_mlstm.mlstm_chunk_state(
                *(t[:, :, sl].to(dt) for t in xs[1:]), *states[-1]))
        dxs = [torch.zeros_like(t) for t in xs]
        carry = list(dstate)
        for sl, state in zip(reversed(chunks), reversed(states)):
            with torch.enable_grad():
                ins = [t[:, :, sl].detach().requires_grad_() for t in xs]
                st = [s.detach().requires_grad_() for s in state]
                outs = _mlstm.mlstm_chunk(*(t.to(dt) for t in ins), *st)
            cots = [dh[:, :, sl] if dh is not None else None, *carry]
            used = [(o, c) for o, c in zip(outs, cots) if c is not None]
            got = torch.autograd.grad([o for o, _ in used],
                                      ins + st, [c for _, c in used],
                                      allow_unused=True,
                                      materialize_grads=True)
            for dx, g in zip(dxs, got[:5]):
                dx[:, :, sl] = g
            carry = list(got[5:])
        return (*dxs, *(c.to(s.dtype) for c, s in zip(carry, start)))


def _mlstm_decode(q, k, v, log_i, log_f, state: State):
    """One token: q, k, v (B,H,hd); log gates (B,H)."""
    C0, n0, m0 = (s.to(q.dtype) for s in state)
    m1 = torch.maximum(log_f + m0, log_i)
    i1 = torch.exp(log_i - m1)
    f1 = torch.exp(log_f + m0 - m1)
    C1 = (f1[..., None, None] * C0
          + i1[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n1 = f1[..., None] * n0 + i1[..., None] * k
    num = torch.einsum("bhij,bhi->bhj", C1, q)
    den = torch.maximum(torch.einsum("bhi,bhi->bh", n1, q).abs(),
                        torch.exp(-m1))
    return num / den[..., None], (C1, n1, m1)


def _mlstm_quadratic(q, k, v, log_i, log_f):
    """The stabilised D-matrix form over (B,S,H,hd), no state."""
    S = q.shape[1]
    Fc = torch.cumsum(log_f, dim=1)                            # (B,S,H)
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    logD = torch.where(tri[None, :, :, None], logD, float("-inf"))
    m = logD.amax(dim=2)                                       # (B,t,H)
    Dm = torch.exp(logD - m[:, :, None, :])                    # (B,t,s,H)
    scores = torch.einsum("bthd,bshd->btsh", q, k) * Dm
    norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m))
    return torch.einsum("btsh,bshd->bthd", scores, v) / norm[..., None]


def run_mlstm(p: Params, cfg: ModelConfig, x: torch.Tensor,
              state: Optional[State] = None,
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: (B,S,D).  state = (C (B,H,hd,hd), n (B,H,hd), m (B,H)).
    Returns (y (B,S,D), the new state, or None without a state)."""
    if cfg.seq_segments > 1:
        raise NotImplementedError(
            "the sequence-parallel mLSTM (seq_segments > 1) needs a mesh and "
            "is not ported yet")
    B, S, _ = x.shape
    H = cfg.n_heads
    xin, z = torch.chunk(x @ p["w_up"], 2, dim=-1)             # (B,S,d_in)
    d_in = xin.shape[-1]
    hd = d_in // H
    q = _f32(xin @ p["wq"]).reshape(B, S, H, hd)
    k = _f32(xin @ p["wk"]).reshape(B, S, H, hd) / math.sqrt(hd)
    v = _f32(xin @ p["wv"]).reshape(B, S, H, hd)
    log_i = _f32(xin) @ p["w_i"] + p["b_i"]                    # (B,S,H)
    log_f = F.logsigmoid(_f32(xin) @ p["w_f"] + p["b_f"])

    new_state: Optional[State] = None
    if S == 1 and state is not None:
        h, new_state = _mlstm_decode(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                     log_f[:, 0], state)
        h = h.reshape(B, 1, d_in)
    elif S <= MLSTM_CHUNK and state is None:
        h = _mlstm_quadratic(q, k, v, log_i, log_f).reshape(B, S, d_in)
    else:
        if state is not None:
            C0, n0, m0 = (s.to(q.dtype).contiguous() for s in state)
        else:
            C0 = q.new_zeros((B, H, hd, hd))
            n0 = q.new_zeros((B, H, hd))
            m0 = q.new_full((B, H), NEG)
        bhsd = [t.transpose(1, 2).contiguous() for t in (q, k, v, log_i, log_f)]
        h, C1, n1, m1 = ops.mlstm_scan(*bhsd, C0, n0, m0)
        h = h.transpose(1, 2).reshape(B, S, d_in)
        if state is not None:
            new_state = (C1, n1, m1)
    h = rms_norm(h.to(x.dtype), p["norm"], cfg.norm_eps)
    y = (h * F.silu(z)) @ p["w_down"]
    return y, new_state


# =====================================================================
# sLSTM
# =====================================================================

def init_slstm(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device, dtype: torch.dtype) -> Params:
    D = cfg.d_model
    H = cfg.n_heads
    hd = D // H
    g, dev = generator, device
    p: Params = {"norm": torch.ones((D,), device=dev, dtype=dtype)}
    for gate in GATES:
        p[f"w_{gate}"] = dense_init(g, (D, D), dev, dtype)
        p[f"r_{gate}"] = dense_init(g, (H, hd, hd), dev, dtype, scale=0.02)
        p[f"b_{gate}"] = torch.full((D,), 3.0 if gate == "f" else 0.0,
                                    device=dev)
    ff = int(D * 8 / 3) // 16 * 16
    p["ff_gate"] = dense_init(g, (D, ff), dev, dtype)
    p["ff_down"] = dense_init(g, (ff // 2, D), dev, dtype)
    return p


def run_slstm(p: Params, cfg: ModelConfig, x: torch.Tensor,
              state: Optional[State] = None,
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: (B,S,D).  state = (c, n, h, m), each (B,H,hd).
    Returns (y (B,S,D), the new state, or None without a state)."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    # the input terms of every step, and the recurrent weights, gate after
    # gate on the last axis: one (B,H,hd) x (H,hd,4hd) product per step
    wx = torch.cat([_f32(x @ p[f"w_{g}"] + p[f"b_{g}"].to(x.dtype))
                    .reshape(B, S, H, hd) for g in GATES], dim=-1)
    R = torch.cat([_f32(p[f"r_{g}"]) for g in GATES], dim=-1)
    if state is None:
        zero = wx.new_zeros((B, H, hd))
        c, n, h, m = zero, zero + 1e-6, zero, zero
    else:
        c, n, h, m = (s.to(wx.dtype) for s in state)
    hs = []
    # one view per step: under grad their backward is one stack, where a
    # slice per step would write a zero gradient of all of wx per step
    for wx_t in wx.unbind(dim=1):
        pre = wx_t + torch.einsum("bhi,hij->bhj", h, R)
        zt, it, ft, ot = torch.split(pre, hd, dim=-1)
        log_f = F.logsigmoid(ft)
        m1 = torch.maximum(log_f + m, it)
        i1 = torch.exp(it - m1)
        f1 = torch.exp(log_f + m - m1)
        c = f1 * c + i1 * torch.tanh(zt)
        n = f1 * n + i1
        h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        m = m1
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    # gated feed-forward (GeGLU, factor 4/3); jax.nn.gelu's default is the
    # tanh form
    a, b = torch.chunk(y @ p["ff_gate"], 2, dim=-1)
    y = (F.gelu(a, approximate="tanh") * b) @ p["ff_down"]
    new_state = (c, n, h, m) if state is not None else None
    return y, new_state
