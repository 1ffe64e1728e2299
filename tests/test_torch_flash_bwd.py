"""A model of the flash backward kernel's arithmetic, held against gate T1
on the CPU.

``csrc/flash_attention_bwd.cu`` runs every product of the backward on the
tensor cores in 3xTF32: each fp32 operand is split into TF32 big + small
(``cvt.rna`` rounding), and each product is big*big + big*small +
small*big.  The tensor cores add each 8-deep step of an ``mma`` into an
fp32 accumulator without rounding to nearest, so a long chain of them
drifts.  The kernel therefore keeps the small products of every product in
an accumulator of their own and keeps every chain short: S and dP restart
theirs every ``kSeg`` 8-column steps of hd, and the long sums (dK and dV
over the query tiles of a key, dQ over the key tiles of a query) every
streamed tile; each chain's partial is added to its total with an
ordinary fp32 add.  This file emulates that arithmetic in plain torch:
products of TF32 values exact, each 8-deep step added to the accumulator
in float64 and truncated to fp32 precision (a stand-in for the tensor
cores' sums), in the kernel's order of steps and with its chain lengths
(read from the source).  It holds the emulation to T1 as written
(``tests/test_torch_cuda.py::flash_bwd_t1``): for each of dq, dk, dv,
max|g - g64| <= 2 max|g32 - g64| + 1e-6 max|g64|, with g64 and g32 the
plain backward in float64 and fp32, over small seeded shapes that cover
``FLASH_BWD_CASES``' geometries.  The control runs the same emulation with
one chain over all tiles and must read over T1's bound.

The emulation is a model of the kernel; gate T1 on the card is the gate.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_bwd.py

The ``gpu`` test at the end runs on the card only.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The model's steps are many small products: one intra-op thread runs
    them faster than a pool, and beside other test workers far faster."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attention_bwd.cu")


def kernel_chains():
    """The kernel's chain lengths: ``{hd: BN}``, the rows of a ring stage
    (the query tile of dK and dV's sums, the key tile of dQ's, as
    ``Tile<HD>::BN``), and ``kSeg``, the 8-column steps of hd in one chain
    of a score."""
    src = SOURCE.read_text()
    bn = re.search(r"BN = HD == 64 \? (\d+) : (\d+);", src)
    seg = re.search(r"constexpr int kSeg = (\d+);", src)
    assert bn and seg, "Tile<HD>::BN or kSeg not found in the kernel source"
    return {64: int(bn.group(1)), 128: int(bn.group(2))}, int(seg.group(1))


# ------------------------------------------------------------- the model

#: keeps fp32's 23 mantissa bits of a float64 (clears the low 29 of 52)
_RZ32 = -(1 << 29)


def rz32(x):
    """float64 values rounded toward zero to fp32 precision, kept as
    float64 (every value here lies in fp32's normal range or is 0)."""
    return (x.view(torch.int64) & _RZ32).view(torch.float64)


def rn32(x):
    """float64 values rounded to the nearest fp32, kept as float64."""
    return x.float().double()


def tf32(x):
    """cvt.rna.tf32.f32 on finite fp32 values: the nearest TF32 value, ties
    away from zero (the kernel's integer rounding)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """fp32 x -> its (big, small) TF32 parts, as float64."""
    big = tf32(x)
    return big.double(), tf32(x - big).double()


def mma(c, a, b):
    """c + a @ b over one 8-deep step: products exact, the sum rounded
    toward zero to fp32."""
    return rz32(c + a @ b)


def scores(a, b, seg):
    """a (.., M, hd) . b (.., N, hd)^T as the kernel's ``scores``: in
    chains of ``seg`` 8-column steps of hd, small*big and big*small into
    lo, big*big into part; each chain's part + lo added to the total in
    fp32."""
    ab, as_ = split(a)
    bb, bs = (t.transpose(-1, -2) for t in split(b))
    s = torch.zeros(*a.shape[:-1], b.shape[-2], dtype=torch.float64)
    for c0 in range(0, a.shape[-1], 8 * seg):
        part, lo = torch.zeros_like(s), torch.zeros_like(s)
        for k0 in range(c0, c0 + 8 * seg, 8):
            c = slice(k0, k0 + 8)
            lo = mma(lo, as_[..., c], bb[..., c, :])
            lo = mma(lo, ab[..., c], bs[..., c, :])
            part = mma(part, ab[..., c], bb[..., c, :])
        s = rn32(s + rn32(part + lo))
    return s.float()


def long_sum(x, y, tile, one_chain=False):
    """x (.., M, R) @ y (.., R, hd) as the kernel's ``long_sum``: in 8-row
    steps of R, small*big and big*small into lo, big*big into part; every
    ``tile`` rows part + lo is added to the total in fp32 and both restart
    from zero.  ``one_chain`` keeps one chain over all of R instead."""
    R = x.shape[-1]
    pad = -R % tile
    x = torch.nn.functional.pad(x, (0, pad))
    y = torch.nn.functional.pad(y, (0, 0, 0, pad))
    xb, xs = split(x)
    yb, ys = split(y)
    total = torch.zeros(*x.shape[:-1], y.shape[-1], dtype=torch.float64)
    part, lo = torch.zeros_like(total), torch.zeros_like(total)
    for r0 in range(0, R + pad, 8):
        r = slice(r0, r0 + 8)
        lo = mma(lo, xs[..., r], yb[..., r, :])
        lo = mma(lo, xb[..., r], ys[..., r, :])
        part = mma(part, xb[..., r], yb[..., r, :])
        if not one_chain and (r0 + 8) % tile == 0:
            total = rn32(total + rn32(part + lo))
            part, lo = torch.zeros_like(total), torch.zeros_like(total)
    return (rn32(part + lo) if one_chain else total).float()


def delta(dout, out):
    """The pre-pass: lane l sums d = l, l + 32, .. by fma, then the warp
    adds by xor shuffles."""
    hd = dout.shape[-1]
    a = dout.double().unflatten(-1, (hd // 32, 32))
    b = out.double().unflatten(-1, (hd // 32, 32))
    acc = torch.zeros(a.shape[:-2] + (32,))
    for i in range(hd // 32):
        acc = (acc.double() + a[..., i, :] * b[..., i, :]).float()
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., torch.arange(32) ^ off]
    return acc[..., 0]


def visible(Sq, Sk, causal, window):
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool)
    qp = Sk - Sq + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = kp <= qp
    if window > 0:
        ok &= kp > qp - window
    return ok


def emulate(q, k, v, out, lse, dout, causal, window, one_chain=False):
    """(dq, dk, dv) as the kernel computes them, on fp32 CPU tensors.
    ``one_chain`` runs each long sum as one chain."""
    hd = q.shape[-1]
    tiles, seg = kernel_chains()
    tile = tiles[hd]
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    vis = visible(q.shape[-2], k.shape[-2], causal, window)
    D = delta(dout, out)

    def probs(s, lse_):          # expf(fmaf(s, scale, -lse)), masked
        return torch.where(vis, torch.exp((s.double() * scale
                                           - lse_.double()).float()), 0.0)

    # dK/dV pass, transposed: rows are keys, columns queries
    pT = probs(scores(k, q, seg).transpose(-1, -2),
               lse[..., :, None]).transpose(-1, -2)
    dsT = pT * (scores(v, dout, seg) - D[..., None, :])
    dv = long_sum(pT, dout, tile, one_chain)
    dk = long_sum(dsT, q, tile, one_chain) * scale
    # dQ pass
    p = probs(scores(q, k, seg), lse[..., :, None])
    ds = p * (scores(dout, v, seg) - D[..., :, None])
    dq = long_sum(ds, k, tile, one_chain) * scale
    return dq, dk, dv


# ------------------------------------------------------------------ T1

#: (name, B, H, Sq, Sk, causal, window, hd): ``FLASH_BWD_CASES``'
#: geometries at S <= 512, the long ones with at least 8 query tiles
EMU_CASES = [("minicpm", 1, 2, 512, 512, True, 0, 64),
             ("granite", 1, 1, 256, 256, True, 0, 128),
             ("window17", 1, 2, 512, 512, True, 17, 64),
             ("window1", 1, 2, 300, 300, True, 1, 64),
             ("ragged500", 1, 2, 500, 500, True, 0, 64),
             ("ragged257_hd128", 1, 1, 257, 257, True, 0, 128),
             ("ragged97_B2", 2, 2, 97, 97, True, 0, 64),
             ("noncausal", 1, 1, 128, 512, False, 0, 128),
             ("noncausal_ragged", 1, 2, 65, 97, False, 0, 64),
             ("window17_sq97_sk300", 2, 1, 97, 300, True, 17, 128)]


def t1_inputs(B, H, Sq, Sk, hd, causal, window, seed):
    """q, k, v, dO ~ N(0, 1) in fp32 from a numpy seed; out and lse the
    plain forward in float64 rounded to fp32 (T1's inputs)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, hd))
                                    .astype(np.float32))
                   for S in (Sq, Sk, Sk, Sq))
    out64, lse64 = fa.flash_attention_plain(
        q.double(), k.double(), v.double(), causal=causal, window=window,
        return_lse=True)
    return q, k, v, out64.float(), lse64.float(), do


def t1_ratios(args, got, causal, window):
    """Per gradient, max|g - g64| over its T1 bound."""
    kw = {"causal": causal, "window": window}
    g64 = fa.flash_attention_bwd_plain(*(a.double() for a in args), **kw)
    g32 = fa.flash_attention_bwd_plain(*args, **kw)
    res = {}
    for name, a, b, c in zip(("dq", "dk", "dv"), got, g32, g64):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        bound = (2 * (b.double() - c).abs().max().item()
                 + 1e-6 * c.abs().max().item())
        res[name] = (a.double() - c).abs().max().item() / bound
    return res


def test_kernel_source_is_the_modelled_design():
    """The model follows the kernel: its tile lengths come from the source,
    whose products are 3xTF32 mma.sync."""
    src = SOURCE.read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert kernel_chains() == ({64: 32, 128: 16}, 4)


@pytest.mark.parametrize("name,B,H,Sq,Sk,causal,window,hd", EMU_CASES)
def test_tiled_emulation_holds_t1(name, B, H, Sq, Sk, causal, window, hd):
    args = t1_inputs(B, H, Sq, Sk, hd, causal, window, seed=Sq + window)
    ratios = t1_ratios(args, emulate(*args, causal, window), causal, window)
    print(name, ratios)
    assert max(ratios.values()) <= 1.0, ratios


def test_one_chain_control_reads_over_t1():
    """The control: one accumulator chain for dK and dV over all 512
    queries (B=1, H=2, S=512, hd=64, causal, seed 512) reads over T1's
    bound, where the tiled sums of ``test_tiled_emulation_holds_t1``'s
    ``minicpm`` case, on the same inputs, hold it."""
    args = t1_inputs(1, 2, 512, 512, 64, True, 0, seed=512)
    ratios = t1_ratios(args, emulate(*args, True, 0, one_chain=True), True, 0)
    print("one chain", ratios)
    assert max(ratios["dk"], ratios["dv"]) > 1.0, ratios


def test_rows_aligned():
    x = torch.zeros(2, 8, 3, 64)                  # (B, S, H, hd)
    assert fa._rows_aligned(x.transpose(1, 2))
    # a data pointer 4 bytes past 16, and rows 66 floats apart
    assert not fa._rows_aligned(torch.zeros(4 * 64 + 1)[1:].view(1, 1, 4, 64))
    assert not fa._rows_aligned(torch.zeros(600).as_strided(
        (1, 2, 4, 64), (0, 4 * 66, 66, 1)))
    # a dim of length 1 may carry any stride
    assert fa._rows_aligned(torch.zeros(1, 4, 64).as_strided(
        (1, 1, 4, 64), (3, 3, 64, 1)))


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_misaligned_rows_give_the_aligned_result():
    """Views whose rows are not 16-byte aligned are copied by the wrapper:
    the gradients equal the aligned inputs' to the bit, in the views'
    layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [a.cuda() for a in t1_inputs(1, 4, 300, 300, 64, True, 0, seed=3)]
    shifted = []
    for a in (args[0], args[1], args[2], args[5]):
        buf = torch.empty(a.numel() + 1, device="cuda")
        view = buf[1:].view_as(a)
        view.copy_(a)
        assert not fa._rows_aligned(view)
        shifted.append(view)
    q, k, v, do = shifted
    want = fa.flash_attention_bwd_cuda(*args)
    got = fa.flash_attention_bwd_cuda(q, k, v, args[3], args[4], do)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
