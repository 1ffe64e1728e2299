"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The ``gpu`` tests skip on a machine without a card.  The rest check, on the
CPU, that the dispatcher routes by device and that the CUDA wrappers
refuse what their kernels do not take.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.mlstm_scan import (KERNEL_CHUNK, mlstm_prep_cuda,
                                            mlstm_prep_plain, mlstm_scan_cuda,
                                            mlstm_scan_plain)
from repro_torch.kernels.moe_gating import moe_gating_cuda, moe_gating_plain
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.serving.batch import _quant_page_int8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _paged_inputs(lengths, page, hk, rep, hd, device, quant=False, seed=0,
                  width=None):
    """Pool, tables and queries; every pool row a slot does not own below
    its length is poisoned with a large finite value.  With ``width`` the
    block table is that many pages wide and its padding points at the
    poisoned pages no slot owns (else it is 0)."""
    rng = np.random.default_rng(seed)
    owned = [-(-(L + 1) // page) for L in lengths]
    P = sum(owned) + 3
    perm = rng.permutation(P)
    spare = perm[sum(owned):]                       # pages no slot owns
    bt = np.zeros((len(lengths), width or max(owned)), np.int32)
    live = np.zeros((P, page), bool)
    at = 0
    for m, (L, n) in enumerate(zip(lengths, owned)):
        bt[m, :n] = perm[at:at + n]
        if width:
            bt[m, n:] = spare[np.arange(width - n) % len(spare)]
        at += n
        for t in range(L):
            live[bt[m, t // page], t % page] = True
    kp = rng.normal(size=(P, page, hk, hd)).astype(np.float32)
    vp = rng.normal(size=(P, page, hk, hd)).astype(np.float32)
    kp[~live], vp[~live] = 1e4, -1e4
    M = len(lengths)
    t = lambda a: torch.from_numpy(a).to(device)
    args = [t(rng.normal(size=(M, hk * rep, hd)).astype(np.float32)),
            t(kp), t(vp), t(bt), t(np.asarray(lengths, np.int32)),
            t(rng.normal(size=(M, hk, hd)).astype(np.float32)),
            t(rng.normal(size=(M, hk, hd)).astype(np.float32))]
    if quant:
        (args[1], ks), (args[2], vs) = _quant_page_int8(args[1]), _quant_page_int8(args[2])
        args += [ks, vs]
    return args


def _flash_inputs(B, H, Sq, Sk, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    # the model's (B, S, H, hd) layout, viewed as (B, H, S, hd)
    return [torch.randn((B, S, H, hd), generator=g).to(dtype).to(device)
            .transpose(1, 2) for S in (Sq, Sk, Sk)]


def _gating_logits(T, E, device, seed=0, ties=False):
    """Router logits; with ``ties`` every column is duplicated once (and
    one row is uniform) so equal probabilities must go lowest index first."""
    rng = np.random.default_rng(seed)
    if ties:
        half = rng.normal(size=(T, E // 2)) * 2
        x = np.concatenate([half, half], axis=1)
        x[0] = 0.25
    else:
        x = rng.normal(size=(T, E)) * 2
    return torch.from_numpy(x.astype(np.float32)).to(device)


#: m0 of each start state; "high" and "low" are warm memories with m far
#: from 0 (the memory outweighs the chunk's own rows, or the reverse)
MLSTM_M0 = {"empty": -1e30, "cache": 0.0, "warm": 0.5, "high": 20.0,
            "low": -20.0}


def _mlstm_inputs(B, H, S, hd, device, state="cache", seed=0):
    """q, k (pre-scaled by 1/sqrt(hd)), v, log i ~ N(0,1), log f =
    log_sigmoid(N(0,1) + 2), and a start state: "empty" (m = -1e30),
    "cache" (zeros, m = 0), or a 0.1·N(0,1) memory with m = 0.5 ("warm"),
    20 ("high") or -20 ("low")."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    q, k, v = (rng.normal(size=(B, H, S, hd)) for _ in range(3))
    li = rng.normal(size=(B, H, S))
    lf = -np.logaddexp(0.0, -(rng.normal(size=(B, H, S)) + 2.0))
    if state in ("warm", "high", "low"):
        C0 = 0.1 * rng.normal(size=(B, H, hd, hd))
        n0 = 0.1 * rng.normal(size=(B, H, hd))
    else:
        C0, n0 = np.zeros((B, H, hd, hd)), np.zeros((B, H, hd))
    m0 = np.full((B, H), MLSTM_M0[state])
    return [f32(a) for a in (q, k / np.sqrt(hd), v, li, lf, C0, n0, m0)]


def mlstm_g1(args):
    """Gate G1: the kernel against the plain version run in float64 on the
    same card (``ref``), beside the plain version in float32 (``p32``).
    h: max|h - ref| <= 2 max|h_p32 - ref| + 1e-6 max|ref|; C and n within
    2e-5 of their largest reference entry; m within 2e-5 max(1, |m_ref|).
    Returns the readings, each over its limit (pass: <= 1)."""
    out = mlstm_scan_cuda(*args)
    p32 = mlstm_scan_plain(*args)
    ref = mlstm_scan_plain(*(a.double() for a in args))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in out)
    err = lambda a, b: (a.double() - b).abs().max().item()
    h_lim = 2 * err(p32[0], ref[0]) + 1e-6 * ref[0].abs().max().item()
    res = {"h": err(out[0], ref[0]) / h_lim}
    for name, a, b in zip("Cn", out[1:3], ref[1:3]):
        res[name] = err(a, b) / (2e-5 * b.abs().max().item())
    res["m"] = ((out[3].double() - ref[3]).abs()
                / (2e-5 * ref[3].abs().clamp_min(1.0))).max().item()
    return res


# ------------------------------------------------------------------ on the CPU

def test_cpu_tensors_take_the_plain_versions():
    before = ops.launch_counts()
    args = _paged_inputs([0, 5, 9], 8, 2, 2, 64, "cpu")
    assert torch.equal(ops.paged_decode_attention(*args),
                       paged_attention_plain(*args))
    q, k, v = _flash_inputs(1, 2, 16, 16, 64, torch.float32, "cpu")
    assert torch.equal(ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2)).transpose(1, 2),
                       flash_attention_plain(q, k, v))
    assert ops.launch_counts() == before


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="one card"):
        paged_attention_cuda(*_paged_inputs([3], 8, 2, 2, 64, "cpu"))
    with pytest.raises(ValueError, match="one card"):
        flash_attention_cuda(*_flash_inputs(1, 2, 16, 16, 64, torch.float32,
                                            "cpu"))


def test_gating_on_the_cpu_takes_the_plain_version():
    """Any E and k take the plain version on the CPU: the kernel's limits
    (E <= 64, k <= 8) bind only on the card."""
    before = ops.launch_counts()
    for E, k in ((60, 4), (65, 4), (16, 9)):
        x = _gating_logits(7, E, "cpu", seed=E)
        got, want = ops.moe_gating(x, k), moe_gating_plain(x, k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == before


def test_gating_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="on a card"):
        moe_gating_cuda(_gating_logits(8, 60, "cpu"), 4)


def test_mlstm_on_the_cpu_takes_the_plain_version():
    """Any head dim takes the plain version on the CPU: the kernel's
    limits (hd a multiple of 32 up to 1024) bind only on the card."""
    before = ops.launch_counts()
    for hd in (64, 48):
        args = _mlstm_inputs(1, 2, 40, hd, "cpu")
        got, want = ops.mlstm_scan(*args), mlstm_scan_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == before


def test_mlstm_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="on q's card"):
        mlstm_scan_cuda(*_mlstm_inputs(1, 2, 8, 64, "cpu"))


def test_mlstm_prep_cuda_refuses_cpu_tensors():
    q, k, _, li, lf, _, _, m0 = _mlstm_inputs(1, 2, 8, 64, "cpu")
    with pytest.raises(ValueError, match="on q's card"):
        mlstm_prep_cuda(q, k, li, lf, m0)


# ------------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("hk,rep,hd", [(8, 4, 128), (2, 2, 64), (1, 16, 128)])
def test_paged_cuda_matches_plain(cuda, quant, hk, rep, hd):
    """Ragged lengths (empty, page edges, ~2k), poisoned stale pages.
    fp32 sums run in another order over up to ~2k keys: 1e-4."""
    args = _paged_inputs([0, 31, 32, 33, 100, 2047, 2048, 2069], 32, hk, rep,
                         hd, cuda, quant)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(*args)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


#: the smoke's edge cases (hk, rep, lengths, table width) at hd 128, page 32:
#: lengths either side of the 4-page (128-row) splits granite-8b's decode
#: plans, one slot at 8191 beside empty ones, a table far wider than any
#: length with its padding on poisoned pages, and qwen2-moe-a2.7b's heads
PAGED_EDGES = {
    "split_edges": (8, 4, [127, 128, 129, 255, 256, 257, 0, 1], None),
    "long_8191": (8, 4, [8191, 0, 0, 0, 0, 0, 0, 0], None),
    "wide_table": (8, 4, [0, 5, 40, 100, 31, 64, 1, 33], 256),
    "qwen_heads": (16, 1, [0, 31, 32, 33, 100, 2047, 2048, 2069], None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PAGED_EDGES))
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_cuda_split_edges(cuda, quant, case):
    """The split pass's edges against the plain version: 1e-4, as
    ``test_paged_cuda_matches_plain``; both passes count one launch."""
    hk, rep, lengths, width = PAGED_EDGES[case]
    args = _paged_inputs(lengths, 32, hk, rep, 128, cuda, quant, width=width)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(*args)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("hk,rep", [(8, 4), (16, 1)])
def test_paged_cuda_is_bit_repeatable(cuda, quant, hk, rep):
    """No atomics: two launches on the same inputs agree to the bit."""
    args = _paged_inputs([0, 31, 32, 33, 100, 2047, 2048, 2069], 32, hk, rep,
                         128, cuda, quant)
    a = paged_attention_cuda(*args)
    b = paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,causal,window,B,H,form", [
    (2048, 2048, True, 0, 1, 4, "bshd"), (2048, 2048, True, 128, 1, 4, "bshd"),
    (2050, 2050, True, 0, 1, 4, "bshd"), (128, 2048, False, 0, 1, 4, "bshd"),
    (100, 300, True, 64, 1, 4, "bshd"), (1, 1, True, 0, 1, 4, "bshd"),
    # ragged against the 64-row query tile and the 32-key tile
    (65, 65, True, 0, 1, 4, "bshd"), (97, 97, True, 0, 1, 4, "bshd"),
    (65, 97, False, 0, 1, 4, "bshd"),
    # windows narrower than a key tile
    (300, 300, True, 1, 1, 4, "bshd"), (300, 300, True, 17, 1, 4, "bshd"),
    (100, 300, True, 17, 1, 4, "bshd"),
    (130, 130, True, 0, 2, 4, "bshd"), (130, 130, True, 0, 1, 1, "bshd"),
    # k/v of (B, S, Hk, hd) repeat_interleaved to H heads, as the models
    # build them
    (2048, 2048, True, 0, 1, 8, "gqa"), (97, 97, True, 17, 2, 8, "gqa"),
    # q x 8: large scores, where the running-max rescale matters
    (2048, 2048, True, 0, 1, 4, "large"), (300, 300, False, 0, 1, 4, "large")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_cuda_matches_plain(cuda, Sq, Sk, causal, window, B, H, form,
                                  dtype, hd):
    q, k, v = _flash_inputs(B, H, Sq, Sk, hd, dtype, cuda, seed=Sq + window)
    if form == "gqa":
        k, v = (torch.repeat_interleave(t.transpose(1, 2)[:, :, ::4], 4, dim=2)
                .transpose(1, 2) for t in (k, v))
    elif form == "large":
        q = q * 8
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol



@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 8, 2048, 2050])
@pytest.mark.parametrize("E,K", [(60, 4), (16, 4), (64, 8)])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_gating_cuda_matches_plain(cuda, T, E, K, ties):
    """Ids exactly; weights and probabilities within 1e-6 (the softmax
    sums in another order)."""
    x = _gating_logits(T, E, cuda, seed=T + E, ties=ties)
    before = ops.launch_counts()["moe_gating"]
    w, ids, probs = ops.moe_gating(x, K)
    assert ops.launch_counts()["moe_gating"] == before + 1
    wp, ip, pp = moe_gating_plain(x, K)
    torch.cuda.synchronize()
    assert ids.dtype == torch.int32 and torch.equal(ids, ip)
    assert (w - wp).abs().max().item() <= 1e-6
    assert (probs - pp).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("E,K", [(65, 4), (16, 9), (4, 5)])
def test_gating_cuda_refuses_what_one_warp_cannot_hold(cuda, E, K):
    """On the card there is no hand-over to the plain version."""
    before = ops.launch_counts()["moe_gating"]
    with pytest.raises(ValueError, match="moe_gating_cuda"):
        ops.moe_gating(_gating_logits(8, E, cuda), K)
    with pytest.raises(ValueError, match="float32"):
        ops.moe_gating(_gating_logits(8, 60, cuda).double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_gating(_gating_logits(60, 8, cuda).T, 4)
    assert ops.launch_counts()["moe_gating"] == before


#: the smoke's mLSTM shapes (xlstm-1.3b: H = 4, hd = 1024) with the
#: serving cache's, a warm and an empty start, a ragged last chunk (65, 300
#: rows), one decode row, the JAX kernel test's fp32 shapes, and the
#: narrowest head the kernel takes; then the edges of the kernel's 64-row
#: chunks (S = 63, 64, 65, one row, B*H = 12), head dims 32, 64, 96 (its
#: narrow-head paths) and 1024, and warm starts with m far from 0.  A
#: sixth entry is the input seed (else S + hd): 1287, on which the first
#: pass's gate arithmetic in fp32 takes G1 past its bound (1.14 on the
#: H100), and 1241, the largest reading of the m0 = -20 sweep below
MLSTM_CASES = [(1, 4, 2048, 1024, "cache"), (1, 4, 300, 1024, "cache"),
               (2, 4, 512, 1024, "warm"), (1, 4, 1, 1024, "warm"),
               (1, 1, 128, 64, "empty"), (2, 2, 256, 64, "empty"),
               (1, 2, 256, 128, "empty"), (2, 1, 512, 256, "empty"),
               (2, 3, 65, 32, "warm"),
               (1, 2, 63, 64, "warm"), (1, 2, 64, 1024, "cache"),
               (1, 2, 65, 1024, "warm"), (1, 1, 1, 32, "empty"),
               (3, 4, 129, 64, "warm"), (1, 2, 100, 96, "warm"),
               (1, 2, 200, 64, "high"), (1, 2, 200, 1024, "low"),
               (1, 4, 256, 1024, "high"), (1, 4, 256, 1024, "high", 1287),
               (1, 2, 200, 1024, "low", 1241)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,hd,state,seed",
                         [(*c, None)[:6] for c in MLSTM_CASES],
                         ids=["-".join(map(str, c)) for c in MLSTM_CASES])
def test_mlstm_cuda_matches_plain_under_g1(cuda, B, H, S, hd, state, seed):
    before = ops.launch_counts()["mlstm_scan"]
    res = mlstm_g1(_mlstm_inputs(B, H, S, hd, cuda, state,
                                 seed=S + hd if seed is None else seed))
    assert max(res.values()) <= 1.0, res
    assert ops.launch_counts()["mlstm_scan"] == before + 1


#: warm starts with m far from 0 (and m = 0.5), at xlstm-1.3b's head width
#: and a narrow one, each over MLSTM_SWEEP_SEEDS input seeds
MLSTM_SWEEP_CASES = [(1, 4, 256, 1024, "high"), (1, 4, 256, 64, "high"),
                     (1, 4, 512, 1024, "high"), (1, 2, 200, 1024, "low"),
                     (1, 4, 256, 1024, "warm")]
MLSTM_SWEEP_SEEDS = 20


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,hd,state", MLSTM_SWEEP_CASES)
def test_mlstm_cuda_g1_over_seeds(cuda, B, H, S, hd, state):
    """G1 bounds the kernel's error by twice the fp32 plain version's,
    which is itself a rounding draw where a row's denominator nearly
    cancels: one seed can pass by luck, so this takes seeds S + hd + i for
    i < MLSTM_SWEEP_SEEDS.  Prints each seed's largest reading (run with
    ``-s`` to see them)."""
    worst = [max(mlstm_g1(_mlstm_inputs(B, H, S, hd, cuda, state,
                                        seed=S + hd + i)).values())
             for i in range(MLSTM_SWEEP_SEEDS)]
    print("mlstm_g1_over_seeds", json.dumps(
        {"case": [B, H, S, hd, state], "m0": MLSTM_M0[state],
         "first_seed": S + hd, "g1_max_per_seed": worst}))
    assert max(worst) <= 1.0, worst


#: the first pass alone, against its plain function in float64: ragged,
#: one row, several chunks from each start
MLSTM_PREP_CASES = [(1, 4, 2048, 1024, "cache"), (2, 2, 300, 64, "empty"),
                    (1, 2, 1, 32, "warm"), (3, 4, 129, 96, "high"),
                    (1, 2, 200, 64, "low")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,hd,state", MLSTM_PREP_CASES)
def test_mlstm_prep_cuda_matches_plain(cuda, B, H, S, hd, state):
    """What the first pass hands the walk, against mlstm_prep_plain run in
    float64 on the same inputs.  P and its row sums are fp32 sums of up to
    1024 products times an exponential: within 1e-5 of their largest
    entry; the weights w, wk and carry lie in [0, 1]: within 1e-5; the
    stabilisers m_t, m and m_T within 2e-5 max(1, |m|), as gate G1's m.
    n's increments nk, sums of 64 products of k and wk, within 1e-5 of
    their largest entry.  Rows past S hold zeros.  The library's chunk width is
    the plain passes' default."""
    q, k, _, li, lf, _, _, m0 = _mlstm_inputs(B, H, S, hd, cuda, state,
                                              seed=S + hd)
    before = ops.launch_counts()["mlstm_scan"]
    got = mlstm_prep_cuda(q, k, li, lf, m0)
    assert got.P.shape[-1] == KERNEL_CHUNK
    want = mlstm_prep_plain(*(a.double() for a in (q, k, li, lf, m0)))
    torch.cuda.synchronize()
    assert ops.launch_counts()["mlstm_scan"] == before
    assert got.nk.dtype == torch.float64
    assert (got.nk - want.nk).abs().max().item() <= 1e-5 * want.nk.abs().max().item()
    for name in ("P", "rs"):
        a, b = getattr(got, name).double(), getattr(want, name)
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item(), name
    for name in ("w", "wk", "carry"):
        a, b = getattr(got, name).double(), getattr(want, name)
        assert (a - b).abs().max().item() <= 1e-5, name
    for name in ("mt", "m", "m_T"):
        a, b = getattr(got, name).double(), getattr(want, name)
        assert ((a - b).abs() / b.abs().clamp_min(1.0)).max().item() <= 2e-5, name
    past = torch.arange(got.w.shape[-1], device=cuda) >= S
    for name in ("w", "mt", "rs", "wk"):
        assert not getattr(got, name)[..., past].any(), name


@pytest.mark.gpu
def test_mlstm_cuda_refuses_what_it_cannot_take(cuda):
    """On the card there is no hand-over to the plain version."""
    before = ops.launch_counts()["mlstm_scan"]
    for hd in (48, 16, 2048):
        with pytest.raises(ValueError, match="hd must be"):
            ops.mlstm_scan(*_mlstm_inputs(1, 1, 8, hd, cuda))
    args = _mlstm_inputs(1, 2, 8, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.mlstm_scan(*(a.double() for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        ops.mlstm_scan(args[0].transpose(2, 3).contiguous().transpose(2, 3),
                       *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ops.mlstm_scan(*args[:5], args[5][:, :, :32].contiguous(), *args[6:])
    assert ops.launch_counts()["mlstm_scan"] == before
