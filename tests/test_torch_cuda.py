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
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.mlstm_scan import (KERNEL_CHUNK, mlstm_prep_cuda,
                                            mlstm_prep_plain, mlstm_scan_cuda,
                                            mlstm_scan_plain)
from repro_torch.kernels.moe_gating import (moe_gating_cuda, moe_gating_plain,
                                           router_gating_cuda,
                                           router_gating_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain,
                                                 split_pages)
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


def _router_inputs(T, D, E, device, seed=0, scale=None, ties=False):
    """x ~ N(0, 1) (T, D) and a router ~ N(0, scale^2) (D, E), by default
    scale = 2 / sqrt(D) (logits spread about 2); with ``ties`` the router's
    columns come in equal pairs and x's row 0 is zero, so twin logits are
    equal and row 0 is uniform."""
    rng = np.random.default_rng(seed)
    scale = 2 / np.sqrt(D) if scale is None else scale
    x = rng.normal(size=(T, D))
    if ties:
        half = rng.normal(size=(D, E // 2)) * scale
        router = np.concatenate([half, half], axis=1)
        x[0] = 0
    else:
        router = rng.normal(size=(D, E)) * scale
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return t(x), t(router)


#: two runs may order experts differently only where the K-th and (K+1)-th
#: probabilities are this close (a rounding tie)
TIE_GAP = 1e-5


def _check_router(got, want, k, ties=False):
    """Ids equal in every row whose plain K-th and (K+1)-th probabilities
    differ by more than TIE_GAP (every row for constructed ties), weights
    within 1e-6 on the rows whose ids agree, probabilities within 1e-6."""
    w, ids, probs = got
    wp, ip, pp = want
    top = pp.topk(k + 1, dim=1).values
    near = top[:, k - 1] - top[:, k] <= TIE_GAP
    agree = (ids == ip).all(dim=1)
    assert ids.dtype == torch.int32
    assert bool(agree.all() if ties else agree[~near].all())
    assert (w - wp)[agree].abs().max().item() <= 1e-6
    assert (probs - pp).abs().max().item() <= 1e-6


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


def test_flash_bwd_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _flash_inputs(1, 2, 16, 16, 64, torch.float32, "cpu")
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="one card"):
        flash_attention_bwd_cuda(q, k, v, q, lse, q)


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


def test_router_gating_on_the_cpu_takes_the_plain_version():
    """On the CPU any D, E and k take the plain version: the kernel's limits
    bind only on the card."""
    before = ops.launch_counts()
    for D, E, k in ((64, 60, 4), (30, 65, 4), (16, 16, 9)):
        x, router = _router_inputs(7, D, E, "cpu", seed=E)
        got, want = (ops.router_gating(x, router, k),
                     router_gating_plain(x, router, k))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == before


def test_router_gating_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="on one card"):
        router_gating_cuda(*_router_inputs(8, 64, 60, "cpu"), 4)


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
@pytest.mark.parametrize("hk,rep,hd", [(8, 4, 128), (2, 2, 64), (1, 16, 128),
                                        (36, 1, 64)])
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


#: the smoke's edge cases (hk, rep, hd, lengths, table width) at page 32:
#: lengths either side of the 4-page (128-row) splits granite-8b's decode
#: plans, one slot at 8191 beside empty ones, a table far wider than any
#: length with its padding on poisoned pages, qwen2-moe-a2.7b's heads, one
#: long session decoding alone or beside a short one (64 splits of 4 pages,
#: past the 32 the merge pass reads at once), and the serving fleet's
#: decode at minicpm-2b's heads (Hk=36, rep 1, hd 64)
PAGED_EDGES = {
    "split_edges": (8, 4, 128, [127, 128, 129, 255, 256, 257, 0, 1], None),
    "long_8191": (8, 4, 128, [8191, 0, 0, 0, 0, 0, 0, 0], None),
    "wide_table": (8, 4, 128, [0, 5, 40, 100, 31, 64, 1, 33], 256),
    "qwen_heads": (16, 1, 128, [0, 31, 32, 33, 100, 2047, 2048, 2069], None),
    "alone_8191": (8, 4, 128, [8191], None),
    "pair_8191_33": (8, 4, 128, [8191, 33], None),
    "minicpm_fleet": (36, 1, 64, [2063, 315, 79, 27], None),
    "minicpm_page_edges": (36, 1, 64, [2047, 2048, 2049, 160], None),
}
#: the cases whose plan has more than 32 splits
PAGED_64_SPLITS = ("alone_8191", "pair_8191_33")


def test_the_long_session_cases_plan_64_splits():
    for case in PAGED_64_SPLITS:
        hk, _, _, lengths, _ = PAGED_EDGES[case]
        NP = -(-(max(lengths) + 1) // 32)
        assert -(-NP // split_pages(NP, 32, len(lengths), hk)) == 64, case


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PAGED_EDGES))
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_cuda_split_edges(cuda, quant, case):
    """The split pass's edges against the plain version: 1e-4, as
    ``test_paged_cuda_matches_plain``; both passes count one launch."""
    hk, rep, hd, lengths, width = PAGED_EDGES[case]
    args = _paged_inputs(lengths, 32, hk, rep, hd, cuda, quant, width=width)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(*args)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("hk,rep,hd", [(8, 4, 128), (16, 1, 128), (36, 1, 64)])
def test_paged_cuda_is_bit_repeatable(cuda, quant, hk, rep, hd):
    """No atomics: two launches on the same inputs agree to the bit."""
    args = _paged_inputs([0, 31, 32, 33, 100, 2047, 2048, 2069], 32, hk, rep,
                         hd, cuda, quant)
    a = paged_attention_cuda(*args)
    b = paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_64_SPLITS)
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_cuda_past_32_splits_is_bit_repeatable(cuda, quant, case):
    hk, rep, hd, lengths, _ = PAGED_EDGES[case]
    args = _paged_inputs(lengths, 32, hk, rep, hd, cuda, quant, seed=7)
    a = paged_attention_cuda(*args)
    b = paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("over", [0, 5], ids=["T", "T+5"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_cuda_length_past_the_table(cuda, quant, over):
    """At ``length >= T = NP * page`` both passes read the length as
    ``T - 1``, as the plain version and the reference do (row ``T - 1``,
    which would be read otherwise, is poisoned): 1e-4."""
    args = _paged_inputs([2047, 40, 0, 95], 32, 8, 4, 128, cuda, quant)
    T = args[3].shape[1] * 32                  # slot 0 owns every page
    args[4][0] = T + over
    got = paged_attention_cuda(*args)
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-4


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


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 8, 300, 2048, 2050])
@pytest.mark.parametrize("D,E,K", [(2048, 60, 4), (2048, 16, 4),
                                   (1024, 64, 8), (64, 60, 4)])
def test_router_gating_cuda_matches_plain(cuda, T, D, E, K):
    """The router kernel against ``router_gating_plain`` (fp64 products
    rounded once on both sides), under ``_check_router``'s bounds; two
    launches agree to the bit; one launch counted under moe_gating."""
    x, router = _router_inputs(T, D, E, cuda, seed=T + D + E)
    before = ops.launch_counts()["moe_gating"]
    got = ops.router_gating(x, router, K)
    assert ops.launch_counts()["moe_gating"] == before + 1
    again = router_gating_cuda(x, router, K)
    want = router_gating_plain(x, router, K)
    torch.cuda.synchronize()
    _check_router(got, want, K)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("T,D", [(8, 100), (600, 100), (8, 2052), (600, 2052)])
def test_router_gating_cuda_ragged_slices(cuda, T, D):
    """D that the plan's slices do not divide evenly: empty ranks at the
    end of a cluster (D = 100 over 16 blocks), slices shorter than a
    128-row piece, and a last piece of a few rows."""
    x, router = _router_inputs(T, D, 60, cuda, seed=T + D)
    got = router_gating_cuda(x, router, 4)
    want = router_gating_plain(x, router, 4)
    torch.cuda.synchronize()
    _check_router(got, want, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("T,scale,ties", [(2048, 0.02, False), (8, None, True),
                                          (2050, None, True)],
                         ids=["init_scale", "ties8", "ties2050"])
def test_router_gating_cuda_init_scale_and_ties(cuda, T, scale, ties):
    """The init's 0.02 router scale, and constructed ties (twin router
    columns, a zero row of x), whose ids must be equal in every row."""
    x, router = _router_inputs(T, 2048, 60, cuda, seed=T, scale=scale,
                               ties=ties)
    got = router_gating_cuda(x, router, 4)
    want = router_gating_plain(x, router, 4)
    torch.cuda.synchronize()
    _check_router(got, want, 4, ties=ties)
    if ties:
        assert got[1][0].tolist() == [0, 1, 2, 3]


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("T", [8, 2048])
def test_router_gating_cuda_every_cluster_size(cuda, cluster, T):
    """Every cluster size the kernel takes, at decode's and a prompt's
    token rows (the plan's own sizes are 16 and 2)."""
    x, router = _router_inputs(T, 2048, 60, cuda, seed=cluster + T)
    got = router_gating_cuda(x, router, 4, cluster)
    again = router_gating_cuda(x, router, 4, cluster)
    want = router_gating_plain(x, router, 4)
    torch.cuda.synchronize()
    _check_router(got, want, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_router_gating_cuda_refuses_what_it_cannot_take(cuda):
    """On the card there is no hand-over to the plain version."""
    before = ops.launch_counts()["moe_gating"]
    x, router = _router_inputs(8, 64, 60, cuda)
    refused = {
        "E must be": (x, _router_inputs(8, 64, 65, cuda)[1], 4),
        "k must be": (x, router, 9),
        "multiple of 4": (*_router_inputs(8, 30, 60, cuda), 4),
        "float32": (x.double(), router.double(), 4),
        "contiguous": (x, router.T.contiguous().T, 4),
        "aligned": (torch.empty(8 * 64 + 1, device=cuda)[1:].view(8, 64),
                    router, 4),
        "16-byte": (x, torch.empty(64 * 60 + 1, device=cuda)[1:].view(64, 60),
                    4),
        "rows": (x, router[:32].contiguous(), 4),
    }
    for match, args in refused.items():
        with pytest.raises(ValueError, match=match):
            ops.router_gating(*args)
    with pytest.raises(ValueError, match="cluster"):
        router_gating_cuda(x, router, 4, 3)
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


# ------------------------------------------------------- flash backward (T1)

#: T1 (``ROADMAP.md``, "Parity discipline"): (B, H, Sq, Sk, causal, window,
#: hd): minicpm-2b's and granite-8b's causal 2048, windows 128 and 1,
#: ragged 2050, B=2 at 97, non-causal, and Sq < Sk with a window
FLASH_BWD_CASES = [(1, 36, 2048, 2048, True, 0, 64),
                   (1, 32, 2048, 2048, True, 0, 128),
                   (1, 36, 2048, 2048, True, 128, 64),
                   (1, 8, 2048, 2048, True, 128, 128),
                   (1, 8, 300, 300, True, 1, 64),
                   (1, 36, 2050, 2050, True, 0, 64),
                   (1, 8, 2050, 2050, True, 0, 128),
                   (2, 8, 97, 97, True, 0, 64),
                   (1, 32, 128, 2048, False, 0, 128),
                   (1, 8, 65, 97, False, 0, 64),
                   (2, 4, 97, 300, True, 17, 128)]


def _flash_bwd_inputs(B, H, Sq, Sk, hd, causal, window, device, seed=0):
    """q, k, v, out, lse, dO on ``device`` in the model's layout ((B, S, H,
    hd) viewed as (B, H, S, hd)); out and lse are the plain forward in
    float64, rounded to fp32, so every backward input is an fp32 value."""
    q, k, v = _flash_inputs(B, H, Sq, Sk, hd, torch.float32, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn((B, Sq, H, hd), generator=g).to(device).transpose(1, 2)
    out64, lse64 = flash_attention_plain(q.double(), k.double(), v.double(),
                                         causal=causal, window=window,
                                         return_lse=True)
    out = torch.empty_like(q).copy_(out64)
    return q, k, v, out, lse64.float().contiguous(), do


def flash_bwd_t1(args, causal, window):
    """Per gradient, max|g_kernel - g64| over its T1 bound 2 max|g32 - g64|
    + 1e-6 max|g64| (g64, g32: the plain backward in float64 and fp32)."""
    g64 = flash_attention_bwd_plain(*(a.double() for a in args),
                                    causal=causal, window=window)
    g32 = flash_attention_bwd_plain(*args, causal=causal, window=window)
    gk = flash_attention_bwd_cuda(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    res = {}
    for name, a, b, c in zip(("dq", "dk", "dv"), gk, g32, g64):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all()), name
        bound = (2 * (b.double() - c).abs().max().item()
                 + 1e-6 * c.abs().max().item())
        res[name] = (a.double() - c).abs().max().item() / bound
    return res, gk


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,causal,window,hd", FLASH_BWD_CASES)
def test_flash_bwd_cuda_holds_t1(cuda, B, H, Sq, Sk, causal, window, hd):
    args = _flash_bwd_inputs(B, H, Sq, Sk, hd, causal, window, cuda,
                             seed=Sq + window)
    ratios, got = flash_bwd_t1(args, causal, window)
    assert max(ratios.values()) <= 1.0, ratios
    again = flash_attention_bwd_cuda(*args, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the forward's lse against the plain version's
    q, k, v = args[:3]
    _, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    _, want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    torch.cuda.synchronize()
    assert (lse - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,causal,window,H,hd", [
    (2048, 2048, True, 0, 36, 64), (2050, 2050, True, 128, 8, 128),
    (97, 97, True, 1, 4, 64), (128, 2048, False, 0, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cuda_lse_leaves_the_output_unchanged(cuda, Sq, Sk, causal,
                                                    window, H, hd, dtype):
    q, k, v = _flash_inputs(1, H, Sq, Sk, hd, dtype, cuda, seed=Sq)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    out2, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    assert lse.dtype == torch.float32 and lse.shape == (1, H, Sq)


@pytest.mark.gpu
def test_flash_bwd_cuda_refuses_what_it_cannot_take(cuda):
    args = _flash_bwd_inputs(1, 2, 64, 64, 64, True, 0, cuda)
    before = ops.launch_counts()["flash_attention_bwd"]
    with pytest.raises(ValueError, match="float32 only"):
        flash_attention_bwd_cuda(*(a.bfloat16() for a in args[:4]), args[4],
                                 args[5].bfloat16())
    with pytest.raises(ValueError, match="head dim must be one of"):
        flash_attention_bwd_cuda(*(a[..., :32] for a in args[:4]), args[4],
                                 args[5][..., :32])
    assert ops.launch_counts()["flash_attention_bwd"] == before


@pytest.mark.gpu
def test_flash_function_on_the_card_launches_both_kernels(cuda):
    """Under grad ``ops.flash_attention`` runs the forward kernel with lse,
    and the backward kernel, once each; its gradients are the kernel's."""
    q, k, v, out, lse, do = _flash_bwd_inputs(1, 4, 300, 300, 64, True, 0,
                                              cuda)
    leaves_ = [t.transpose(1, 2).detach().requires_grad_(True)
               for t in (q, k, v)]
    before = ops.launch_counts()
    y = ops.flash_attention(*leaves_, causal=True)
    y.backward(do.transpose(1, 2))
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    qt, kt, vt = (t.detach().transpose(1, 2) for t in leaves_)
    y2, lse2 = flash_attention_cuda(qt, kt, vt, return_lse=True)
    want = flash_attention_bwd_cuda(qt, kt, vt, y2, lse2, do)
    for t, w in zip(leaves_, want):
        assert torch.equal(t.grad.transpose(1, 2), w)


# ------------------------------------------------ train step, card vs CPU (T2)

def _t2_runs(mb, steps=3):
    """A reduced minicpm-2b (L=2, d=256, H=4, hd=64, vocab 256), B=2,
    S=2048, from one state on the card in fp32 and on the CPU in fp32 and
    float64: step 1's gradient leaves, then each step's loss and grad
    norm, and the launch counts of each run."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.optim import constant_schedule
    from repro_torch.tree import leaves, tree_map
    from repro_torch.params import train_state_from_numpy, train_state_to_numpy
    from repro_torch.train import make_train_step, train_state_init

    cfg = get_config("minicpm-2b").reduced(n_layers=2, d_model=256, vocab=256)
    assert cfg.hd == 64
    base = train_state_to_numpy(
        train_state_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    data = make_batch_iterator(cfg.vocab, 2048, 2, seed=0)
    batches = [next(data) for _ in range(steps)]
    runs = {}
    for name, dev, dt in (("card32", "cuda", np.float32),
                          ("cpu32", "cpu", np.float32),
                          ("cpu64", "cpu", np.float64)):
        cast = lambda t: tree_map(lambda a: a.astype(dt), t)
        state = train_state_from_numpy(base._replace(
            params=cast(base.params), opt=type(base.opt)(
                base.opt.step, cast(base.opt.mu), cast(base.opt.nu))), dev)
        step = make_train_step(cfg, constant_schedule(1e-3), microbatches=mb)
        before = ops.launch_counts()
        _, _, grads = step.grads_of(state.params, {
            k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()})
        grads = [g.double().cpu() for g in leaves(grads)]
        hist = []
        for b in batches:
            state, m = step(state, b)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        after = ops.launch_counts()
        runs[name] = (grads, hist, {k: after[k] - before[k] for k in after})
    return cfg, runs


def t2_report(runs):
    """Ratios to T2's bound max(1e-4, 2 max|cpu32 - cpu64|): the gradient
    leaves of step 1 (each over its leaf's largest |cpu64| entry), and each
    step's loss and grad norm."""
    card, c32, c64 = (runs[k] for k in ("card32", "cpu32", "cpu64"))
    grads = []
    for a, b, c in zip(card[0], c32[0], c64[0]):
        scale = c.abs().max().item()
        err = (a - c).abs().max().item() / scale
        bound = max(1e-4, 2 * (b - c).abs().max().item() / scale)
        grads.append(err / bound)
    steps = [[abs(a - c) / max(1e-4, 2 * abs(b - c)) for a, b, c in
              zip(x, y, z)] for x, y, z in zip(card[1], c32[1], c64[1])]
    return {"grads": grads, "steps": steps}


@pytest.mark.gpu
def test_train_step_card_matches_cpu_t2(cuda):
    cfg, runs = _t2_runs(mb=1)
    rep = t2_report(runs)
    assert max(rep["grads"]) <= 1.0, rep
    assert max(max(s) for s in rep["steps"]) <= 1.0, rep
    L = cfg.n_layers
    assert runs["card32"][2]["flash_attention"] == 4 * L
    assert runs["card32"][2]["flash_attention_bwd"] == 4 * L
    assert not any(runs["cpu32"][2].values())
    assert not any(runs["cpu64"][2].values())


# ------------------------------------------------------- checkpoint (C1-C3)

@pytest.mark.gpu
def test_checkpoint_golden_cids_of_card_held_trees(cuda):
    """Gate C1: trees held on the card encode to the constants the JAX
    package computed on the CPU."""
    import chip_smoke

    for kind, tree in chip_smoke.golden_trees(torch, "cuda").items():
        assert chip_smoke.checkpoint_digests(
            tree, int8=kind == "fp32") == chip_smoke.CKPT_GOLDEN[kind], kind


@pytest.mark.gpu
def test_checkpoint_of_a_card_trained_model_round_trips(cuda, tmp_path):
    """Gates C2 and C3 at T2's width: a reduced minicpm-2b trained on the
    card by ``launch.train --save`` loads back onto the card bit for bit,
    and re-encodes to the file's bytes and to the trained tree's parts
    root."""
    import hashlib

    import chip_smoke
    from repro_torch.checkpoint import (load_local, params_to_bytes,
                                        params_to_parts)
    from repro_torch.configs import get_config
    from repro_torch.core.cid import build_tree_dag
    from repro_torch.launch import train as launch_train
    from repro_torch.models import decoder

    red = chip_smoke.T2_REDUCED
    path = str(tmp_path / "t2.lck")
    trainer = launch_train.run([
        "--arch", "minicpm-2b", "--reduced", "--layers",
        str(red["n_layers"]), "--d-model", str(red["d_model"]), "--vocab",
        str(red["vocab"]), "--steps", "2", "--batch", "1", "--seq", "256",
        "--save", path])
    trained = trainer.state.params
    cfg = get_config("minicpm-2b").reduced(**red)
    fresh = decoder.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "cuda")
    loaded = load_local(path, like=fresh)
    want = dict(chip_smoke.named_leaves(trained))
    moved = 0
    for name, b in chip_smoke.named_leaves(loaded):
        a = want.pop(name)
        assert b.is_cuda and b.dtype == a.dtype and b.shape == a.shape, name
        assert torch.equal(a.detach(), b), name
        moved += not torch.equal(dict(chip_smoke.named_leaves(fresh))[name], b)
    assert not want and moved > 0
    with open(path, "rb") as f:
        file_sha = hashlib.sha256(f.read()).hexdigest()
    assert hashlib.sha256(params_to_bytes(loaded)).hexdigest() == file_sha
    assert build_tree_dag(params_to_parts(loaded)).root == \
        build_tree_dag(params_to_parts(trained)).root
