"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The ``gpu`` tests skip on a machine without a card.  The rest check, on the
CPU, that the dispatcher routes by device and that the CUDA wrappers
refuse what their kernels do not take.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.moe_gating import moe_gating_cuda, moe_gating_plain
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.serving.batch import _quant_page_int8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _paged_inputs(lengths, page, hk, rep, hd, device, quant=False, seed=0):
    """Pool, tables and queries; every pool row a slot does not own below
    its length is poisoned with a large finite value."""
    rng = np.random.default_rng(seed)
    owned = [-(-(L + 1) // page) for L in lengths]
    P = sum(owned) + 3
    perm = rng.permutation(P)
    bt = np.zeros((len(lengths), max(owned)), np.int32)
    live = np.zeros((P, page), bool)
    at = 0
    for m, (L, n) in enumerate(zip(lengths, owned)):
        bt[m, :n] = perm[at:at + n]
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


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, 0), (2048, 2048, True, 128), (2050, 2050, True, 0),
    (128, 2048, False, 0), (100, 300, True, 64), (1, 1, True, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_cuda_matches_plain(cuda, Sq, Sk, causal, window, dtype, hd):
    q, k, v = _flash_inputs(1, 4, Sq, Sk, hd, dtype, cuda, seed=Sq + window)
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
