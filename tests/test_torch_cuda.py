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

