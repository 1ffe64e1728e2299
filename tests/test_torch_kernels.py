"""The port's kernels against the JAX package's plain references.

The port's plain versions are held against ``paged_attention_jnp``,
``ref.attention_ref`` and ``chunked.flash_attention_jnp`` on the same numpy
inputs.  The CUDA kernels are held against the plain versions on the card
in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_jnp
from repro.kernels.ref import attention_ref
from repro.models.chunked import flash_attention_jnp
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain

#: fp32 / bf16 tolerances of the JAX package's kernel tests
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

PAGE = 8
NP = 4          # pages per slot: up to NP*PAGE - 1 cached tokens
HK, REP, HD = 2, 2, 16
HQ = HK * REP

#: empty cache, one short of a page, exactly one page, mid-pool
LENGTHS = [0, PAGE - 1, PAGE, 2 * PAGE + 5]
#: caches ending exactly on page boundaries (and the fullest legal one)
PAGE_MULTIPLES = [NP * PAGE - 1, PAGE, 2 * PAGE, 3 * PAGE]


def _quantize_pool(pool):
    """Per-(page, kv-head) maxabs int8, as the engines store pages."""
    amax = np.abs(pool).max(axis=(1, 3))
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.rint(pool / scales[:, None, :, None]).astype(np.int8)
    return q, scales


def _paged_problem(seed, lengths, page=PAGE, n_pages=NP, hk=HK, rep=REP,
                   hd=HD, poison=False, quant=False):
    """numpy inputs; with ``poison`` every pool position a slot does not
    own below its length holds a large finite value."""
    rng = np.random.default_rng(seed)
    M = len(lengths)
    P = n_pages * M + 3
    kp = rng.normal(size=(P, page, hk, hd)).astype(np.float32)
    vp = rng.normal(size=(P, page, hk, hd)).astype(np.float32)
    bt = rng.permutation(P)[: n_pages * M].reshape(M, n_pages).astype(np.int32)
    if poison:
        live = np.zeros((P, page), bool)
        for m, L in enumerate(lengths):
            for t in range(L):
                live[bt[m, t // page], t % page] = True
        kp[~live] = 1e4
        vp[~live] = -1e4
    args = dict(
        q=rng.normal(size=(M, hk * rep, hd)).astype(np.float32),
        k_pool=kp, v_pool=vp, block_tables=bt,
        lengths=np.asarray(lengths, np.int32),
        k_new=rng.normal(size=(M, hk, hd)).astype(np.float32),
        v_new=rng.normal(size=(M, hk, hd)).astype(np.float32))
    if quant:
        args["k_pool"], args["k_scales"] = _quantize_pool(kp)
        args["v_pool"], args["v_scales"] = _quantize_pool(vp)
    return args


def _torch(args, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in args.items()}


@pytest.mark.parametrize("lengths", [LENGTHS, PAGE_MULTIPLES],
                         ids=["ragged", "page_multiples"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("poison", [False, True], ids=["clean", "poisoned"])
def test_paged_plain_matches_jnp(lengths, quant, poison):
    args = _paged_problem(1, lengths, poison=poison, quant=quant)
    want = np.asarray(paged_attention_jnp(
        **{k: jnp.asarray(v) for k, v in args.items()}))
    got = ops.paged_decode_attention(**_torch(args)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL["float32"],
                               atol=TOL["float32"] / 10)


def test_paged_poison_does_not_leak():
    """Stale pool contents past each slot's length never reach the output."""
    clean = _paged_problem(2, LENGTHS)
    dirty = _paged_problem(2, LENGTHS, poison=True)
    a = paged_attention_plain(**_torch(clean)).numpy()
    b = paged_attention_plain(**_torch(dirty)).numpy()
    np.testing.assert_allclose(a, b, rtol=TOL["float32"], atol=1e-6)


def test_paged_plain_refuses_length_past_table():
    """A length at or past the table does not read past it: as the
    reference (whose write of the current token clamps to the last row), it
    attends the cached rows below ``NP * PAGE - 1`` and the current token,
    exactly as at ``NP * PAGE - 1``."""
    args = _paged_problem(3, [NP * PAGE, NP * PAGE + 5])
    want = np.asarray(paged_attention_jnp(
        **{k: jnp.asarray(v) for k, v in args.items()}))
    got = paged_attention_plain(**_torch(args))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["float32"],
                               atol=TOL["float32"] / 10)
    args["lengths"][:] = NP * PAGE - 1
    assert torch.equal(paged_attention_plain(**_torch(args)), got)


def _flash_inputs(seed, B, H, Sq, Sk, hd, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda S: rng.normal(size=(B, H, S, hd)).astype(np.float32)
    q, k, v = mk(Sq), mk(Sk), mk(Sk)
    if dtype == "bfloat16":     # round once, identically, for both sides
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                   for x in (q, k, v))
    return q, k, v


def _as(x, dtype, lib):
    if lib == "jax":
        return jnp.asarray(x, getattr(jnp, dtype))
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,H,Sq,Sk,hd", [
    (1, 2, 128, 128, 64),
    (1, 2, 256, 512, 128),      # more keys than queries (cached-ish)
    (1, 1, 2050, 2050, 16),     # ragged, two key blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 128])
def test_flash_plain_matches_references(B, H, Sq, Sk, hd, dtype, window):
    q, k, v = _flash_inputs(B * 7 + Sq, B, H, Sq, Sk, hd, dtype)
    got = flash_attention_plain(_as(q, dtype, "torch"), _as(k, dtype, "torch"),
                                _as(v, dtype, "torch"), causal=True,
                                window=window).float().numpy()
    ref = np.asarray(attention_ref(_as(q, dtype, "jax"), _as(k, dtype, "jax"),
                                   _as(v, dtype, "jax"), causal=True,
                                   window=window).astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    # the streaming form the JAX model runs, in its (B, S, H, hd) layout
    tr = lambda x: _as(x.transpose(0, 2, 1, 3), dtype, "jax")
    chunked = flash_attention_jnp(tr(q), tr(k), tr(v), True, window, Sk - Sq)
    chunked = np.asarray(chunked.astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, chunked, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_noncausal(dtype):
    q, k, v = _flash_inputs(0, 1, 2, 128, 256, 64, dtype)
    got = flash_attention_plain(_as(q, dtype, "torch"), _as(k, dtype, "torch"),
                                _as(v, dtype, "torch"),
                                causal=False).float().numpy()
    ref = np.asarray(attention_ref(_as(q, dtype, "jax"), _as(k, dtype, "jax"),
                                   _as(v, dtype, "jax"),
                                   causal=False).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=TOL[dtype])
    tr = lambda x: _as(x.transpose(0, 2, 1, 3), dtype, "jax")
    chunked = flash_attention_jnp(tr(q), tr(k), tr(v), False, 0, 0)
    chunked = np.asarray(chunked.astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, chunked, atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_dispatch_layout_and_causal_guard():
    """``ops.flash_attention`` takes (B, S, H, hd) like the JAX wrapper, and
    causal attention with more queries than keys is refused."""
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(5, 1, 2, 64, 64, 16,
                                                          "float32"))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=0)
    want = flash_attention_plain(q, k, v).transpose(1, 2)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        flash_attention_plain(q, k[:, :, :32], v[:, :, :32])
