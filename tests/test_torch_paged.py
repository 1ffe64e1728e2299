"""The paged-decode kernel's two passes, in plain PyTorch, on the CPU.

``csrc/paged_attention.cu`` cuts each slot's pages into splits of
``split_pages(NP, page, M, Hk)`` pages, writes one partial softmax state
(m, l, acc) per split, then merges the current token and the partials in
split order.  ``paged_split_plain`` and ``paged_merge_plain`` are those
passes.  Here they are held, on the same numpy inputs, against an
independent float64 restatement of the one-pass version (1e-12), against
``paged_attention_plain`` itself and against the JAX package's
``paged_attention_jnp`` (the JAX kernel tests' fp32 tolerance).  The kernel
is held against ``paged_attention_plain`` on the card in
``test_torch_cuda.py``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_jnp
from repro_torch.kernels.paged_attention import (MIN_SPLIT_ROWS, TARGET_BLOCKS,
                                                 paged_attention_plain,
                                                 paged_merge_plain,
                                                 paged_split_plain,
                                                 split_pages)

#: the JAX package's fp32 kernel tolerance (rtol; atol a tenth of it)
TOL32 = 2e-5
PAGE = 8
HK, REP, HD = 2, 2, 16

#: empty, around one page, a few pages
RAGGED = [0, 1, 7, 8, 9, 21]
#: every edge of 1-, 2- and 4-page splits at page 8 (multiples of 8 and 16,
#: one either side of 32 and 64)
SPLIT_EDGES = [15, 16, 17, 31, 32, 33, 63, 64, 65]
#: one long slot beside empty ones
LONG = [0, 301, 0, 0]
LENGTHS = {"ragged": RAGGED, "split_edges": SPLIT_EDGES, "long": LONG}


def _problem(lengths, seed=0, quant=False, width=None):
    """numpy inputs at page 8.  Every pool row a slot does not own below its
    length is poisoned with a large finite value; the block table is
    ``width`` pages wide (default: the widest slot's pages), and its padding
    points at poisoned pages no slot owns."""
    rng = np.random.default_rng(seed)
    owned = [-(-(L + 1) // PAGE) for L in lengths]
    NP = max(owned) if width is None else width
    P = sum(owned) + 5
    perm = rng.permutation(P)
    spare = perm[sum(owned):]                       # pages no slot owns
    bt = np.zeros((len(lengths), NP), np.int32)
    live = np.zeros((P, PAGE), bool)
    at = 0
    for m, (L, n) in enumerate(zip(lengths, owned)):
        bt[m, :n] = perm[at:at + n]
        bt[m, n:] = spare[np.arange(NP - n) % len(spare)]
        at += n
        for t in range(L):
            live[bt[m, t // PAGE], t % PAGE] = True
    kp = rng.normal(size=(P, PAGE, HK, HD)).astype(np.float32)
    vp = rng.normal(size=(P, PAGE, HK, HD)).astype(np.float32)
    kp[~live], vp[~live] = 1e4, -1e4
    M = len(lengths)
    args = dict(q=rng.normal(size=(M, HK * REP, HD)).astype(np.float32),
                k_pool=kp, v_pool=vp, block_tables=bt,
                lengths=np.asarray(lengths, np.int32),
                k_new=rng.normal(size=(M, HK, HD)).astype(np.float32),
                v_new=rng.normal(size=(M, HK, HD)).astype(np.float32))
    if quant:
        for name in ("k", "v"):
            pool = args[f"{name}_pool"]
            amax = np.abs(pool).max(axis=(1, 3))
            sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            args[f"{name}_pool"] = np.rint(
                pool / sc[:, None, :, None]).astype(np.int8)
            args[f"{name}_scales"] = sc
    return args


def _reference64(a):
    """The one-pass computation, slot by slot in float64 numpy: the cached
    rows below the length and the current token, one softmax per head."""
    q = a["q"].astype(np.float64)
    M, H, hd = q.shape
    rep = H // a["k_new"].shape[1]
    out = np.zeros_like(q)
    for m in range(M):
        L = int(a["lengths"][m])
        pages = a["block_tables"][m, :-(-L // PAGE)]
        rows = []
        for name in ("k", "v"):
            x = a[f"{name}_pool"][pages].astype(np.float64)
            if f"{name}_scales" in a:
                x = x * a[f"{name}_scales"][pages][:, None, :, None]
            x = x.reshape(-1, *x.shape[2:])[:L]
            rows.append(np.concatenate(
                [x, a[f"{name}_new"][m][None].astype(np.float64)]))
        k, v = (np.repeat(x, rep, axis=1) for x in rows)   # (L+1, H, hd)
        s = np.einsum("hd,thd->ht", q[m], k) / np.sqrt(hd)
        p = np.exp(s - s.max(-1, keepdims=True))
        out[m] = np.einsum("ht,thd->hd", p / p.sum(-1, keepdims=True), v)
    return out


def _torch(a, dtype=None):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    if dtype is not None:
        for k in ("q", "k_new", "v_new"):
            t[k] = t[k].to(dtype)
    return t


def _two_passes(t, width):
    m, l, acc = paged_split_plain(
        t["q"], t["k_pool"], t["v_pool"], t["block_tables"], t["lengths"],
        width, t.get("k_scales"), t.get("v_scales"))
    return paged_merge_plain(t["q"], t["k_new"], t["v_new"], m, l, acc)


def _widths(a):
    """1 page, 2 pages, the plan's choice and all pages."""
    M, NP = a["block_tables"].shape
    return {"1": 1, "2": 2, "plan": split_pages(NP, PAGE, M, HK), "all": NP}


@pytest.mark.parametrize("width", ["1", "2", "plan", "all"])
@pytest.mark.parametrize("case", list(LENGTHS))
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_two_passes_compose_to_the_one_pass_version_in_float64(quant, case,
                                                                width):
    a = _problem(LENGTHS[case], quant=quant, width=48)
    got = _two_passes(_torch(a, torch.float64), _widths(a)[width]).numpy()
    np.testing.assert_allclose(got, _reference64(a), rtol=0, atol=1e-12)


@pytest.mark.parametrize("width", ["1", "2", "plan", "all"])
@pytest.mark.parametrize("case", list(LENGTHS))
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_two_passes_match_the_plain_version_and_jax(quant, case, width):
    a = _problem(LENGTHS[case], seed=1, quant=quant)
    got = _two_passes(_torch(a), _widths(a)[width]).numpy()
    plain = paged_attention_plain(**_torch(a)).numpy()
    jax_out = np.asarray(paged_attention_jnp(
        **{k: jnp.asarray(v) for k, v in a.items()}))
    for want in (plain, jax_out):
        np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32 / 10)


def test_the_float64_reference_is_the_plain_version():
    """The restatement the 1e-12 test uses agrees with the one-pass plain
    version (which computes in float32 whatever its inputs)."""
    a = _problem(SPLIT_EDGES, seed=2, quant=True, width=48)
    np.testing.assert_allclose(paged_attention_plain(**_torch(a)).numpy(),
                               _reference64(a), rtol=TOL32, atol=TOL32 / 10)


def test_empty_splits_are_empty_partials_and_merge_to_nothing():
    """A split past a slot's length has m = -inf, l = 0, acc = 0; a slot of
    length 0 gets its current token's v exactly, with no NaN."""
    a = _problem([0, 9, 0], seed=3, width=6)
    t = _torch(a, torch.float64)
    m, l, acc = paged_split_plain(t["q"], t["k_pool"], t["v_pool"],
                                  t["block_tables"], t["lengths"], 1)
    live = torch.tensor([[0] * 6, [1, 1, 0, 0, 0, 0], [0] * 6], dtype=bool)
    empty = ~live[:, None, :, None].expand_as(m)
    assert bool((m[empty] == -np.inf).all()) and bool((l[empty] == 0).all())
    assert bool((acc[empty] == 0).all())
    assert bool(torch.isfinite(m[~empty]).all()) and bool((l[~empty] >= 1).all())
    out = paged_merge_plain(t["q"], t["k_new"], t["v_new"], m, l, acc)
    assert bool(torch.isfinite(out).all())
    v0 = t["v_new"].repeat_interleave(REP, dim=1)
    assert torch.equal(out[0], v0[0]) and torch.equal(out[2], v0[2])
    # an empty partial whose acc holds garbage still adds nothing
    acc[empty] = np.nan
    assert torch.equal(paged_merge_plain(t["q"], t["k_new"], t["v_new"], m, l,
                                         acc), out)


def test_split_plan_is_a_function_of_shapes_alone():
    assert list(inspect.signature(split_pages).parameters) == [
        "NP", "page", "M", "Hk"]
    # granite-8b's decode at the smoke's lengths: 4 pages of 32 rows
    assert split_pages(65, 32, 8, 8) == 4


@pytest.mark.parametrize("NP,page,M,Hk", [
    (1, 32, 1, 1), (65, 32, 8, 8), (66, 32, 8, 16), (256, 32, 8, 8),
    (256, 32, 1, 8), (9, 32, 8, 8), (300, 16, 64, 8), (5, 1, 3, 2),
    (2049, 8, 32, 32), (7, 128, 2, 4)])
def test_split_plan_covers_every_page_once(NP, page, M, Hk):
    w = split_pages(NP, page, M, Hk)
    assert isinstance(w, int) and 1 <= w <= NP
    S = -(-NP // w)
    starts = [s * w for s in range(S)]
    assert starts[-1] < NP                      # no split starts past NP
    cover = np.zeros(NP, int)
    for s0 in starts:
        cover[s0:min(s0 + w, NP)] += 1
    assert (cover == 1).all()                   # each page in exactly one
    # a split is not tiny, and it is no wider than the target needs
    assert w == NP or w * page >= MIN_SPLIT_ROWS
    least = min(NP, -(-MIN_SPLIT_ROWS // page))
    assert w == least or M * Hk * -(-NP // (w - 1)) > TARGET_BLOCKS


@pytest.mark.parametrize("over", [0, 5], ids=["T", "T+5"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_a_length_past_the_table_follows_the_reference(quant, over):
    """At ``length >= T = NP * page`` the reference clamps the current
    token's write to row ``T - 1`` (``dynamic_update_slice``) and so
    attends cached rows ``0..T-2`` and the current token.  The plain
    version and its two passes do the same; row ``T - 1`` holds poison
    here, so reading it would show."""
    a = _problem([23, 7, 0, 15], seed=4, quant=quant)   # 3 pages: T = 24
    T = a["block_tables"].shape[1] * PAGE
    a["lengths"] = np.asarray([T + over, 7, 0, 15], np.int32)
    plain = paged_attention_plain(**_torch(a))
    jax_out = np.asarray(paged_attention_jnp(
        **{k: jnp.asarray(v) for k, v in a.items()}))
    np.testing.assert_allclose(plain.numpy(), jax_out, rtol=TOL32,
                               atol=TOL32 / 10)
    M, NP = a["block_tables"].shape
    for width in (1, split_pages(NP, PAGE, M, HK), NP):
        np.testing.assert_allclose(_two_passes(_torch(a), width).numpy(),
                                   jax_out, rtol=TOL32, atol=TOL32 / 10)
    a["lengths"][0] = T - 1
    assert torch.equal(paged_attention_plain(**_torch(a)), plain)
