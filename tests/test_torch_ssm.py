"""The port's xLSTM path against the JAX package's, on the same inputs.

* ``mlstm_scan_plain`` (what the CUDA kernel is held against on the card)
  against the sequential oracle ``ref.mlstm_chunk_ref`` at the JAX kernel
  test's fp32 shapes, a ragged S and a warm start, with that test's
  tolerance (``2e-5 * 8``) and its true-scale state comparison
  (``C·exp(m)``); and against the JAX model's own chunk scan
  (``_make_chunk_fn`` with the same W) at 2e-5.  The Pallas mLSTM kernel
  does not run on this jax (it asks for ``pltpu.TPUCompilerParams``), so
  it is no oracle here.
* The CUDA kernel's decomposition in float64: the plain scan at the
  kernel's chunk width (64, and 128) against the default width and the
  oracle, and the plain versions of its two passes
  (``mlstm_prep_plain``, ``mlstm_walk_plain``) composed against the scan.
* ``run_mlstm`` (its three forms) and ``run_slstm`` through the weight
  bridge, 2e-5; the chunked-equals-quadratic and warm-start analogues of
  the JAX package's own tests.
* Reduced xlstm-1.3b with eight layers (layer 7 is the sLSTM layer), at
  d_model 64: the init tree and the bridge, every block in place (at
  S = 300 the chunkwise form without a state), forward, prefill + greedy
  decode, decode against forward, the per-slot ``BatchEngine`` on the JAX
  engine's feed with its pages, stats and cost model, two pipeline
  shards, and the CLI.  Logits within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.simnet import Sim as JaxSim
from repro.kernels.ref import mlstm_chunk_ref
from repro.models import decoder as jdec
from repro.models import ops_for as jax_ops_for
from repro.models import ssm as jssm
from repro.serving.batch import BatchEngine as JaxBatchEngine
from repro.serving.sharded import ShardModule as JaxShardModule
from repro_torch.configs import get_config
from repro_torch.core.simnet import Sim
from repro_torch.kernels import ops
from repro_torch.kernels.mlstm_scan import (KERNEL_CHUNK, mlstm_prep_plain,
                                            mlstm_scan_plain, mlstm_walk_plain)
from repro_torch.launch import serve
from repro_torch.models import decoder, ssm
from repro_torch.params import params_from_numpy, params_to_numpy
from repro_torch.serving import (BatchEngine, ShardModule, plan_shards,
                                 split_params)

#: the JAX kernel test's fp32 tolerance, ``_tol(float32) * 8``
SCAN_TOL = 2e-5 * 8
#: the same chunk function, in another framework
CHUNK_TOL = 2e-5
LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4


# ------------------------------------------------------------ the scan

def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and on one thread each this file's small tensor ops do not contend
    (the reduced hymba's serving rehearsal took 4 s alone, 705 s beside
    five other test processes, on eight threads each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(B, H, S, hd, seed):
    """The JAX kernel test's distributions: k pre-scaled by 1/sqrt(hd),
    log f = log_sigmoid(N(0,1) + 2)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, hd))
    k = rng.normal(size=(B, H, S, hd)) / np.sqrt(hd)
    v = rng.normal(size=(B, H, S, hd))
    li = rng.normal(size=(B, H, S))
    lf = _log_sigmoid(rng.normal(size=(B, H, S)) + 2.0)
    return [a.astype(np.float32) for a in (q, k, v, li, lf)]


def _state(B, H, hd, kind, seed=0):
    """"empty": no state (m = -1e30); "cache": a serving cache's zeros
    with m = 0; "warm": 0.1·N(0,1) memory with m = 0.5."""
    if kind == "warm":
        rng = np.random.default_rng(seed)
        return [(0.1 * rng.normal(size=(B, H, hd, hd))).astype(np.float32),
                (0.1 * rng.normal(size=(B, H, hd))).astype(np.float32),
                np.full((B, H), 0.5, np.float32)]
    return [np.zeros((B, H, hd, hd), np.float32),
            np.zeros((B, H, hd), np.float32),
            np.full((B, H), -1e30 if kind == "empty" else 0.0, np.float32)]


def _plain(args):
    return [t.numpy() for t in mlstm_scan_plain(*map(torch.from_numpy, args))]


def _oracle(args):
    return [np.asarray(a) for a in mlstm_chunk_ref(*map(jnp.asarray, args))]


def _jax_chunk_scan(args):
    """The JAX model's chunkwise mLSTM (``_make_chunk_fn`` scanned over
    chunks with ``run_mlstm``'s W) on (B,H,S,hd) inputs."""
    q, k, v, li, lf, C0, n0, m0 = map(jnp.asarray, args)
    B, H, S, hd = q.shape
    W = 256 if S % 256 == 0 else S
    nC = S // W

    def chunks(a):          # (B,H,S,...) -> (nC, B, W, H, ...)
        a = jnp.moveaxis(a, 1, 2)
        return a.reshape(B, nC, W, *a.shape[2:]).swapaxes(0, 1)

    xs = {"q": chunks(q), "k": chunks(k), "v": chunks(v), "li": chunks(li),
          "lf": chunks(lf)}
    chunk = jssm._make_chunk_fn(None, W, constrain=False)
    (C, n, m), hs = jax.lax.scan(chunk, (C0, n0, m0), xs)
    h = jnp.moveaxis(hs.swapaxes(0, 1).reshape(B, S, H, hd), 2, 1)
    return [np.asarray(a) for a in (h, C, n, m)]


def _true_scale(state):
    C, n, m = state
    return C * np.exp(m)[..., None, None], n * np.exp(m)[..., None]


#: the JAX kernel test's fp32 shapes (B, H, S, hd), a ragged S (one chunk
#: of 300, as in JAX), S = 512 from the serving cache's m = 0, and warm
#: starts
SCAN_CASES = {
    "jax_1x1x128x64": (1, 1, 128, 64, "empty"),
    "jax_2x2x256x64": (2, 2, 256, 64, "empty"),
    "jax_1x2x256x128": (1, 2, 256, 128, "empty"),
    "jax_2x1x512x256": (2, 1, 512, 256, "empty"),
    "ragged_300": (1, 2, 300, 64, "empty"),
    "cache_512": (1, 2, 512, 64, "cache"),
    "warm_300": (2, 2, 300, 64, "warm"),
    "warm_512": (1, 2, 512, 64, "warm"),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_plain_matches_the_oracle(case):
    B, H, S, hd, kind = SCAN_CASES[case]
    args = _scan_inputs(B, H, S, hd, S + hd) + _state(B, H, hd, kind, S)
    got, want = _plain(args), _oracle(args)
    np.testing.assert_allclose(got[0], want[0], atol=SCAN_TOL, rtol=SCAN_TOL)
    for a, b in zip(_true_scale(got[1:]), _true_scale(want[1:])):
        np.testing.assert_allclose(a, b, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_plain_matches_the_jax_chunk_scan(case):
    """C, n and m within 2e-5 entry by entry, h within 2e-5 of its largest
    entry.  Entry by entry h is ill-conditioned where a row's denominator
    cancels: at the (2, 1, 512, 256) case both fp32 scans sit up to
    1.6e-4 from the float64 run there, so no per-entry 2e-5 holds between
    the two."""
    B, H, S, hd, kind = SCAN_CASES[case]
    args = _scan_inputs(B, H, S, hd, S + hd) + _state(B, H, hd, kind, S)
    (h, *state), (hj, *state_j) = _plain(args), _jax_chunk_scan(args)
    assert np.abs(h - hj).max() <= CHUNK_TOL * np.abs(hj).max()
    for a, b in zip(state, state_j):
        np.testing.assert_allclose(a, b, atol=CHUNK_TOL, rtol=CHUNK_TOL)


def test_scan_plain_continues_from_a_warm_state():
    """As ``test_kernels.py``'s warm-start test: the first half, then the
    second half from the carried state, gives one oracle run over the
    whole sequence (1e-4)."""
    B, H, S, hd = 1, 2, 256, 64
    seq = _scan_inputs(B, H, S, hd, 3)
    hr = _oracle(seq + _state(B, H, hd, "empty"))[0]
    first = _plain([a[:, :, :128] for a in seq] + _state(B, H, hd, "empty"))
    second = _plain([a[:, :, 128:] for a in seq] + first[1:])
    np.testing.assert_allclose(np.concatenate([first[0], second[0]], axis=2),
                               hr, atol=1e-4, rtol=1e-4)


def test_scan_plain_runs_float64_inputs_in_float64():
    """float64 inputs give float64 outputs (the reference the card's
    float32 run is held to), the same function as the oracle."""
    args = _scan_inputs(1, 2, 300, 64, 7) + _state(1, 2, 64, "cache")
    got = mlstm_scan_plain(*(torch.from_numpy(a).double() for a in args))
    assert all(t.dtype == torch.float64 for t in got)
    want = _oracle(args)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=SCAN_TOL,
                               rtol=SCAN_TOL)


#: the CUDA kernel's decomposition on the CPU, in float64: a ragged S, one
#: row, warm starts, the serving cache's start, a chunk plus one row
DECOMP_CASES = {
    "ragged_300": (1, 2, 300, 64, "empty"),
    "S1_warm": (2, 2, 1, 64, "warm"),
    "warm_512": (1, 2, 512, 64, "warm"),
    "cache_256": (2, 1, 256, 32, "cache"),
    "warm_65": (1, 2, 65, 32, "warm"),
}


def _f64(args):
    return [torch.from_numpy(a).double() for a in args]


@pytest.mark.parametrize("W", [KERNEL_CHUNK, 2 * KERNEL_CHUNK])
@pytest.mark.parametrize("case", sorted(DECOMP_CASES))
def test_scan_plain_at_the_kernels_chunk_width(case, W):
    """``chunk=W`` (the kernel's 64 rows, and 128; the last chunk ragged)
    computes run_mlstm's function: in float64 within 1e-10 of the default
    width's run (W = 256 or one chunk of S), and within the JAX kernel
    test's tolerance of the sequential oracle ``mlstm_chunk_ref``."""
    B, H, S, hd, kind = DECOMP_CASES[case]
    args = _scan_inputs(B, H, S, hd, S + hd) + _state(B, H, hd, kind, S)
    got = mlstm_scan_plain(*_f64(args), chunk=W)
    ref = mlstm_scan_plain(*_f64(args))
    assert all(t.dtype == torch.float64 for t in got)
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-10 * max(1.0, b.abs().max().item())
    want = _oracle(args)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    for a, b in zip(_true_scale([t.numpy() for t in got[1:]]),
                    _true_scale(want[1:])):
        np.testing.assert_allclose(a, b, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("case", sorted(DECOMP_CASES))
def test_prep_and_walk_compose_to_the_scan(case):
    """The kernel's two passes in plain PyTorch: what the first hands the
    second, walked, is ``mlstm_scan_plain`` at the kernel's chunk width
    (float64, 1e-12 of the largest entry), and the m chain ends at its
    m.  Rows past S hold zeros, and P is causal."""
    B, H, S, hd, kind = DECOMP_CASES[case]
    q, k, v, li, lf, C0, n0, m0 = _f64(
        _scan_inputs(B, H, S, hd, S + hd) + _state(B, H, hd, kind, S))
    prep = mlstm_prep_plain(q, k, li, lf, m0)
    h, C, n = mlstm_walk_plain(q, k, v, C0, n0, prep)
    want = mlstm_scan_plain(q, k, v, li, lf, C0, n0, m0, chunk=KERNEL_CHUNK)
    for a, b in zip((h, C, n, prep.m_T), want):
        assert a.dtype == torch.float64
        assert (a - b).abs().max().item() <= 1e-12 * max(1.0, b.abs().max().item())
    W = KERNEL_CHUNK
    nC = -(-S // W)
    assert prep.P.shape == (B, H, nC, W, W)
    assert prep.nk.shape == (B, H, nC, hd)
    assert prep.carry.shape == prep.m.shape == (B, H, nC)
    assert torch.equal(prep.m[..., 0], m0)
    assert not prep.P.triu(diagonal=1).any()
    for t in (prep.w, prep.mt, prep.rs, prep.wk):
        assert t.shape == (B, H, nC * W) and not t[..., S:].any()


# ------------------------------------------------------------ the layers

def _layer_cfgs(**kw):
    kw = dict(n_layers=1, d_model=64, vocab=256, **kw)
    return (jax_get_config("xlstm-1.3b").reduced(**kw),
            get_config("xlstm-1.3b").reduced(**kw))


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


#: (S, state): the quadratic form, the chunkwise form without a state (one
#: ragged chunk; two chunks of 256), from the serving cache and from a warm
#: state, and the S = 1 decode recurrence
MLSTM_CASES = {"quadratic_S64": (64, None), "chunked_S300": (300, None),
               "chunked_S512": (512, None), "cache_S300": (300, "cache"),
               "cache_S512": (512, "cache"), "warm_S300": (300, "warm"),
               "decode_cache": (1, "cache"), "decode_warm": (1, "warm")}


@pytest.mark.parametrize("case", sorted(MLSTM_CASES))
def test_run_mlstm_matches_jax(case):
    S, kind = MLSTM_CASES[case]
    jcfg, cfg = _layer_cfgs()
    jp = jssm.init_mlstm(jcfg, jax.random.PRNGKey(1), jnp.float32)
    x = np.random.default_rng(S).normal(size=(2, S, jcfg.d_model)
                                        ).astype(np.float32)
    H, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    state = None if kind is None else _state(2, H, hd, kind, S)
    want_y, want_st = jssm.run_mlstm(
        jp, jcfg, jnp.asarray(x),
        None if state is None else tuple(map(jnp.asarray, state)))
    ops.reset_launch_counts()
    got_y, got_st = ssm.run_mlstm(
        _bridge(jp), cfg, torch.from_numpy(x),
        None if state is None else tuple(map(torch.from_numpy, state)))
    assert not any(ops.launch_counts().values())    # the CPU: plain only
    _close(got_y, want_y)
    assert (got_st is None) == (want_st is None)
    for a, b in zip(got_st or (), want_st or ()):
        _close(a, b)


def test_run_mlstm_takes_the_scan_on_the_chunkwise_form(monkeypatch):
    """The chunkwise form goes through ``ops.mlstm_scan`` (the kernel on
    the card); the quadratic and decode forms do not."""
    _, cfg = _layer_cfgs()
    p = ssm.init_mlstm(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"), torch.float32)
    calls = []
    real = ops.mlstm_scan
    monkeypatch.setattr(ops, "mlstm_scan",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    H, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    cache = tuple(map(torch.from_numpy, _state(1, H, hd, "cache")))
    ssm.run_mlstm(p, cfg, torch.zeros((1, 64, cfg.d_model)))
    ssm.run_mlstm(p, cfg, torch.zeros((1, 1, cfg.d_model)), cache)
    assert calls == []
    ssm.run_mlstm(p, cfg, torch.zeros((1, 300, cfg.d_model)))
    ssm.run_mlstm(p, cfg, torch.zeros((1, 12, cfg.d_model)), cache)
    assert calls == [(1, H, 300, hd), (1, H, 12, hd)]


def test_mlstm_chunked_equals_quadratic():
    """As ``test_chunked.py``: the first 256 positions of a 512-token
    chunked run equal the 256-token quadratic run (2e-4)."""
    _, cfg = _layer_cfgs()
    p = ssm.init_mlstm(cfg, torch.Generator().manual_seed(3),
                       torch.device("cpu"), torch.float32)
    x_small = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 256, cfg.d_model)).astype(np.float32))
    x_big = torch.cat([x_small, x_small], dim=1)
    y_small, _ = ssm.run_mlstm(p, cfg, x_small)
    y_big, _ = ssm.run_mlstm(p, cfg, x_big)
    np.testing.assert_allclose(y_big[:, :256].numpy(), y_small.numpy(),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kind", [None, "cache", "warm"])
def test_run_slstm_matches_jax(kind):
    jcfg, cfg = _layer_cfgs()
    jp = jssm.init_slstm(jcfg, jax.random.PRNGKey(2), jnp.float32)
    x = np.random.default_rng(5).normal(size=(2, 24, jcfg.d_model)
                                        ).astype(np.float32)
    shape = (2, cfg.n_heads, cfg.d_model // cfg.n_heads)
    state = None
    if kind == "cache":                  # what init_cache holds
        state = [np.zeros(shape, np.float32) for _ in range(4)]
        state[1] += np.float32(1e-6)
    elif kind == "warm":
        rng = np.random.default_rng(6)
        state = [(0.3 * rng.normal(size=shape)).astype(np.float32)
                 for _ in range(4)]
        state[1] = np.abs(state[1]) + np.float32(1e-3)   # n > 0
    want_y, want_st = jssm.run_slstm(
        jp, jcfg, jnp.asarray(x),
        None if state is None else tuple(map(jnp.asarray, state)))
    got_y, got_st = ssm.run_slstm(
        _bridge(jp), cfg, torch.from_numpy(x),
        None if state is None else tuple(map(torch.from_numpy, state)))
    _close(got_y, want_y)
    assert (got_st is None) == (kind is None)
    for a, b in zip(got_st or (), want_st or ()):
        _close(a, b)


def test_sequence_parallel_mlstm_is_not_ported_yet():
    _, cfg = _layer_cfgs(seq_segments=2)
    p = ssm.init_mlstm(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"), torch.float32)
    with pytest.raises(NotImplementedError, match="seq_segments"):
        ssm.run_mlstm(p, cfg, torch.zeros((1, 512, cfg.d_model)))


# ------------------------------------------------------- the whole model

#: eight layers, so that layer 7 is an sLSTM layer (the two layers of
#: ``reduced()`` alone would run none)
N_LAYERS = 8


@pytest.fixture(scope="module")
def model():
    kw = dict(n_layers=N_LAYERS, d_model=64, vocab=256)
    jcfg = jax_get_config("xlstm-1.3b").reduced(**kw)
    cfg = get_config("xlstm-1.3b").reduced(**kw)
    assert jcfg.__dict__ == cfg.__dict__ and cfg.arch == "ssm"
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, "cpu"), tree


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_init_and_weight_bridge_match_the_jax_tree(model):
    """The port's init builds the JAX tree's list of per-layer dicts, each
    with an mlstm and an slstm tree (keys, shapes, dtypes), and the bridge
    carries the tree bit-exactly both ways."""
    _, _, cfg, params, tree = model
    mine = params_to_numpy(decoder.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert isinstance(mine["blocks"], list) and len(mine["blocks"]) == N_LAYERS
    assert all({"ln1", "mlstm", "slstm"} == set(b) for b in mine["blocks"])
    assert ([(p, a.shape, a.dtype) for p, a in _flat(tree)]
            == [(p, a.shape, a.dtype) for p, a in _flat(mine)])
    back = _flat(params_to_numpy(params))
    assert [p for p, _ in back] == [p for p, _ in _flat(tree)]
    for (path, a), (_, b) in zip(_flat(tree), back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


@pytest.mark.parametrize("S", [24, 300])
def test_every_block_matches_jax_in_place(model, S):
    """Each block, fed the JAX model's own input to it, gives its output:
    the sLSTM/mLSTM choice by the global layer index, and at S = 300 the
    chunkwise form without a state, at every depth (2e-5)."""
    jcfg, jparams, cfg, params, _ = model
    tokens = np.random.default_rng(S).integers(0, cfg.vocab, (2, S),
                                               dtype=np.int32)
    jx = jnp.take(jparams["embed"], jnp.asarray(tokens), axis=0)
    positions = jnp.zeros((2, S), jnp.int32)
    kinds = []
    for i in range(N_LAYERS):
        got, _, _ = decoder.run_block(cfg, params["blocks"][i],
                                      torch.from_numpy(np.array(jx)), None,
                                      layer_idx=i)
        jx, _, _ = jdec.run_block(jcfg, jparams["blocks"][i], jx, positions,
                                  layer_idx=i)
        _close(got, jx)
        kinds.append(decoder._is_slstm(cfg, i))
    assert kinds == [i == 7 for i in range(N_LAYERS)]


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params, _ = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24),
                                               dtype=np.int32)
    want, _ = jdec.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, aux = decoder.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    assert float(aux) == 0.0


def test_init_cache_matches_jax(model):
    """Every layer holds C, n, m = 0 and sc, sn = 1e-6, sh, sm, in fp32."""
    jcfg, _, cfg, _, _ = model
    want = _flat(jax.tree.map(np.asarray, jdec.init_cache(jcfg, 2, 40)["layers"]))
    got = _flat(params_to_numpy(decoder.init_cache(cfg, 2, 40,
                                                   device="cpu")["layers"]))
    assert [(p, a.shape, a.dtype) for p, a in want] == [
        (p, a.shape, a.dtype) for p, a in got]
    for (path, a), (_, b) in zip(want, got):
        assert np.array_equal(a, b), path


def test_prefill_and_greedy_decode_match_jax(model):
    """Prefill takes the chunkwise form from the cache (m = 0), then the
    decode recurrence; the port replays the JAX model's greedy tokens."""
    jcfg, jparams, cfg, params, _ = model
    B, S, steps = 2, 11, 8
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jprefill = jax.jit(lambda p, b, c: jdec.prefill(p, jcfg, b, c))
    jdecode = jax.jit(lambda p, t, c: jdec.decode_step(p, jcfg, t, c))
    jl, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)},
                          jdec.init_cache(jcfg, B, S + steps))
    cache = decoder.init_cache(cfg, B, S + steps, device="cpu")
    tl, cache = decoder.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                                cache)
    for _ in range(steps):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=0)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, dim=-1).numpy(), jt)
        jl, jcache = jdecode(jparams, jnp.asarray(jt), jcache)
        tl, cache = decoder.decode_step(params, cfg, torch.from_numpy(jt),
                                        cache)
    for a, b in zip(params_to_numpy(cache["layers"]), jcache["layers"]):
        for key in a:
            _close(a[key], b[key], LOGIT_TOL)
    assert cache["len"] == int(jcache["len"]) == S + steps


def test_decode_matches_forward(model):
    """As ``test_models.py``: prefill S - 3 tokens, then decode the next
    ones; each step's logits equal the forward pass's at that position,
    the JAX model's and the port's own (1e-4)."""
    jcfg, jparams, cfg, params, _ = model
    B, S = 2, 32
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jlogits, _ = jdec.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logits, _ = decoder.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    cache = decoder.init_cache(cfg, B, S, device="cpu")
    _, cache = decoder.prefill(
        params, cfg, {"tokens": torch.from_numpy(tokens[:, :S - 3])}, cache)
    for t in range(S - 3, S - 1):
        step, cache = decoder.decode_step(
            params, cfg, torch.from_numpy(tokens[:, t]), cache)
        for want in (np.asarray(jlogits[:, t]), logits[:, t].numpy()):
            np.testing.assert_allclose(step.numpy(), want, atol=LOGIT_TOL,
                                       rtol=0)


def _drive(eng, sim, prompts, steps, feed=None):
    """Open every session, decode greedily (or replay ``feed``), close.
    Returns the prefill logits, every step's logits, the feed, the summed
    simulated cost and the cache bytes before closing."""
    sessions = [f"s{i}" for i in range(len(prompts))]
    first, cost = [], 0.0
    for sid, p in zip(sessions, prompts):
        out, c = sim.run_process(eng.open(sid, p, p.shape[1] + steps + 1))
        first.append(np.asarray(out)[0])
        cost += c
    toks = np.asarray([int(np.argmax(r)) for r in first], np.int32)
    logits, fed = [], []
    for t in range(steps):
        x = feed[t] if feed is not None else toks
        fed.append(x)
        out, served, c = eng.step(sessions, x)
        assert served == sessions
        cost += c
        logits.append(np.asarray(out))
        toks = np.argmax(out, axis=-1).astype(np.int32)
    kv = eng.kv_bytes()
    eng.close(sessions)
    assert eng.stats["pages"] == 0
    return np.stack(first), logits, fed, cost, kv


def test_batch_engine_matches_jax_on_a_replayed_feed(model):
    """Both engines serve ssm on the per-slot path: the same prefill and
    step logits on the JAX engine's own greedy feed, the same stats and
    pages, cache bytes and simulated costs.  Decoding past a page grows
    the slots."""
    jcfg, jparams, cfg, params, _ = model
    prompts = [np.random.default_rng(40 + n).integers(0, cfg.vocab, (1, n),
                                                      dtype=np.int32)
               for n in (5, 11, 17)]
    jsim = JaxSim(seed=4)
    jeng = JaxBatchEngine(JaxShardModule(jcfg, jparams, (0, N_LAYERS),
                                         True, True), jsim, n_slots=4,
                          page_size=8)
    assert not jeng.fused
    j_first, j_logits, feed, j_cost, j_kv = _drive(jeng, jsim, prompts, 6)
    sim = Sim(seed=4)
    eng = BatchEngine(ShardModule(cfg, params, (0, N_LAYERS), True, True),
                      sim, n_slots=4, page_size=8, fused=True, device="cpu")
    assert not eng.fused                      # ssm never takes the fused path
    ops.reset_launch_counts()
    first, logits, _, cost, kv = _drive(eng, sim, prompts, 6, feed)
    assert not any(ops.launch_counts().values())      # plain versions only
    np.testing.assert_allclose(first, j_first, atol=LOGIT_TOL, rtol=0)
    for a, b in zip(logits, j_logits):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(np.argmax(a, -1), np.argmax(b, -1))
    assert eng.stats == jeng.stats and eng.stats["pages_peak"] > 3
    assert kv == j_kv and cost == pytest.approx(j_cost, rel=1e-12)
    assert (eng.module.weight_bytes() == jeng.module.weight_bytes()
            and eng.module.flops(7) == jeng.module.flops(7))


def test_growing_a_slot_keeps_its_recurrent_state(model, monkeypatch):
    """Growth past a page keeps every state tensor as it is, allocates no
    fresh cache, and counts the new page."""
    _, _, cfg, params, _ = model
    sim = Sim(seed=9)
    module = ShardModule(cfg, params, (0, N_LAYERS), True, True)
    eng = BatchEngine(module, sim, n_slots=1, page_size=8, device="cpu")
    sim.run_process(eng.open("S", np.zeros((1, 7), np.int32), 16))
    st = eng.by_session["S"]
    eng.step(["S"], np.zeros((1,), np.int32))         # the 8th token
    assert st.capacity == 8 and eng.stats["pages"] == 1

    def no_fresh_cache(*a, **k):
        raise AssertionError("growth allocated a fresh cache")

    monkeypatch.setattr(module, "init_cache", no_fresh_cache)
    before = [t for layer in st.cache["layers"] for t in layer.values()]
    eng._ensure_capacity(st, 9)
    after = [t for layer in st.cache["layers"] for t in layer.values()]
    assert st.capacity == 16 and eng.stats["pages"] == 2
    assert len(after) == len(before) == 7 * N_LAYERS
    assert all(a is b for a, b in zip(after, before))
    eng.step(["S"], np.zeros((1,), np.int32))         # the 9th, grown slot
    assert st.cache["len"] == 9
    eng.close(["S"])
    assert eng.stats["pages"] == 0


def test_two_shards_keep_the_global_layer_index(model):
    """Layers 0-3 and 4-7 on two shards give the whole model's logits:
    shard 1's block 3 is global layer 7, the sLSTM layer."""
    _, _, cfg, params, _ = model
    prompt = np.random.default_rng(50).integers(0, cfg.vocab, (1, 9),
                                                dtype=np.int32)
    sim = Sim(seed=5)
    whole = BatchEngine(ShardModule(cfg, params, (0, N_LAYERS), True, True),
                        sim, n_slots=1, page_size=8, device="cpu")
    first, logits, feed, _, _ = _drive(whole, sim, [prompt], 3)
    plan = plan_shards(cfg, 2)
    assert plan == [(0, 4), (4, 8)]
    subs = split_params(cfg, params, plan)
    assert [len(s["blocks"]) for s in subs] == [4, 4]
    assert subs[1]["blocks"][3] is params["blocks"][7]
    mods = [ShardModule(cfg, sp, rng, i == 0, i == 1)
            for i, (sp, rng) in enumerate(zip(subs, plan))]
    assert sum(m.weight_bytes() for m in mods) == ShardModule(
        cfg, params, (0, N_LAYERS), True, True).weight_bytes()
    shards = [BatchEngine(m, sim, n_slots=1, page_size=8, device="cpu")
              for m in mods]
    h, _ = sim.run_process(shards[0].open("S", prompt, 16))
    out, _ = sim.run_process(shards[1].open("S", h, 16))
    np.testing.assert_allclose(out[0], first[0], atol=1e-6, rtol=0)
    for t in range(3):
        h, _, _ = shards[0].step(["S"], feed[t])
        out, _, _ = shards[1].step(["S"], h)
        np.testing.assert_allclose(out, logits[t], atol=1e-6, rtol=0)


def test_cli_serves_xlstm_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=xlstm-1.3b" in out and "6 tokens" in out
