"""The port's hybrid arch (hymba) against the JAX package's, on the CPU.

Mamba (``run_mamba`` in its three forms, ``mamba_scan``), the windowed
ring-buffer KV cache of ``run_attention`` (below, at and past the
window, the wrap in decode, and the reference's hazard of a block of
``window <= S < FLASH_MIN_SEQ`` tokens), the reduced hymba's forward,
prefill and greedy decode, ``BatchEngine`` per slot with its cache grown
past the window, ``launch.serve``, and the smoke's ``hybrid_parity`` and
``serving_hybrid`` phases rehearsed on the CPU.  Inputs come from numpy
seeds; JAX weights cross over through ``params_from_numpy``.
Tolerances: 2e-4 (atol and rtol) for Mamba, the JAX package's own
(``tests/test_chunked.py``), and 1e-4 on logits, as
``tests/test_torch_serving.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.core.simnet import Sim as JaxSim
from repro.models import common as jcommon
from repro.models import decoder as jdec
from repro.models import ops_for as jax_ops_for
from repro.models import ssm as jssm
from repro.serving.batch import BatchEngine as JaxBatchEngine
from repro.serving.sharded import ShardModule as JaxShardModule
from repro_torch.configs import get_config
from repro_torch.core.simnet import Sim
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import common, decoder, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.params import params_from_numpy, params_to_numpy
from repro_torch.serving import BatchEngine, ShardModule

MAMBA_TOL = 2e-4
LOGIT_TOL = 1e-4


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


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ Mamba

#: the JAX package's Mamba test config (``tests/test_chunked.py``)
MAMBA_KW = dict(name="t", arch="hybrid", n_layers=1, d_model=64, n_heads=2,
                n_kv_heads=2, d_ff=128, vocab=128, ssm_state=8, d_inner=128)


@pytest.fixture(scope="module")
def mamba():
    from repro.models.config import ModelConfig as JaxModelConfig
    jcfg, cfg = JaxModelConfig(**MAMBA_KW), ModelConfig(**MAMBA_KW)
    jp = jssm.init_mamba(jcfg, jax.random.PRNGKey(2), jnp.float32)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _state(seed, B, cfg, zero=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, cfg.d_in, cfg.ssm_state)).astype(np.float32)
    conv = rng.standard_normal((B, ssm.CONV_K - 1, cfg.d_in)).astype(np.float32)
    if zero:
        h, conv = np.zeros_like(h), np.zeros_like(conv)
    return h, conv


def _close(got, want, tol=MAMBA_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


#: (S, state): the chunkwise form (S % 128 == 0, 4 chunks), one chunk of
#: W = S (300), each from no state and from a warm one
@pytest.mark.parametrize("S", [512, 300], ids=["chunked", "single_chunk"])
@pytest.mark.parametrize("with_state", [False, True], ids=["none", "warm"])
def test_run_mamba_matches_jax(mamba, S, with_state):
    jcfg, jp, cfg, p = mamba
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)
                                                 ).astype(np.float32)
    st = _state(S + 1, 2, cfg) if with_state else None
    want, jst = jssm.run_mamba(jp, jcfg, jnp.asarray(x),
                               None if st is None else tuple(map(jnp.asarray,
                                                                 st)))
    got, pst = ssm.run_mamba(p, cfg, _t(x),
                             None if st is None else tuple(map(_t, st)))
    _close(got, want)
    assert (pst is None) == (jst is None)
    if with_state:
        for a, b in zip(pst, jst):
            _close(a, b)


def test_mamba_decode_steps_match_jax(mamba):
    """The O(1) step, eight times from a warm state, state and outputs
    against JAX's."""
    jcfg, jp, cfg, p = mamba
    x = np.random.default_rng(7).standard_normal((2, 8, cfg.d_model)
                                                 ).astype(np.float32)
    jst = tuple(map(jnp.asarray, _state(8, 2, cfg)))
    pst = tuple(map(_t, _state(8, 2, cfg)))
    for t in range(8):
        want, jst = jssm.run_mamba(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        got, pst = ssm.run_mamba(p, cfg, _t(x[:, t:t + 1]), pst)
        _close(got, want)
        for a, b in zip(pst, jst):
            _close(a, b)


def test_chunked_prefill_then_steps_equals_one_pass(mamba):
    """As the JAX package's test: 512 tokens in one call (4 chunks) equal
    four calls of 128 that carry the state; and prefill + steps equal the
    one pass over the whole sequence."""
    _, _, cfg, p = mamba
    x = _t(np.random.default_rng(3).standard_normal((2, 516, cfg.d_model)
                                                    ).astype(np.float32))
    whole, _ = ssm.run_mamba(p, cfg, x[:, :512])
    st = tuple(map(_t, _state(0, 2, cfg, zero=True)))
    parts = []
    for i in range(0, 512, 128):
        y, st = ssm.run_mamba(p, cfg, x[:, i:i + 128], st)
        parts.append(y)
    _close(torch.cat(parts, 1), whole.numpy())
    ref, _ = ssm.run_mamba(p, cfg, x)               # one chunk of 516
    for t in range(512, 516):
        y, st = ssm.run_mamba(p, cfg, x[:, t:t + 1], st)
        _close(y[:, 0], ref[:, t].numpy())


@pytest.mark.parametrize("W", [1, 2, 5, 128, 300])
def test_mamba_scan_is_the_recurrence(W):
    """The doubling scan against the token loop, in float64."""
    rng = np.random.default_rng(W)
    dA = _t(rng.uniform(0.5, 1.0, (2, W, 3, 4)))
    dBu = _t(rng.standard_normal((2, W, 3, 4)))
    h0 = _t(rng.standard_normal((2, 3, 4)))
    got = ssm.mamba_scan(dA, dBu, h0)
    h, want = h0, []
    for t in range(W):
        h = dA[:, t] * h + dBu[:, t]
        want.append(h)
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_mamba_runs_float64_in_float64(mamba):
    _, _, cfg, p = mamba
    p64 = {k: v.double() for k, v in p.items()}
    x = torch.randn((1, 130, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0), dtype=torch.float64)
    y, st = ssm.run_mamba(p64, cfg, x, tuple(
        t.double() for t in map(_t, _state(1, 1, cfg))))
    assert y.dtype == st[0].dtype == st[1].dtype == torch.float64
    y32, _ = ssm.run_mamba(p, cfg, x.float())
    y64, _ = ssm.run_mamba(p64, cfg, x)
    _close(y32, y64.numpy())


# ----------------------------------------------------------- the ring cache

RING_KW = dict(n_layers=2, d_model=64, vocab=256)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("hymba-1.5b").reduced(**RING_KW)
    cfg = get_config("hymba-1.5b").reduced(**RING_KW)
    assert jcfg.__dict__ == cfg.__dict__ and cfg.window == 64
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, "cpu"), tree


def _attn_inputs(cfg, S, seed):
    x = np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)
                                                    ).astype(np.float32)
    return x


def _ring_case(model, S, cache_len):
    """Both packages' ``run_attention`` of one layer, S tokens at
    ``cache_len`` against a ring (T = window) holding ``cache_len``
    tokens written by an earlier call of each package."""
    jcfg, jparams, cfg, params, _ = model
    T = cfg.window
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    p = decoder.layer_params(params["blocks"], 0)["attn"]
    shape = (2, T, cfg.n_kv_heads, cfg.hd)
    jkv = (jnp.zeros(shape), jnp.zeros(shape))
    kv = (torch.zeros(shape), torch.zeros(shape))
    if cache_len:
        x0 = _attn_inputs(cfg, cache_len, 1)
        pos0 = np.broadcast_to(np.arange(cache_len, dtype=np.int32),
                               (2, cache_len))
        _, jkv = jcommon.run_attention(jp, jcfg, jnp.asarray(x0),
                                       jnp.asarray(pos0), jkv,
                                       jnp.int32(0))
        _, kv = common.run_attention(p, cfg, _t(x0), _t(pos0), kv, 0)
    x = _attn_inputs(cfg, S, 2)
    pos = np.broadcast_to(np.arange(cache_len, cache_len + S,
                                    dtype=np.int32), (2, S))
    want, jkv = jcommon.run_attention(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(pos), jkv,
                                      jnp.int32(cache_len))
    got, kv = common.run_attention(p, cfg, _t(x), _t(pos), kv, cache_len)
    return (got, kv), (want, jkv), (jp, p, x, pos)


#: (S, cache_len): below the window, from empty and wrapping; the window
#: exactly; past it below FLASH_MIN_SEQ (the masked branch over the ring)
RING_CASES = {"below": (40, 0), "below_wrapping": (40, 50),
              "at_window": (64, 0), "past_window": (100, 0),
              "past_window_warm": (100, 30)}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_jax(model, case):
    S, cache_len = RING_CASES[case]
    (got, kv), (want, jkv), _ = _ring_case(model, S, cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    for a, b in zip(kv, jkv):            # slot for slot, the ring the same
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_ring_prefill_past_the_window_keeps_the_reference_hazard(model):
    """A block of window <= S < FLASH_MIN_SEQ tokens attends over the ring
    alone: both packages agree, and both differ from the windowed forward
    at every position but the last, where the ring holds exactly that
    query's window."""
    jcfg, _, cfg, _, _ = model
    (got, _), (want, _), (jp, p, x, pos) = _ring_case(model, 100, 0)
    fwd_j, _ = jcommon.run_attention(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos))
    fwd, _ = common.run_attention(p, cfg, _t(x), _t(pos))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(fwd_j),
                               atol=LOGIT_TOL, rtol=0)
    diff = (got - fwd).abs().amax(dim=(0, 2)).numpy()       # per position
    jdiff = np.abs(np.asarray(want) - np.asarray(fwd_j)).max(axis=(0, 2))
    assert diff[-1] < LOGIT_TOL and jdiff[-1] < LOGIT_TOL
    assert (diff[:-1] > 1e-3).all() and (jdiff[:-1] > 1e-3).all()


def test_ring_prefill_from_flash_min_seq_takes_the_flash_branch(model,
                                                                monkeypatch):
    """A block of FLASH_MIN_SEQ tokens or more streams the block itself
    under the window, and the ring keeps its last ``window`` tokens."""
    calls = []
    real = ops.flash_attention

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", spy)
    (got, kv), (want, jkv), _ = _ring_case(model, common.FLASH_MIN_SEQ, 0)
    assert calls == [{"causal": True, "window": 64}]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    for a, b in zip(kv, jkv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_ring_pos_matches_jax():
    for T in (1, 7, 64):
        slots = np.arange(T)
        for length in range(0, 3 * T + 2):
            want = np.asarray(jcommon._ring_pos(jnp.asarray(slots), length, T))
            got = common._ring_pos(torch.arange(T), length, T).numpy()
            np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- the model

def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_weight_bridge_match_the_jax_tree(model, dtype):
    """The port's init builds the JAX tree (keys, shapes, dtypes: A_log and
    D_skip stay fp32 in a bf16 tree), and the bridge carries it
    bit-exactly both ways."""
    jcfg, _, cfg, _, _ = model
    jtree = jax.tree.map(np.asarray, jax_ops_for(jcfg).init(
        jcfg, jax.random.PRNGKey(1), getattr(jnp, dtype)))
    mine = params_to_numpy(decoder.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu", getattr(torch, dtype)))
    assert ([(p, a.shape, a.dtype) for p, a in _flat(jtree)]
            == [(p, a.shape, a.dtype) for p, a in _flat(mine)])
    assert mine["blocks"]["mamba"]["A_log"].dtype == np.float32
    assert mine["blocks"]["mamba"]["D_skip"].dtype == np.float32
    back = _flat(params_to_numpy(params_from_numpy(jtree, "cpu")))
    for (path, a), (_, b) in zip(_flat(jtree), back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params, _ = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 300),
                                               dtype=np.int32)
    want, _ = jdec.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, aux = decoder.forward(params, cfg, {"tokens": _t(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    assert float(aux) == 0.0


def test_init_cache_matches_jax(model):
    """A ring of min(max_len, window) slots, h (L,B,d_in,N) fp32 and conv
    (L,B,3,d_in), all zero."""
    jcfg, _, cfg, _, _ = model
    for max_len in (40, 64, 500):
        want = _flat(jax.tree.map(np.asarray,
                                  jdec.init_cache(jcfg, 2, max_len)["layers"]))
        got = _flat(params_to_numpy(decoder.init_cache(
            cfg, 2, max_len, device="cpu")["layers"]))
        assert [(p, a.shape, a.dtype) for p, a in want] == [
            (p, a.shape, a.dtype) for p, a in got]
        assert not any(a.any() for _, a in got)


@pytest.mark.parametrize("S", [11, 64, 100, 256])
def test_prefill_and_greedy_decode_match_jax(model, S):
    """Prefill below, at and past the window (the masked ring branch), then
    greedy decode across the ring's wrap; the port replays the JAX model's
    tokens, and the caches (k, v, h, conv) agree."""
    jcfg, jparams, cfg, params, _ = model
    B, steps = 2, 70
    tokens = np.random.default_rng(S).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jdecode = jax.jit(lambda p, t, c: jdec.decode_step(p, jcfg, t, c))
    jl, jcache = jax.jit(lambda p, b, c: jdec.prefill(p, jcfg, b, c))(
        jparams, {"tokens": jnp.asarray(tokens)},
        jdec.init_cache(jcfg, B, S + steps))
    cache = decoder.init_cache(cfg, B, S + steps, device="cpu")
    tl, cache = decoder.prefill(params, cfg, {"tokens": _t(tokens)}, cache)
    for _ in range(steps):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=0)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), jt)
        jl, jcache = jdecode(jparams, jnp.asarray(jt), jcache)
        tl, cache = decoder.decode_step(params, cfg, _t(jt), cache)
    assert cache["len"] == int(jcache["len"]) == S + steps
    for key, a in params_to_numpy(cache["layers"]).items():
        np.testing.assert_allclose(a, np.asarray(jcache["layers"][key]),
                                   atol=MAMBA_TOL, rtol=MAMBA_TOL)


def test_decode_across_the_wrap_matches_forward(model):
    """Prefill 50 tokens (below the window of 64), then decode 40 more,
    the ring wrapping at 64: each step's logits equal the windowed
    forward's at that position, the JAX model's and the port's own."""
    jcfg, jparams, cfg, params, _ = model
    B, S, P = 2, 90, 50
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jlogits, _ = jdec.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logits, _ = decoder.forward(params, cfg, {"tokens": _t(tokens)})
    cache = decoder.init_cache(cfg, B, S, device="cpu")
    assert cache["layers"]["k"].shape[2] == cfg.window
    _, cache = decoder.prefill(params, cfg, {"tokens": _t(tokens[:, :P])},
                               cache)
    for t in range(P, S - 1):
        step, cache = decoder.decode_step(params, cfg, _t(tokens[:, t]),
                                          cache)
        for want in (np.asarray(jlogits[:, t]), logits[:, t].numpy()):
            np.testing.assert_allclose(step.numpy(), want, atol=LOGIT_TOL,
                                       rtol=0)


def test_training_still_refuses_hybrid(model):
    """Kept under its first name: hybrid and xLSTM training are ported
    (``tests/test_torch_hybrid_train.py``,
    ``tests/test_torch_xlstm_train.py``), so ``make_train_step`` takes the
    reduced hymba and the reduced xLSTM."""
    from repro_torch.optim import constant_schedule
    from repro_torch.train.step import make_train_step
    for cfg in (model[2], get_config("xlstm-1.3b").reduced()):
        assert callable(make_train_step(cfg, constant_schedule(1e-3)))


# ------------------------------------------------------------- the engine

def _drive(eng, sim, prompts, steps, feed=None):
    """Open every session, decode greedily (or replay ``feed``), close.
    Returns the prefill logits, every step's logits, the feed, the summed
    simulated cost and each step's cache bytes."""
    sessions = [f"s{i}" for i in range(len(prompts))]
    first, cost = [], 0.0
    for sid, p in zip(sessions, prompts):
        out, c = sim.run_process(eng.open(sid, p, p.shape[1] + steps + 1))
        first.append(np.asarray(out)[0])
        cost += c
    toks = np.asarray([int(np.argmax(r)) for r in first], np.int32)
    logits, fed, kv = [], [], []
    for t in range(steps):
        x = feed[t] if feed is not None else toks
        fed.append(x)
        out, served, c = eng.step(sessions, x)
        assert served == sessions
        cost += c
        logits.append(np.asarray(out))
        kv.append(eng.kv_bytes())
        toks = np.argmax(out, axis=-1).astype(np.int32)
    eng.close(sessions)
    assert eng.stats["pages"] == 0
    return np.stack(first), logits, fed, cost, kv


#: the smoke's Y1 prompts with FLASH_MIN_SEQ cut to 128 in both packages:
#: 128 and 150 take the flash branch as 2048 and 2100 do on the card
ENGINE_PROMPTS = (128, 150, 12, 37, 64, 100, 200, 300)


def test_batch_engine_matches_jax_per_slot(model, monkeypatch):
    """Both engines serve hymba per slot: the same prefill and step logits
    on the JAX engine's greedy feed, the same stats, pages, cache bytes
    and simulated costs.  Page 32 against a window of 64: the 12-token
    session grows from 32 slots into the ring and past it."""
    monkeypatch.setattr(jcommon, "FLASH_MIN_SEQ", 128)
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)
    jcfg, jparams, cfg, params, _ = model
    prompts = [np.random.default_rng(60 + n).integers(0, cfg.vocab, (1, n),
                                                      dtype=np.int32)
               for n in ENGINE_PROMPTS]
    jsim = JaxSim(seed=4)
    jeng = JaxBatchEngine(JaxShardModule(jcfg, jparams, (0, cfg.n_layers),
                                         True, True), jsim, n_slots=8,
                          page_size=32)
    assert not jeng.fused
    j_first, j_logits, feed, j_cost, j_kv = _drive(jeng, jsim, prompts, 32)
    sim = Sim(seed=4)
    eng = BatchEngine(ShardModule(cfg, params, (0, cfg.n_layers), True, True),
                      sim, n_slots=8, page_size=32, device="cpu")
    assert not eng.fused
    ops.reset_launch_counts()
    first, logits, _, cost, kv = _drive(eng, sim, prompts, 32, feed)
    assert not any(ops.launch_counts().values())
    np.testing.assert_allclose(first, j_first, atol=LOGIT_TOL, rtol=0)
    for a, b in zip(logits, j_logits):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(np.argmax(a, -1), np.argmax(b, -1))
    assert eng.stats == jeng.stats
    assert kv == j_kv and cost == pytest.approx(j_cost, rel=1e-12)


def test_growth_stops_kv_at_the_window_and_keeps_the_mamba_state(model):
    """Past the window a grown slot keeps its k, v, h and conv tensors (the
    same objects) and only counts the new pages; below it, k/v grow into
    a ring with the old slots at its front and h, conv kept."""
    _, _, cfg, params, _ = model
    sim = Sim(seed=9)
    eng = BatchEngine(ShardModule(cfg, params, (0, cfg.n_layers), True, True),
                      sim, n_slots=1, page_size=32, device="cpu")
    sim.run_process(eng.open("S", np.ones((1, 20), np.int32), 200))
    st = eng.by_session["S"]
    assert st.capacity == 32 and st.cache["layers"]["k"].shape[2] == 32
    before = dict(st.cache["layers"])
    eng._ensure_capacity(st, 33)                   # into the ring of 64
    layers = st.cache["layers"]
    assert st.capacity == 64 and layers["k"].shape[2] == cfg.window
    assert layers["h"] is before["h"] and layers["conv"] is before["conv"]
    assert torch.equal(layers["k"][:, :, :32], before["k"])
    assert not layers["k"][:, :, 32:].any()
    before = dict(layers)
    eng._ensure_capacity(st, 65)                   # past it: nothing grows
    assert st.capacity == 96 and eng.stats["pages"] == 3
    assert all(st.cache["layers"][k] is t for k, t in before.items())
    eng.close(["S"])
    assert eng.stats["pages"] == 0


def test_generation_engine_greedy_matches_jax(model):
    from repro.serving.engine import GenerationEngine as JaxGenerationEngine
    from repro_torch.serving import GenerationEngine
    jcfg, jparams, cfg, params, _ = model
    batch = {"tokens": np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 40), dtype=np.int32)}
    want, _ = JaxGenerationEngine(jcfg, jparams, max_len=80).generate(
        {"tokens": jnp.asarray(batch["tokens"])}, 30)
    got, _ = GenerationEngine(cfg, params, max_len=80,
                              device="cpu").generate(batch, 30)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cli_serves_hymba_on_the_cpu_when_asked(capsys):
    out = serve.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "70", "--gen", "3"])
    assert out.shape == (2, 3)
    text = capsys.readouterr().out
    assert "arch=hymba-1.5b" in text and "6 tokens" in text


# -------------------------------------------------- the smoke's new phases

def test_hybrid_parity_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.hybrid_parity_phase`` (gate Y1) end to end on the CPU,
    FLASH_MIN_SEQ cut to 128 so that its two long prompts take the flash
    branch: the gate holds and no run launches a kernel.  The 100-token
    prompt sets the limit: its first 36 queries see no key in the ring,
    and fp32 rounds each of their scores to exactly -1e9, so they average
    the ring, while float64 keeps the logits under the mask; the Mamba
    branch carries those rows into the last position's logits."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)
    line = chip_smoke.hybrid_parity_phase(torch, "cpu",
                                          prompts=ENGINE_PROMPTS)
    assert lines == [line]
    err = line["max_abs_logit_err"]
    assert err["card32_vs_cpu64"] <= line["y1_limit"]
    assert not any(line["launches_card32"].values())
    per_call = line["cpu32_vs_cpu64_per_call"]
    clean = [per_call[ENGINE_PROMPTS.index(n)] for n in (128, 150, 12, 37, 64)]
    assert per_call[ENGINE_PROMPTS.index(100)] > 1e-3 > 1e-5 > max(clean)


def test_prefill_then_a_step_is_the_longer_prefill_in_float64(
        monkeypatch):
    """Gate Y3's two routes are the same arithmetic: in float64,
    prefill(S - 1) + one decode step gives prefill(S)'s logits to 1e-12
    (S = 129: one Mamba chunk of 129 against one of 128 and a step, both
    through the flash branch).  In fp32 the same routes differ by
    rounding, 0.47 to 1.10 of what one ulp of the embeddings moves the
    logits at reduced widths on a CPU (0.655 at full width on an H100),
    which is why the smoke's rehearsal below runs at Y1's width."""
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)
    cfg = get_config("hymba-1.5b").reduced(n_layers=2, d_model=64,
                                           vocab=256)
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                 torch.float64)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 129), dtype=np.int32))

    def prefill(toks):
        cache = decoder.init_cache(cfg, 1, 130, torch.float64, device="cpu")
        return decoder.prefill(params, cfg, {"tokens": toks}, cache)

    whole, _ = prefill(tokens)
    _, cache = prefill(tokens[:, :128])
    step, cache = decoder.decode_step(params, cfg, tokens[:, 128], cache)
    assert step.dtype == torch.float64 and cache["len"] == 129
    torch.testing.assert_close(step, whole, rtol=0, atol=1e-12)


def test_serving_hybrid_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.serving_hybrid_phase`` (gates Y2 and Y3) end to end on
    the CPU at Y1's reduced hymba (L=4, d=256, window 64) with
    FLASH_MIN_SEQ cut to 128: prompts past, at and a token short of the
    window, the launcher, the handoff at 129 tokens (one Mamba chunk of
    129 against one of 128 and a step)."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)
    cfg = get_config("hymba-1.5b").reduced(**chip_smoke.HYBRID_REDUCED)
    chip_smoke.serving_hybrid_phase(torch, "cpu", cfg,
                                    [129, 150, 64, 63, 12, 37, 100, 20])
    by = {ln["phase"]: ln for ln in lines}
    serving = by["serving_hybrid"]
    assert serving["pages_after_close"] == 0
    assert serving["cache_bytes_per_session"] == [
        serving["cache_bytes_at_window"]] * 8
    assert max(by["hybrid_handoff_by_layer"]["state_rel"].values()) <= 1e-4
    hand = by["hybrid_handoff"]
    assert hand["S"] == 129 and (hand["handoff_max_abs_logit_diff"]
                                 <= hand["one_ulp_embedding_max_abs_logit_change"])
    assert "seconds" in by["serving_hybrid_done"]
